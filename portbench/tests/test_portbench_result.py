"""The result line: its keys, their order and types, on small runs on the
CPU; and no result without a card or outside a checkout."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import registry, run
from portbench.tests.conftest import SMALL_FLAGSHIP, SMALL_PRETRAIN

# quickstart.pretrain is a cell of the benchmark's files that BENCHMARK.json
# does not list (PERF.md): it reports set-up alone when run.
CASES = [("flagship.wiki", SMALL_FLAGSHIP),
         ("quickstart.pretrain", SMALL_PRETRAIN)]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell,small", CASES)
def test_the_result_line(cell, small, trace):
    r = run.run_cell(cell, 2**31 + 12345, 0.2, trace, "cpu", small)
    assert r.pop("errors") == [] and r.pop("jobs")
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared" and (trace or "breakdown" not in r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    json.dumps(r, allow_nan=False)
    bench = registry.benchmark()
    allowed = {m["name"]: m["unit"] for m in registry.cell_metrics(
        bench, cell, "per_layer" if trace else "end_to_end")}
    assert set(r["metrics"]) <= set(allowed)
    for name, m in r["metrics"].items():
        assert m["unit"] == allowed[name] and isinstance(m["value"], float)
    if not trace:
        assert set(r["metrics"]) == set(allowed)
    else:
        assert r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(r["compared"]) == set(registry.cell(cell)["limits"])
    for v in r["compared"].values():
        assert v["value"] <= v["limit"]


def test_no_result_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "flagship.wiki", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "flagship.wiki",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
