"""The pieces are found by name, a piece added as a file is found without
an edit, and ``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.benchmark()


def test_every_cell_config_job_and_metric_has_its_file():
    for w in BENCH["workloads"]:
        cell = registry.cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["why"] and cell["limits"]
        kind = registry.job(cell["job"])
        for fn in ("set_up", "job", "judge", "control"):
            assert callable(getattr(kind, fn))
        assert kind.OUTPUTS
        assert registry.config(w["config"])["name"] == w["config"]
        traffic = registry.traffic(w["traffic"])
        assert traffic["why"] and traffic["corpus"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(registry.ROOT, c["file"]))
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
    assert configs == {w["config"] for w in BENCH["workloads"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert any(cell in e.get("workloads", cells)
                       for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in cells:
        assert len(registry.cell_metrics(BENCH, cell, "end_to_end")) >= 2
        assert registry.cell_metrics(BENCH, cell, "per_layer")


def test_an_added_cell_and_metric_are_found_without_an_edit(tmp_path,
                                                            monkeypatch):
    for folder in ("cells", "configs", "traffic", "metrics", "jobs"):
        shutil.copytree(os.path.join(registry.HERE, folder),
                        tmp_path / folder)
    cell = dict(registry.cell("flagship.wiki"), traffic="wiki-short")
    (tmp_path / "cells" / "flagship.short.json").write_text(json.dumps(cell))
    (tmp_path / "traffic" / "wiki-short.json").write_text(json.dumps(
        dict(registry.traffic("wiki"), max_lines=100)))
    (tmp_path / "metrics" / "jobs.count.py").write_text(
        "def read(run):\n    return float(len(run['jobs']))\n")
    monkeypatch.setattr(registry, "HERE", str(tmp_path))
    assert "flagship.short" in registry.names("cells", ".json")
    assert registry.cell("flagship.short")["traffic"] == "wiki-short"
    assert "wiki-short" in registry.names("traffic", ".json")
    assert registry.traffic("wiki-short")["max_lines"] == 100
    assert registry.metric("jobs.count").read({"jobs": [1, 2]}) == 2.0
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "jobs.count", "unit": "jobs", "better": "higher",
         "source": "host_clock", "layer": "x", "moves": "merges_per_s",
         "workloads": ["flagship.short"]}])
    assert [m["name"] for m in registry.cell_metrics(
        bench, "flagship.short", "per_layer")] == ["jobs.count"]


@pytest.mark.parametrize("name", registry.names("configs", ".json"))
def test_configs_state_their_cut(name):
    cfg = registry.config(name)
    assert cfg["reduced"] == []
    assert cfg["source"].startswith("https://") and len(cfg["source"]) <= 200
    listed = [c for c in BENCH["configs"] if c["name"] == name]
    assert all(c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
               for c in listed)
    assert cfg["precision"].startswith("float32")
