"""The port's bench (``hyptokenizer_tpu_torch/bench.py``) on the CPU.

Each path runs at a tiny size on ``device="cpu"`` (the kernels' plain
versions) and the first-line JSON carries every field the bench promises;
a read of the root ``bench.py``'s syntax tree checks that the port's three
workloads pass the same constructor, training and loop arguments; a path
that raises, or a selfcheck verdict other than "pass", ends ``main`` with
a failure, and without a card the bench does not start.
"""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from hyptokenizer_tpu_torch import bench
from hyptokenizer_tpu_torch.evals import selfcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(steps=48, max_vocab_size=256, log_every=16)

HEADLINE = ("metric", "value", "unit", "vs_baseline", "first_chunk_s",
            "corpus_Bps", "best_window", "median_window", "cuda_init_s",
            "build_s", "ctor_s", "ctor_stats", "end_to_end_s",
            "enhanced_allfeatures_merges_per_sec", "allfeatures_vs_baseline",
            "distance_only_steps_per_sec", "kernel_selfcheck", "device")


@pytest.fixture(scope="module")
def lines():
    return bench.load_corpus()[:40]


# ------------------------------------------------------------ tiny runs

def test_bench_enhanced_tiny(lines):
    rec, tok = bench.bench_enhanced(lines, device="cpu", **TINY)
    assert rec["merges"] == len(tok.merge_history) >= TINY["steps"]
    assert rec["vocab"] == len(tok.vocab)
    assert rec["rate"] > 0 and rec["stop"] == "steps"
    assert len(rec["chunk_syncs"]) == 3
    cfg = tok.enh_config
    assert cfg.priority_replay and not cfg.use_dense_channel
    assert tok.normalizer.pre_split is not None


def test_bench_allfeatures_tiny_reaches_capacity(lines):
    """At 128 slots the all-features path stops at capacity, as the full
    run stops at 50,176."""
    rec, tok = bench.bench_allfeatures(lines, device="cpu", steps=400,
                                       max_vocab_size=128, log_every=64)
    assert rec["stop"] == "capacity"
    assert rec["vocab"] == 128 == int(tok.state.vocab_size)
    assert rec["phase"] == tok.current_phase
    assert math.isfinite(rec["curvature"])
    assert tok.enh_config.use_dense_channel and tok.enh_config.use_hierarchical


def test_bench_distance_only_tiny():
    rec, st = bench.bench_distance_only(device="cpu", steps=8,
                                        max_vocab_size=256, n_points=64)
    assert 1 <= len(rec["trials"]) <= 6
    assert rec["rate"] == max(rec["trials"]) > 0
    assert rec["steps"] == int(st.step) == 256 + 8 * len(rec["trials"]) \
        or bool(st.stopped)
    assert rec["vocab"] == int(st.vocab_size)


def test_stop_reasons(lines):
    """Two chunks in a row that merge nothing end the run ("no
    candidates"): the first is recorded, the second is not."""
    _, tok = bench.bench_enhanced(lines, device="cpu", steps=16,
                                  max_vocab_size=256, log_every=8)
    train = dict(steps=64, log_every=8, target_vocab_size=10_000)
    tok.enh_config = dataclasses.replace(tok.enh_config,
                                         min_pair_freq=1 << 20)
    n = len(tok.training_stats)
    tok.training_stats.clear()
    tok.optimize_merges(**train)
    assert n > 0 and len(tok.training_stats) == 1
    assert tok.training_stats[0]["chunk_merges"] == 0
    assert bench.stop_reason(tok, train) == "no candidates"
    assert bench.stop_reason(tok, dict(train, target_vocab_size=10)) == \
        "target"


def test_run_headline_fields(lines):
    seen = []
    head, diag, rec, failed = bench.run(
        "cpu", lines=lines, after=lambda name, r, obj: seen.append(name),
        distance_steps=8, distance_points=64, **TINY)
    assert seen == ["enhanced", "allfeatures", "distance_only"]
    line = json.loads(json.dumps(head))
    assert set(HEADLINE) <= set(line)
    assert line["metric"] == "enhanced_merges_per_sec"
    assert line["unit"] == "merges/s"
    assert line["value"] > 0 and line["distance_only_steps_per_sec"] > 0
    assert line["enhanced_allfeatures_merges_per_sec"] > 0
    # From the record's unrounded rate, as bench.headline rounds it: the
    # rounded value can differ from it by 0.01 (test_headline_rounds_rate).
    assert line["vs_baseline"] == round(
        rec["enhanced"]["rate"] / bench.REF_BASELINE_STEPS_PER_SEC, 2)
    assert line["device"] == {"name": "cpu", "power_limit": None}
    for dropped in ("compile_s", "ctor_compile_s", "cache_hits",
                    "cache_requests", "cache_copied", "cold_dir",
                    "backend_warmup_s"):
        assert dropped not in line
    assert failed == {}
    assert line["kernel_selfcheck"]["enhanced_full_selfcheck"] == "pass"
    assert diag[0].startswith("# enhanced: merges=")
    assert diag[1].startswith("# allfeatures: merges=")
    assert "curvature=" in diag[1] and "chunk_syncs=" in diag[1]
    compact = json.loads(json.dumps(rec, separators=(",", ":")))
    for path in ("enhanced", "allfeatures"):
        assert {"merges", "vocab", "stop", "rate"} <= set(compact[path])
    for path in ("enhanced", "allfeatures", "distance_only"):
        mem = compact[path]["memory"]
        assert mem["host_peak_rss_mib"] > 0 and mem["device_peak_mib"] is None
    assert {"curvature", "phase"} <= set(compact["allfeatures"])


def test_headline_rounds_rate():
    """``vs_baseline`` is the unrounded rate over the baseline, rounded once
    (the root bench.py:282-284): at this rate it is 218.71, while the
    rounded ``value`` 2652.89 over the baseline would give 218.70."""
    rate = 2652.8922851973343
    enh = dict(rate=rate, first_chunk=None, corpus_bytes_per_sec_per_chip=None,
               best_window=None, median_window=None, t_init=0.0, t_train=1.0,
               ctor_stats={})
    head = bench.headline(enh, {"rate": 1.0}, {"rate": 1.0}, {}, 0.0, 0.0,
                          {"name": "cpu", "power_limit": None})
    assert head["value"] == 2652.89
    assert head["vs_baseline"] == 218.71
    assert round(head["value"] / bench.REF_BASELINE_STEPS_PER_SEC, 2) == 218.70


# ------------------------------------------- the root bench.py's arguments

def _root_bench():
    with open(os.path.join(REPO, "bench.py")) as f:
        return {n.name: n for n in ast.parse(f.read()).body
                if isinstance(n, ast.FunctionDef)}


def _calls(fn, name):
    return [n for n in ast.walk(fn) if isinstance(n, ast.Call)
            and ast.unparse(n.func).split(".")[-1] == name]


def _value(node):
    """A keyword's value: the constant it evaluates to, else its source."""
    try:
        return eval(compile(ast.Expression(node), "<bench.py>", "eval"),
                    {"__builtins__": {}})
    except NameError:
        return ast.unparse(node)


def _kwargs(call):
    return {k.arg: _value(k.value) for k in call.keywords}


@pytest.mark.parametrize("fn,ctor,train", [
    ("bench_enhanced", bench.ENHANCED, bench.ENHANCED_TRAIN),
    ("bench_allfeatures", bench.ALLFEATURES, bench.ALLFEATURES_TRAIN),
])
def test_enhanced_workloads_match_root_bench(fn, ctor, train):
    node = _root_bench()[fn]
    (call,) = _calls(node, "EnhancedHyperbolicTokenizer")
    kw = _kwargs(call)
    passed_by_port = {"corpus_sample": "lines"}
    if fn == "bench_enhanced":
        passed_by_port["normalizer"] = (
            "NormalizerConfig(pre_split=N.WORDS_WITH_SPACE)")
    assert kw == {**ctor, **passed_by_port}
    assert [ast.unparse(a) for a in call.args] == ["vocab", "emb"]
    (opt,) = _calls(node, "optimize_merges")
    assert _kwargs(opt) == train
    (pts,) = _calls(node, "random_points")
    assert [_value(a) for a in pts.args[2:]] == [bench.EMB_DIM]
    assert _kwargs(pts) == {"sigma": bench.EMB_SIGMA}


def test_distance_only_matches_root_bench():
    node = _root_bench()["bench_distance_only"]
    d = bench.DISTANCE
    (pts,) = _calls(node, "random_points")
    assert [_value(a) for a in pts.args[1:]] == [d["n_points"], d["d"]]
    assert _kwargs(pts) == {"sigma": d["sigma"]}
    (cfg,) = _calls(node, "MergeConfig")
    assert _kwargs(cfg) == {"max_vocab_size": d["max_vocab_size"],
                            "search_block": d["search_block"]}
    (init,) = _calls(node, "init_state")
    assert _kwargs(init) == {"curvature": 1.0, "threshold": d["threshold"],
                             "config": "config"}
    steps = [_value(c.args[2]) for c in _calls(node, "run_merges")]
    assert steps == [d["warmup"], d["steps"]]
    src = ast.unparse(node)
    assert f"len(trials) < {d['trials']}" in src
    assert f"time.monotonic() + {d['deadline_s']}" in src
    assert "max(trials) < 1.5 * min(trials)" in src


# ---------------------------------------------------------------- failures

def _tiny(monkeypatch, lines):
    """Make ``main``'s run tiny: the corpus cut, the paths shrunk."""
    monkeypatch.setattr(bench, "load_corpus", lambda: lines)
    for name in ("bench_enhanced", "bench_allfeatures"):
        fn = getattr(bench, name)
        monkeypatch.setattr(bench, name,
                            lambda *a, _fn=fn, **k: _fn(*a, **{**k, **TINY}))
    dist = bench.bench_distance_only
    monkeypatch.setattr(
        bench, "bench_distance_only",
        lambda **k: dist(**{**k, "steps": 8, "n_points": 64,
                            "max_vocab_size": 256}))


def test_main_exits_zero_when_all_pass(monkeypatch, lines, capsys):
    _tiny(monkeypatch, lines)
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    first = json.loads(out.splitlines()[0])
    assert first["metric"] == "enhanced_merges_per_sec"
    last = json.loads(err.strip().splitlines()[-1])
    assert last["allfeatures"]["vocab"] > 0


def test_failed_path_ends_main(monkeypatch, lines):
    _tiny(monkeypatch, lines)

    def boom(**_):
        raise RuntimeError("the all-features path failed")

    monkeypatch.setattr(bench, "bench_allfeatures", boom)
    with pytest.raises(RuntimeError, match="all-features path failed"):
        bench.main(["--device", "cpu"])


def test_failed_selfcheck_exits_nonzero(monkeypatch, lines, capsys):
    _tiny(monkeypatch, lines)
    monkeypatch.setattr(selfcheck, "kernel_selfcheck", lambda dev: {
        "kernel_selfcheck": "pass", "enhanced_kernel_selfcheck": "pass",
        "enhanced_full_selfcheck": "FAIL {'pos': 3}"})
    assert bench.main(["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "enhanced_full_selfcheck" in err
    json.loads(err.strip().splitlines()[-1])     # the record stays last


def test_bench_refuses_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "hyptokenizer_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
