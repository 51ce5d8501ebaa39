"""The readers of the all-features training (``dense_spans.py`` and the
``k2.*``, ``k2_roofline``, ``storm.*``, ``dense.merge_share`` and
``*.dense`` metrics): their arithmetic on a made-up traced run, None where
there is nothing to read, and the ones the CPU can give from a small
traced run."""

import sys

import pytest

from portbench import peaks, registry, run
from portbench.counts import enhanced_loop as K
from portbench.tests.test_portbench_dense import CELL, SMALL_QUICKSTART

NAMES = ("k2.us_per_step", "k2_roofline", "k2.launches",
         "storm.syncs_per_kmerge", "storm.syncs_chunks4_8",
         "dense.merge_share", "sync_ms.dense", "curvature_ms.dense",
         "device_idle.dense")
PROGRAM = ("storm.syncs_per_kmerge", "dense.merge_share", "sync_ms.dense",
           "curvature_ms.dense")   # those read from the program's snapshot
LAUNCHES = [
    {"steps": 40, "merges": 300, "queue_size": 4096, "d1": 101,
     "dense_rows": 20_000},
    {"steps": 10, "merges": 70, "queue_size": 4096, "d1": 101,
     "dense_rows": 30_000},
    {"steps": 5, "merges": 40, "queue_size": 4096, "d1": 101,
     "dense_rows": 0},   # a corpus-only launch: not K2's
]
SNAP = {
    "spans": {"sync": {"count": 1500, "host_s": 9.0, "elapsed_s": 18.0},
              "curvature_adam": {"count": 460, "host_s": 2.0,
                                 "elapsed_s": 2.3}},
    "counters": {"sync.phase2": 600, "merge.dense": 9_000},
}


def read(name, r):
    return registry.metric(name).read(r)


def _run(kind="dense_training", traced=True, chunks=10):
    trace = {"span_s": 100.0, "busy_s": 8.0, "launches": 5000,
             "ops": {"dense_loop_kernel(Params)": [0.0025, 2],
                     "elementwise": [1.0, 100]},
             "launches_marked": LAUNCHES}
    return {"job_kind": kind, "setup_s": 30.0, "window_s": 60.0,
            "jobs": [{"merges": 46_000, "phase2_merges": 5000,
                      "chunk_syncs": list(range(1, chunks + 1)),
                      "traced": traced, "trace": trace if traced else None}]}


@pytest.fixture
def snapshot(monkeypatch):
    from hyptokenizer_tpu_torch.utils import metrics

    snap = {"spans": dict(SNAP["spans"]),
            "counters": dict(SNAP["counters"])}
    monkeypatch.setattr(metrics, "trace_snapshot", lambda: snap)
    return snap


def test_the_readers_arithmetic(snapshot):
    r = _run()
    bound = sum(peaks.roofline_seconds(
        K.segment_ops(m["queue_size"], m["d1"], m["merges"], m["steps"],
                      m["dense_rows"]),
        K.segment_bytes(m["queue_size"], m["d1"], m["merges"],
                        m["dense_rows"])) for m in LAUNCHES[:2])
    assert read("k2.us_per_step", r) == pytest.approx(2500 / 50)
    assert read("k2_roofline", r) == pytest.approx(100 * bound / 0.0025)
    assert read("k2.launches", r) == 2.0
    assert read("storm.syncs_per_kmerge", r) == pytest.approx(120.0)
    assert read("storm.syncs_chunks4_8", r) == 4 + 5 + 6 + 7 + 8
    assert read("dense.merge_share", r) == pytest.approx(100 * 9000 / 46000)
    assert read("sync_ms.dense", r) == pytest.approx(12.0)
    assert read("curvature_ms.dense", r) == pytest.approx(5.0)
    assert read("device_idle.dense", r) == pytest.approx(92.0)
    assert all(isinstance(read(n, r), float) for n in NAMES)


def test_none_where_there_is_nothing_to_read(snapshot):
    assert [read(n, _run(traced=False)) for n in NAMES] == [None] * 9
    other = [read(n, _run(kind="enhanced_training")) for n in NAMES]
    assert [n for n, v in zip(NAMES, other) if v is not None] == [
        "k2.us_per_step", "k2_roofline"]   # K2's launches, whatever ran
    assert read("storm.syncs_chunks4_8", _run(chunks=7)) is None
    snapshot["spans"].clear()
    snapshot["counters"].clear()
    r = _run()
    assert [read(n, r) for n in PROGRAM] == [None] * 4


def test_none_from_a_program_without_a_snapshot(monkeypatch):
    monkeypatch.setitem(sys.modules, "hyptokenizer_tpu_torch.utils.metrics",
                        None)   # its import raises ImportError
    assert [read(n, _run()) for n in PROGRAM] == [None] * 4


def test_a_small_traced_run_reports_what_the_cpu_has():
    small = dict(SMALL_QUICKSTART,
                 config=dict(SMALL_QUICKSTART["config"], log_every=200))
    r = run.run_cell(CELL, 2**31 + 99, 0.1, True, "cpu", small)
    assert r["correct"] is True
    for name in PROGRAM + ("storm.syncs_chunks4_8",):
        m = r["metrics"][name]
        assert isinstance(m["value"], float) and m["value"] > 0, name
    assert 0 < r["metrics"]["dense.merge_share"]["value"] < 100
