"""The readers of the program's own spans and counters (``spans.py`` and
``sync_ms``, ``sync.replay_ms``, ``replay.rounds_per_sync``,
``curvature_ms``, ``strings_ms``): their arithmetic on made-up snapshots,
None from a program without them, and all five from a small traced run on
the CPU."""

import sys

import pytest

from portbench import registry, run
from portbench.tests.conftest import SMALL_FLAGSHIP

NEW = ("sync_ms", "sync.replay_ms", "replay.rounds_per_sync", "curvature_ms",
       "strings_ms")
SNAP = {
    "spans": {
        "sync": {"count": 29, "host_s": 0.30, "elapsed_s": 0.58},
        "sync.replay": {"count": 29, "host_s": 0.20, "elapsed_s": 0.377},
        "curvature_adam": {"count": 45, "host_s": 0.05, "elapsed_s": 0.09},
        "chunk.strings": {"count": 24, "host_s": 0.12, "elapsed_s": 0.125},
    },
    "counters": {"replay.match_rounds": 290, "replay.passes": 29},
}


def read(name, r):
    return registry.metric(name).read(r)


def _run(kind="enhanced_training", traced=True):
    return {"job_kind": kind, "setup_s": 7.5, "window_s": 2.0,
            "jobs": [{"merges": 45_000, "traced": traced,
                      "trace": {"span_s": 1.5} if traced else None}]}


@pytest.fixture
def snapshot(monkeypatch):
    from hyptokenizer_tpu_torch.utils import metrics

    snap = {"spans": dict(SNAP["spans"]),
            "counters": dict(SNAP["counters"])}
    monkeypatch.setattr(metrics, "trace_snapshot", lambda: snap)
    return snap


def test_the_readers_arithmetic(snapshot):
    r = _run()
    assert read("sync_ms", r) == pytest.approx(580 / 29)
    assert read("sync.replay_ms", r) == pytest.approx(377 / 29)
    assert read("replay.rounds_per_sync", r) == pytest.approx(10.0)
    assert read("curvature_ms", r) == pytest.approx(2.0)
    assert read("strings_ms", r) == pytest.approx(125 / 24)
    assert all(isinstance(read(n, r), float) for n in NEW)


def test_none_where_there_is_nothing_to_read(snapshot):
    for r in (_run(traced=False), _run(kind="embed_pretrain")):
        assert [read(n, r) for n in NEW] == [None] * 5
    del snapshot["spans"]["sync"]
    del snapshot["spans"]["curvature_adam"]
    r = _run()
    assert [read(n, r) for n in NEW] == [None, None, None, None,
                                         pytest.approx(125 / 24)]


def test_none_from_a_program_without_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, "hyptokenizer_tpu_torch.utils.metrics",
                        None)   # its import raises ImportError
    assert [read(n, _run()) for n in NEW] == [None] * 5


def test_a_small_traced_run_reports_all_five():
    r = run.run_cell("flagship.wiki", 2**31 + 4242, 0.2, True, "cpu",
                     SMALL_FLAGSHIP)
    assert r["correct"] is True
    for name in NEW:
        m = r["metrics"][name]
        assert isinstance(m["value"], float) and m["value"] > 0, name
