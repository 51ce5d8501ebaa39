"""The port's tracing (``utils/metrics.py``: ``span``, ``count``,
``trace_snapshot``, ``profile_trace``) and the spans and counters inside a
corpus-only training, on the CPU; one case (marker ``cuda``) reads the
sync's event times on the card:

    python -m pytest -m cuda tests/test_torch_tracing.py
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hyptokenizer_tpu_torch.ops import lorentz as L
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from hyptokenizer_tpu_torch.utils import metrics as TM

CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "a cat and a dog and a rat",
    "the rat sat and the cat sat",
    "dogs and cats and rats ran fast",
] * 6

# The flagship's corpus-only recipe at small sizes, with a curvature step
# every 7 merges. A queue of 8 (``RESYNCS``) truncates and drains
# mid-chunk.
SMALL = dict(
    corpus_sample=CORPUS, max_vocab_size=256, merge_threshold=5.0,
    search_block=64, corpus_max_tokens=1024, freq_table_size=1024,
    queue_size=128, seed=0, use_dense_channel=False,
    use_hierarchical=False, use_compression_aware=False,
    use_adaptive_curvature=True, optimize_curvature_freq=7,
    alpha=0.05, beta=0.9, gamma=0.05, merge_batch=4,
    merge_policy="priority")

RESYNCS = dict(queue_size=8)
CTOR_KEYS = {"ctor_total_s", "ctor_base_s", "ctor_corpus_s", "ctor_morph_s",
             "ctor_assemble_s"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def train(device="cpu", steps=60, log_every=16, **overrides):
    chars = sorted({ch for line in CORPUS for ch in line})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    gen = torch.Generator().manual_seed(0)
    emb = L.random_points(gen, len(vocab), 8, sigma=0.6, device="cpu")
    tok = EnhancedHyperbolicTokenizer(vocab, emb.to(device), device=device,
                                      **dict(SMALL, **overrides))
    tok.optimize_merges(steps=steps, log_every=log_every)
    return tok


def profiled(fn, device="cpu", look_first=True):
    """``fn()`` in a profiler session, with its profiler and snapshot. The
    session's record starts at the first look that finds the profiler
    after one that did not: ``look_first`` makes that look beforehand."""
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    if look_first:
        assert not TM.tracing()
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof, TM.trace_snapshot()


def test_off_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("traced with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(E, "_resync_reason", refuse)   # the resync's read
    assert not TM.tracing()
    before = TM.trace_snapshot()
    tok = train(steps=40, queue_size=8)
    assert sum(s["chunk_syncs"] for s in tok.training_stats) > len(
        tok.training_stats)   # resyncs ran, their reasons unread
    with TM.span("outer") as sp:
        TM.count("outer.calls")
    assert sp.host_s > 0
    assert TM.trace_snapshot() == before


def test_spans_nest_among_the_profilers_events():
    def work():
        with TM.span("outer"):
            with TM.span("outer.inner") as inner:
                torch.ones(64) @ torch.ones(64)
                TM.count("inner.calls", 3)
        return inner

    inner, prof, snap = profiled(work)
    ev = {e.name: e.time_range for e in prof.events()
          if e.name in ("outer", "outer.inner")}
    assert set(ev) == {"outer", "outer.inner"}
    assert ev["outer"].start <= ev["outer.inner"].start
    assert ev["outer.inner"].end <= ev["outer"].end
    assert snap["counters"] == {"inner.calls": 3}
    assert set(snap["spans"]) == {"outer", "outer.inner"}
    s_in, s_out = snap["spans"]["outer.inner"], snap["spans"]["outer"]
    assert s_in["count"] == s_out["count"] == 1
    assert s_in["host_s"] == s_in["elapsed_s"] == inner.host_s   # no card
    assert s_in["elapsed_s"] <= s_out["elapsed_s"]


def test_snapshot_holds_the_last_session_alone():
    profiled(lambda: train(steps=60), look_first=False)
    train(steps=30)
    tok, _, snap = profiled(lambda: train(steps=30, log_every=10),
                            look_first=False)
    syncs = sum(s["chunk_syncs"] for s in tok.training_stats)
    assert snap["spans"]["constructor"]["count"] == 1
    assert snap["spans"]["sync"]["count"] == syncs
    assert snap["spans"]["chunk.strings"]["count"] == len(tok.training_stats)


@pytest.mark.parametrize("policy", ["priority", "fixpoint"])
def test_a_profiled_trainings_spans_and_counters(policy):
    tok, _, snap = profiled(lambda: train(steps=90, merge_policy=policy,
                                          **RESYNCS))
    spans, counters = snap["spans"], snap["counters"]
    stats = tok.training_stats
    syncs = sum(s["chunk_syncs"] for s in stats)
    assert spans["sync"]["count"] == syncs
    assert counters["sync.opening"] == len(stats)
    resyncs = [counters.get(f"sync.resync.{r}", 0)
               for r in ("spent", "truncated")]
    assert min(resyncs) > 0
    assert counters["sync.opening"] + sum(resyncs) == syncs
    ends = {k: v for k, v in counters.items()
            if k.startswith("segment.end.")}
    assert set(ends) <= {f"segment.end.{r}" for r in (
        "stopped", "resync", "merges", "steps", "curvature", "cap")}
    assert sum(ends.values()) == spans["segment.wait"]["count"] > 0
    assert counters["replay.match_rounds"] >= counters["replay.passes"] >= 1
    if policy == "fixpoint":
        assert counters["replay.match_rounds"] == counters["replay.passes"]
    parts = sum(spans[f"sync.{p}"]["elapsed_s"]
                for p in ("replay", "pair_table", "queues"))
    assert 0 < parts <= spans["sync"]["elapsed_s"]
    assert spans["sync.queues"]["count"] == syncs
    # One step per multiple of 7 crossed, the last perhaps not yet taken.
    assert len(tok.merge_history) // 7 - 1 <= spans["curvature_adam"][
        "count"] <= len(tok.merge_history) // 7
    assert spans["chunk.strings"]["count"] == len(stats)
    assert spans["chunk.stats"]["count"] == len(stats)


def test_ctor_stats_come_from_the_constructor_spans():
    tok, _, snap = profiled(lambda: train(steps=8, log_every=8))
    assert set(tok.ctor_stats) == CTOR_KEYS
    for key, name in (("ctor_total_s", "constructor"),
                      ("ctor_base_s", "constructor.base"),
                      ("ctor_corpus_s", "constructor.corpus"),
                      ("ctor_morph_s", "constructor.morphology"),
                      ("ctor_assemble_s", "constructor.assemble")):
        assert snap["spans"][name]["count"] == 1
        assert tok.ctor_stats[key] == round(snap["spans"][name]["host_s"], 3)
    assert set(train(steps=8, log_every=8).ctor_stats) == CTOR_KEYS


def test_profile_trace_writes_the_spans(tmp_path):
    with TM.profile_trace(str(tmp_path)):
        with TM.span("outer"):
            TM.count("outer.calls")
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "outer" in names
    with open(tmp_path / "spans.json") as f:
        snap = json.load(f)
    assert snap["counters"] == {"outer.calls": 1}
    assert snap["spans"]["outer"]["count"] == 1


@pytest.mark.cuda
def test_sync_event_times_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tok, _, snap = profiled(lambda: train("cuda", steps=90, **RESYNCS),
                            "cuda")
    spans = snap["spans"]
    assert spans["sync"]["count"] == sum(
        s["chunk_syncs"] for s in tok.training_stats)
    replay, sync = spans["sync.replay"], spans["sync"]
    assert 0 < replay["elapsed_s"] <= sync["elapsed_s"]
    parts = sum(spans[f"sync.{p}"]["elapsed_s"]
                for p in ("replay", "pair_table", "queues"))
    assert parts <= sync["elapsed_s"]
    assert spans["segment.launch"]["count"] == spans["segment.wait"]["count"]
