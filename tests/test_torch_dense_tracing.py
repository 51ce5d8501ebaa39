"""The counters of the all-features training on the dense channel, on the
CPU: syncs by phase (``sync.phase1``-``sync.phase3``), the dense channel's
merges (``merge.dense``) and the threshold's empty-round growths
(``threshold.empty_growth``), recorded only while a profiler records."""

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

# The Quick start's features at small sizes: the dense channel, three
# phases switching early, compression, curvature every 10 merges, and
# points spread wide enough that the first steps find nothing under the
# phase's threshold (empty rounds).
SMALL = dict(
    corpus_sample=CORPUS, max_vocab_size=256, merge_threshold=0.1,
    corpus_max_tokens=1024, freq_table_size=1024, queue_size=16, seed=0,
    use_dense_channel=True, use_hierarchical=True,
    use_compression_aware=True, use_adaptive_curvature=True,
    optimize_curvature_freq=10, merge_batch=4, merge_policy="priority")
PHASES = {2: 20, 3: 50}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def train(steps=90, log_every=30, sigma=0.6, device="cpu", **overrides):
    chars = sorted({ch for line in CORPUS for ch in line})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    gen = torch.Generator(device=device).manual_seed(0)
    emb = L.random_points(gen, len(vocab), 8, sigma=sigma, device=device)
    tok = EnhancedHyperbolicTokenizer(vocab, emb, device=device,
                                      **dict(SMALL, **overrides))
    tok.optimize_merges(steps=steps, log_every=log_every,
                        phase_transition_steps=PHASES)
    return tok


def profiled(fn, device="cpu"):
    assert not TM.tracing()
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        out = fn()
    return out, TM.trace_snapshot()


def test_syncs_by_phase_add_up_to_the_syncs():
    tok, snap = profiled(train)
    counters = snap["counters"]
    phases = [counters.get(f"sync.phase{k}", 0) for k in (1, 2, 3)]
    assert min(phases) > 0
    assert sum(phases) == snap["spans"]["sync"]["count"] == sum(
        s["chunk_syncs"] for s in tok.training_stats)


def test_dense_merges_are_counted():
    tok, snap = profiled(train)
    assert 0 < snap["counters"]["merge.dense"] <= len(tok.merge_history)


def test_empty_growths_match_the_steps(monkeypatch):
    grown = []
    step = E.enhanced_step

    def counted(st, config, sampler):
        out = step(st, config, sampler)
        empty = (int(out.base.num_merges) == int(st.base.num_merges)
                 and not bool(out.needs_resync))
        grown.append(empty and int(st.base.empty_rounds) + 1
                     >= config.base.empty_growth_after)
        return out

    monkeypatch.setattr(E, "enhanced_step", counted)
    _, snap = profiled(train)
    assert sum(grown) > 0
    assert snap["counters"]["threshold.empty_growth"] == sum(grown)


def test_nothing_is_recorded_with_tracing_off(monkeypatch):
    _, before = profiled(lambda: train(steps=30))

    def refuse(*a, **kw):
        raise AssertionError("read with no profiler recording")

    monkeypatch.setattr(E, "_resync_reason", refuse)
    monkeypatch.setattr(E, "_phase_index", refuse)
    tok = train()
    assert len(tok.merge_history) > 0
    assert TM.trace_snapshot() == before


def test_a_corpus_only_training_records_no_dense_merge():
    tok, snap = profiled(lambda: train(use_dense_channel=False,
                                       merge_threshold=5.0, sigma=0.01))
    counters = snap["counters"]
    assert len(tok.merge_history) > 0
    assert "merge.dense" not in counters
    assert sum(counters.get(f"sync.phase{k}", 0) for k in (1, 2, 3)) == \
        snap["spans"]["sync"]["count"]


@pytest.mark.cuda
def test_kernel_counts_on_the_card():
    """K2 counts its dense merges and empty-round growths on the card, into
    a count that only a traced run reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K

    tok, snap = profiled(lambda: train(device="cuda"), "cuda")
    counters = snap["counters"]
    assert 0 < counters["merge.dense"] <= len(tok.merge_history)
    assert counters["threshold.empty_growth"] > 0
    phases = [counters.get(f"sync.phase{k}", 0) for k in (1, 2, 3)]
    assert sum(phases) == snap["spans"]["sync"]["count"]
    assert K.dense_launches > 0
