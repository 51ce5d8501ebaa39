"""Mid-training checkpoint and resume of the port (hyptokenizer_tpu_torch/
utils/checkpoint.py), on the CPU.

``tests/test_checkpoint.py``'s three cases (base, enhanced, shrunk corpus)
on the port, and an enhanced run with adaptive curvature on (the
configuration of ``tests/torch_port_common.SMALL``: a curvature event every
7 merges) whose resumed history equals both the port's uninterrupted one
and the JAX package's. Exact throughout: histories and vocabularies equal,
embeddings, curvature and threshold equal to the bit (the resumed run draws
the same numbers from the restored sampler states).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.ops import lorentz as JL
from hyptokenizer_tpu_torch.tokenizer import (
    EnhancedHyperbolicTokenizer, HyperbolicTokenizer)
from hyptokenizer_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint)
from tests.torch_port_common import (
    one_torch_thread, ReplaySampler, make_pair)  # noqa: F401


def build(cls=HyperbolicTokenizer, **kw):
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + list("abcdefgh")
    emb = np.asarray(JL.random_points(jax.random.PRNGKey(0), len(vocab), 8,
                                      sigma=0.6))
    kw.setdefault("merge_threshold", 3.0)
    kw.setdefault("max_vocab_size", 64)
    kw.setdefault("search_block", 16)
    return cls(vocab, emb, device="cpu", **kw)


def assert_same_state(a, b):
    """Every tensor of two merge states equal, to the bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            assert_same_state(x, y)
        else:
            assert torch.equal(x, y), f.name


def untimed(stats):
    """Training statistics without their wall-clock entries."""
    return [{k: v for k, v in s.items()
             if k not in ("steps_per_sec", "chunk_seconds")} for s in stats]


def test_base_checkpoint_roundtrip(tmp_path):
    tok = build()
    tok.optimize_merges(steps=6, log_every=6)
    save_checkpoint(str(tmp_path / "ck"), tok)
    state_at_save = int(tok.state.step)

    tok2 = build()
    restore_checkpoint(str(tmp_path / "ck"), tok2)
    assert int(tok2.state.step) == state_at_save
    assert tok2.vocab == tok.vocab
    assert tok2.merge_history == tok.merge_history
    assert tok2.startup_stats == tok.startup_stats
    assert_same_state(tok2.state, tok.state)

    # Resumed training continues identically to uninterrupted training: the
    # startup controller does not run again, the statistics draw on.
    tok.optimize_merges(steps=6, log_every=6)
    tok2.optimize_merges(steps=6, log_every=6)
    assert tok.merge_history == tok2.merge_history
    assert untimed(tok.training_stats) == untimed(tok2.training_stats)
    assert_same_state(tok2.state, tok.state)


def test_enhanced_checkpoint_roundtrip(tmp_path):
    corpus = ["abc abd abe", "cde cdf"] * 5
    kw = dict(corpus_sample=corpus, corpus_max_tokens=256,
              use_hierarchical=False, use_adaptive_curvature=False)
    tok = build(EnhancedHyperbolicTokenizer, **kw)
    tok.optimize_merges(steps=5, log_every=5)
    save_checkpoint(str(tmp_path / "ck"), tok)

    tok2 = build(EnhancedHyperbolicTokenizer, **kw)
    restore_checkpoint(str(tmp_path / "ck"), tok2)
    assert tok2.merge_history == tok.merge_history
    tok.optimize_merges(steps=5, log_every=5)
    tok2.optimize_merges(steps=5, log_every=5)
    assert tok.merge_history == tok2.merge_history
    assert_same_state(tok2.enh_state, tok.enh_state)


def test_checkpoint_restores_shrunk_corpus(tmp_path):
    """Mid-training checkpoints survive corpus-buffer shrinking."""
    corpus = ["aa bb cc dd", "bb cc dd aa"] * 6

    def build_shrinking():
        vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + sorted(
            {c for ln in corpus for c in ln})
        emb = np.asarray(JL.random_points(jax.random.PRNGKey(2), len(vocab),
                                          8, sigma=0.5))
        tok = EnhancedHyperbolicTokenizer(
            vocab, emb, merge_threshold=50.0, max_vocab_size=64,
            search_block=32, corpus_sample=corpus, corpus_max_tokens=256,
            use_hierarchical=False, use_adaptive_curvature=False,
            use_compression_aware=False, use_dense_channel=False,
            min_pair_freq=1, merge_batch=4, seed=1, corpus_shrink=True,
            device="cpu")
        tok.MIN_CORPUS_BUFFER = 16
        return tok

    tok = build_shrinking()
    tok.optimize_merges(steps=12, log_every=4)
    assert tok.enh_state.corpus.shape[0] < 256  # shrank
    n = len(tok.merge_history)
    save_checkpoint(str(tmp_path / "ck"), tok)

    tok2 = build_shrinking()
    restore_checkpoint(str(tmp_path / "ck"), tok2)
    assert len(tok2.merge_history) == n
    assert tok2.enh_state.corpus.shape == tok.enh_state.corpus.shape
    tok.optimize_merges(steps=8, log_every=4)
    tok2.optimize_merges(steps=8, log_every=4)  # training continues
    assert tok2.merge_history == tok.merge_history


def test_checkpoint_refuses_another_configuration(tmp_path):
    tok = build()
    tok.optimize_merges(steps=2, log_every=2)
    save_checkpoint(str(tmp_path / "ck"), tok)
    with pytest.raises(ValueError, match="configuration it was saved with"):
        restore_checkpoint(str(tmp_path / "ck"), build(max_vocab_size=96))
    with pytest.raises(ValueError, match="enhanced"):
        tok_e = build(EnhancedHyperbolicTokenizer,
                      corpus_sample=["abc abd"] * 3, corpus_max_tokens=64,
                      use_adaptive_curvature=False)
        save_checkpoint(str(tmp_path / "ek"), tok_e)
        restore_checkpoint(str(tmp_path / "ek"), build())


@pytest.mark.parametrize("sampler", ["replay", "generator"])
def test_resume_with_adaptive_curvature_is_exact(tmp_path, sampler):
    """Curvature events every 7 merges, a queue that truncates and drains:
    a run checkpointed after two 8-merge chunks and resumed in a fresh
    tokenizer equals the uninterrupted run, state for state; with the JAX
    package's draws both equal the JAX package's history."""
    jt, tt = make_pair()
    _, tt2 = make_pair()
    if sampler == "replay":
        key = jt.enh_state.key
        tt.sampler, tt.stats_sampler = ReplaySampler(key), ReplaySampler()
        tt2.sampler, tt2.stats_sampler = ReplaySampler(key), ReplaySampler()
    for tok in (tt, tt2):
        tok.optimize_merges(steps=16, log_every=8)
    save_checkpoint(str(tmp_path / "ck"), tt2)
    _, resumed = make_pair()
    if sampler == "replay":
        resumed.sampler, resumed.stats_sampler = (ReplaySampler(),
                                                  ReplaySampler())
    restore_checkpoint(str(tmp_path / "ck"), resumed)
    tt.optimize_merges(steps=16, log_every=8)
    resumed.optimize_merges(steps=16, log_every=8)
    assert float(tt.state.curvature) != 1.0  # curvature events happened
    assert resumed.merge_history == tt.merge_history
    assert resumed.vocab == tt.vocab
    assert untimed(resumed.training_stats) == untimed(tt.training_stats)
    assert_same_state(resumed.enh_state, tt.enh_state)
    if sampler == "replay":
        jt.optimize_merges(steps=32, log_every=8)
        assert resumed.merge_history == jt.merge_history
        assert float(resumed.state.curvature) == pytest.approx(
            float(jt.state.curvature), rel=1e-5)
