"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
CUDA device):

    python -m pytest -m cuda tests/test_torch_*.py

Kernel K1 (ops/cuda/csrc/enhanced_loop.cu) is held to its plain version
(``enhanced_state.enhanced_step`` looped) on the same small states: merge
history, counters and token features exact, rows within 1e-5 (float32
sums in another order). Kernel K2 (the same source, dense channel) is held
to it by lockstep with oracle resync (``evals/selfcheck.py``), chunk by
chunk as the JAX package holds its kernel, and step by step with the fold
and the rows compared too: its grams and scores are summed in another
order, and a near-tie may reorder a batch. Kernel K3 (ops/cuda/csrc/pairwise.cu) is held to
``search.full_pass_best``: distances within 1e-5, partners equal except at
ties within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hyptokenizer_tpu_torch.evals import selfcheck
from hyptokenizer_tpu_torch.ops import lorentz as L
from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K1
from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from tests.torch_port_checks import assert_same_best

pytestmark = pytest.mark.cuda

CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "a cat and a dog and a rat",
    "the rat sat and the cat sat",
    "dogs and cats and rats ran fast",
] * 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class NumpySampler:
    """Device-independent draws, so a CPU run and a card run see the same
    numbers."""

    def __init__(self, seed, device):
        self.rng = np.random.default_rng(seed)
        self.device = device

    def _draw(self, shape, high):
        return torch.from_numpy(self.rng.integers(0, high, shape).astype(
            np.int32)).to(self.device)

    def coherence(self, n, high):
        return self._draw((n,), high)

    def curvature(self, hp, hn, ds, high):
        return (self._draw((hp, hn), high), self._draw((ds,), high),
                self._draw((ds,), high))


def small_tokenizer(device, **kw):
    chars = sorted({ch for line in CORPUS for ch in line})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    emb = L.random_points(gen, len(vocab), 8, sigma=0.6, device="cpu")
    cfg = dict(corpus_sample=CORPUS, max_vocab_size=256, merge_threshold=5.0,
               corpus_max_tokens=1024, freq_table_size=1024, queue_size=128,
               use_dense_channel=False, use_hierarchical=False,
               use_compression_aware=False, use_adaptive_curvature=True,
               optimize_curvature_freq=7, alpha=0.05, beta=0.9, gamma=0.05,
               merge_batch=4, merge_policy="priority")
    cfg.update(kw)
    tok = EnhancedHyperbolicTokenizer(vocab, emb, device=device, **cfg)
    tok.sampler = NumpySampler(0, device)
    return tok


def assert_segments_match(sk, sp):
    a, b = E.state_scalars(sk), E.state_scalars(sp)
    assert a == b
    for x, y in [(sk.base.merges, sp.base.merges),
                 (sk.base.lengths, sp.base.lengths),
                 (sk.token_hash, sp.token_hash),
                 (sk.byte_lengths, sp.byte_lengths),
                 (sk.has_vowel, sp.has_vowel), (sk.q_score, sp.q_score),
                 (sk.base.threshold, sp.base.threshold),
                 (sk.base.merge_dists, sp.base.merge_dists)]:
        assert torch.equal(x, y)
    torch.testing.assert_close(sk.base.emb, sp.base.emb, rtol=0, atol=1e-5)


def test_kernel_builds(cuda):
    _build.build_all()
    assert _build.load(K1.SOURCE).enhanced_loop_launch is not None
    assert _build.load(K1.SOURCE).enhanced_loop_dense_launch is not None
    assert _build.load(K3.SOURCE).pairwise_min_best_launch is not None


@pytest.mark.parametrize("kw", [
    {}, dict(merge_batch=1), dict(merge_batch=32, queue_size=256),
    dict(use_hierarchical=True, use_compression_aware=True),
    dict(max_vocab_size=60)])
def test_segment_matches_plain(cuda, kw):
    """One segment from a synced state: kernel == plain, both on the card.
    No curvature events (a real segment halts at each; here it runs
    until the queue drains)."""
    tok = small_tokenizer(cuda, use_adaptive_curvature=False, **kw)
    cfg = tok.enh_config
    st0 = E.sync_corpus(tok.enh_state, cfg, tok.sampler)
    budgets = (10_000, 10_000, K1.NO_CURVATURE_STOP)
    before = K1.launches
    sk = K1.run_segment_cuda(E.clone_state(st0), cfg, *budgets)
    assert K1.launches == before + 1
    sp = K1.run_segment_plain(E.clone_state(st0), cfg, *budgets, None)
    assert int(sk.base.num_merges) > 0
    assert_segments_match(sk, sp)


def test_training_matches_cpu(cuda):
    """Whole chunks (syncs, curvature events, resyncs, relaunches) on the
    card equal the same chunks on the CPU's plain path."""
    tc = small_tokenizer(cuda)
    th = small_tokenizer("cpu")
    K1.reset_launches()
    tc.optimize_merges(steps=72, log_every=24)
    assert K1.launches > 0
    th.optimize_merges(steps=72, log_every=24)
    assert tc.merge_history == th.merge_history
    assert [s["chunk_syncs"] for s in tc.training_stats] == \
        [s["chunk_syncs"] for s in th.training_stats]
    torch.testing.assert_close(tc.enh_state.base.emb.cpu(),
                               th.enh_state.base.emb, rtol=0, atol=2e-4)


def test_wrapper_checks_inputs(cuda):
    tok = small_tokenizer(cuda, merge_batch=33)
    with pytest.raises(ValueError, match="merge_batch"):
        K1.run_segment_cuda(tok.enh_state, tok.enh_config, 10, 10, 10)


# Sizes that cross the 64-row tile edges and the diagonal tile.
@pytest.mark.parametrize("max_v,vocab,d1", [
    (64, 1, 8), (64, 63, 8), (130, 64, 8), (130, 65, 101), (300, 257, 101),
    (520, 520, 128)])
def test_k3_matches_plain(cuda, max_v, vocab, d1):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(max_v + vocab)
    emb = torch.zeros((max_v, d1))
    emb[:vocab] = L.random_points(gen, vocab, d1 - 1, sigma=0.5,
                                  device="cpu")
    c = torch.tensor(1.3)
    bd0, bj0 = K3.pairwise_min_best_plain(emb.to(cuda), vocab, c.to(cuda))
    before = K3.launches
    bd, bj = K3.pairwise_min_best(emb.to(cuda), vocab, c.to(cuda))
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    assert_same_best(emb.numpy(), 1.3, bd.cpu().numpy(), bj.cpu().numpy(),
                     bd0.cpu().numpy(), bj0.cpu().numpy())
    assert not torch.isfinite(bd[vocab - 1:]).any()
    assert (bj[vocab - 1:] == 0).all()


def dense_tokenizer(device, **kw):
    """tests/test_torch_dense.py's all-features configuration."""
    cfg = dict(use_dense_channel=True, use_hierarchical=True,
               use_adaptive_curvature=True, use_compression_aware=True,
               alpha=0.4, beta=0.4, gamma=0.2, optimize_curvature_freq=7,
               merge_batch=3, merge_threshold=0.4, merge_policy="fixpoint")
    cfg.update(kw)
    tok = small_tokenizer(device, **cfg)
    tok.enh_config = dataclasses.replace(tok.enh_config, phase2_step=6,
                                         phase3_step=14)
    return tok


K2_CASES = [
    {}, dict(merge_batch=16), dict(merge_batch=31), dict(max_token_len=4),
    dict(corpus_sample=None, use_frequency_aware=False,
         use_hierarchical=False, use_compression_aware=False,
         use_adaptive_curvature=False, merge_batch=2,
         merge_threshold=5.0)]
K2_IDS = ["all-features", "batch16", "batch31", "length-gate", "dense-only"]


@pytest.mark.parametrize("kw", K2_CASES, ids=K2_IDS)
def test_k2_step_lockstep_with_plain(cuda, kw):
    """K2 against its plain version on the card, one launch of one step at
    a time from the plain version's state: merges, rows, features and the
    candidate fold."""
    tok = dense_tokenizer(cuda, **kw)
    assert K1.uses_dense(tok.enh_config)
    out = {}
    K1.reset_launches()
    selfcheck._lockstep_steps(tok, 4, out, "k2")
    assert out["k2"] == "pass", out
    assert out["k2_merges"] >= 16
    assert K1.dense_launches == out["k2_steps"] and K1.launches == 0


@pytest.mark.parametrize("kw", K2_CASES, ids=K2_IDS)
def test_k2_chunk_lockstep_with_plain(cuda, kw):
    """K2 against its plain version chunk by chunk, the JAX package's
    protocol, at these small widths."""
    tok = dense_tokenizer(cuda, **kw)
    out = {}
    K1.reset_launches()
    selfcheck._lockstep_enhanced(tok, 4, 8, out, "k2")
    assert out["k2"] == "pass", out
    assert out["k2_merges"] >= 16
    assert K1.dense_launches > 0 and K1.launches == 0


def test_k2_training_on_the_card(cuda):
    """The all-features tokenizer trains on the card through K3 (in the
    constructor) and K2."""
    K3.reset_launches()
    tok = dense_tokenizer(cuda)
    assert K3.launches == 1
    K1.reset_launches()
    tok.optimize_merges(steps=24, log_every=8,
                        phase_transition_steps={2: 6, 3: 14})
    assert K1.dense_launches > 0 and K1.launches == 0
    assert len(tok.merge_history) >= 24
    assert tok.current_phase == 3
    v = int(tok.state.vocab_size)
    assert bool(torch.isfinite(tok.state.emb[:v]).all())
