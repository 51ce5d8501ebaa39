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
ties within 1e-5. Kernel K4 (ops/cuda/csrc/merge_loop.cu) is held to
``state.run_merges_plain`` chunk by chunk at d=8
(``selfcheck._check_base_kernel``) and step by step at d=100 and wider
(``selfcheck._lockstep_base_steps``), with all, part or none of its rows
in shared memory. K1/K2 also run ``merge_batch`` 64, K2 a state padded to
8192 active rows, and K2/K3 wide states (d+1 = 129, 301 and more). K2
also reads a hash-partitioned pair table (``n_buckets = 4``, the v3
sharded sync's layout), step by step against its plain version. The K2
and K4 wrappers refuse CPU and non-contiguous tensors. The replay's
selection kernel (ops/cuda/csrc/replay_select.cu) is held to
``scoring.parity_take_plain`` and ``matching_round_plain`` exactly, at
lengths around its tile and at the flagship's 2.9M slots, and the rank and
fixpoint replays of a real merge window on the card to the CPU's. The
sync's scoring kernel S1 (ops/cuda/csrc/sync_score.cu) is held to
``enhanced_state.score_candidates_plain`` on the same card tensors:
candidate masks and sentinel distances exact, distances and scores within
``evals/selfcheck.score_tolerance`` (the pair's gram summed in two orders,
carried through the acosh, the midpoint's float32 coefficients and the
sigmoid: about 5e-6 on a score), at the flagship's table size, ragged
lengths around its 64-row tile, d+1 = 9 to 301, with and without each
feature; and a sync on the card to the same state's sync on the CPU,
queue entry for entry up to near-ties within that tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hyptokenizer_tpu_torch.evals import selfcheck
from hyptokenizer_tpu_torch.ops import lorentz as L
from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K1
from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4
from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3
from hyptokenizer_tpu_torch.ops.cuda import replay_select as RS
from hyptokenizer_tpu_torch.ops.cuda import sync_score as S1
from hyptokenizer_tpu_torch.tokenizer import (
    WORDS_WITH_SPACE, EnhancedHyperbolicTokenizer, HyperbolicTokenizer)
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from hyptokenizer_tpu_torch.tokenizer import scoring as SC
from hyptokenizer_tpu_torch.tokenizer import state as S
from hyptokenizer_tpu_torch.utils import data, metrics
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

    def stats(self, sample_size, n):
        return self._draw((sample_size,), n), self._draw((sample_size,), n - 1)


def small_tokenizer(device, d=8, sigma=0.6, n_extra=0, **kw):
    """The corpus's characters (and ``n_extra`` tokens the corpus never
    uses, for queues filled by hand) at random points."""
    chars = sorted({ch for line in CORPUS for ch in line})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars + \
        [f"x{i}" for i in range(n_extra)]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    emb = L.random_points(gen, len(vocab), d, sigma=sigma, device="cpu")
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
    assert _build.load(K4.SOURCE).merge_loop_launch is not None
    assert _build.load(RS.SOURCE).replay_select_round_launch is not None
    assert _build.load(S1.SOURCE).sync_score_launch is not None


@pytest.mark.parametrize("kw", [
    {}, dict(merge_batch=1), dict(merge_batch=32, queue_size=256),
    dict(merge_batch=64, queue_size=256),
    dict(use_hierarchical=True, use_compression_aware=True),
    dict(max_vocab_size=60)])
def test_segment_matches_plain(cuda, kw):
    """One segment from a synced state: kernel == plain, both on the card.
    No curvature events (a real segment halts at each; here it runs
    until the queue drains)."""
    tok = small_tokenizer(cuda, use_adaptive_curvature=False, **kw)
    cfg = tok.enh_config
    st0 = E.sync_corpus(tok.enh_state, cfg, tok.sampler)
    budgets = (10_000, 10_000, E.NO_CURVATURE_STOP)
    before = K1.launches
    sk = K1.run_segment_cuda(E.clone_state(st0), cfg, *budgets)
    assert K1.launches == before + 1
    sp = E.run_segment_plain(E.clone_state(st0), cfg, *budgets, None,
                             K1.SEGMENT_STEPS)
    assert int(sk.base.num_merges) > 0
    assert_segments_match(sk, sp)


# K1's shared-memory plans (enhanced_loop.smem_plan): all three phase
# queues resident, one or two of them, none; batches of 1 and 8192; and a
# phase switch inside the segment with the later phases resident or global.
K1_PLAN_CASES = {
    "resident-256": (dict(queue_size=256), 3),
    "resident-4096": (dict(queue_size=4096, freq_table_size=4096), 3),
    "partial-batch2048": (dict(queue_size=4096, freq_table_size=4096,
                               merge_batch=2048), 2),
    "partial-8192": (dict(queue_size=8192, freq_table_size=8192), 1),
    "global-16384": (dict(queue_size=16384, freq_table_size=16384), 0),
    "batch1": (dict(queue_size=4096, freq_table_size=4096, merge_batch=1),
               3),
    "batch8192": (dict(merge_batch=8192), 0),
    "phases-resident": (dict(use_hierarchical=True,
                             use_compression_aware=True), 3),
    "phases-partial": (dict(queue_size=8192, freq_table_size=8192,
                            use_hierarchical=True,
                            use_compression_aware=True), 1),
    "phases-batch1024": (dict(queue_size=4096, freq_table_size=4096,
                              merge_batch=1024, use_hierarchical=True,
                              use_compression_aware=True), 2),
}


@pytest.mark.parametrize("case", list(K1_PLAN_CASES))
def test_k1_queue_plans_match_plain(cuda, case):
    """One K1 segment against its plain version with all, part or none of
    the phase queues in shared memory; the hierarchical cases switch phase
    twice inside the segment."""
    kw, resident = K1_PLAN_CASES[case]
    tok = small_tokenizer(cuda, use_adaptive_curvature=False, **kw)
    cfg = tok.enh_config
    if cfg.use_hierarchical:
        cfg = dataclasses.replace(cfg, phase2_step=6, phase3_step=14)
    assert K1.smem_plan(cfg.queue_size, cfg.merge_batch).resident == resident
    st0 = E.sync_corpus(tok.enh_state, cfg, tok.sampler)
    budgets = (10_000, 10_000, E.NO_CURVATURE_STOP)
    sk = K1.run_segment_cuda(E.clone_state(st0), cfg, *budgets)
    sp = E.run_segment_plain(E.clone_state(st0), cfg, *budgets, None,
                             K1.SEGMENT_STEPS)
    assert int(sk.base.num_merges) >= 16
    if cfg.use_hierarchical:
        assert int(sp.phase) == 3 and int(st0.phase) == 1
    assert_segments_match(sk, sp)


@pytest.mark.parametrize("kw", [{}, dict(use_hierarchical=True,
                                         use_compression_aware=True)])
def test_k1_duplicate_queue_pairs_match_plain(cuda, kw):
    """A queue holding one pair twice (entry 1 a copy of entry 0, in every
    phase): K1 finds the duplicate when it indexes the launch phase and
    consumes both copies, as the plain version does."""
    tok = small_tokenizer(cuda, use_adaptive_curvature=False, **kw)
    cfg = tok.enh_config
    st0 = E.sync_corpus(tok.enh_state, cfg, tok.sampler)
    for q in (st0.q_i, st0.q_j, st0.q_dist, st0.q_score):
        q[:, 1] = q[:, 0]
    budgets = (10_000, 10_000, E.NO_CURVATURE_STOP)
    sk = K1.run_segment_cuda(E.clone_state(st0), cfg, *budgets)
    sp = E.run_segment_plain(E.clone_state(st0), cfg, *budgets, None,
                             K1.SEGMENT_STEPS)
    assert int(sk.base.num_merges) >= 16
    assert_segments_match(sk, sp)


def test_k1_copy_dead_in_one_phase_matches_plain(cuda):
    """Entry 1 a copy of entry 0 in every phase, but dead in the launch
    phase alone: the phases' pairs agree entry for entry while their live
    entries do not, and the copy left live in the other two phases is
    consumed with entry 0, as the plain version does."""
    tok = small_tokenizer(cuda, use_adaptive_curvature=False)
    cfg = tok.enh_config
    st0 = E.sync_corpus(tok.enh_state, cfg, tok.sampler)
    for q in (st0.q_i, st0.q_j, st0.q_dist, st0.q_score):
        q[:, 1] = q[:, 0]
    st0.q_score[0, 1] = -float("inf")
    budgets = (10_000, 10_000, E.NO_CURVATURE_STOP)
    sk = K1.run_segment_cuda(E.clone_state(st0), cfg, *budgets)
    sp = E.run_segment_plain(E.clone_state(st0), cfg, *budgets, None,
                             K1.SEGMENT_STEPS)
    assert int(sk.base.num_merges) >= 16
    assert_segments_match(sk, sp)


@pytest.mark.parametrize("dup", [False, True])
def test_k1_large_batches_match_plain(cuda, dup):
    """Batches of 1024 merges from queues of 4096 distinct pairs filled by
    hand, each phase a permutation of the others, with the phase switching
    twice inside the segment (and, with ``dup``, entry 1 of every phase a
    copy of entry 0): every applied pair, of any rank, is consumed in all
    three phases, as the plain version does."""
    tok = small_tokenizer(cuda, n_extra=96, use_adaptive_curvature=False,
                          max_vocab_size=4096, queue_size=4096,
                          freq_table_size=4096, merge_batch=1024,
                          use_hierarchical=True, use_compression_aware=True)
    cfg = dataclasses.replace(tok.enh_config, phase2_step=1000,
                              phase3_step=2500)
    st0 = E.sync_corpus(tok.enh_state, cfg, tok.sampler)
    v0, k = int(st0.base.vocab_size), cfg.queue_size
    rng = np.random.default_rng(3)
    flat = rng.choice(v0 * v0, size=k, replace=False)
    thr = min(cfg.phase_thresholds)
    for ph in range(3):
        pairs = flat[rng.permutation(k)]
        score = np.sort(rng.uniform(0.0, 1.0, k))[::-1].copy()
        score[rng.random(k) < 0.1] = -np.inf
        st0.q_i[ph] = torch.from_numpy((pairs // v0).astype(np.int32))
        st0.q_j[ph] = torch.from_numpy((pairs % v0).astype(np.int32))
        st0.q_dist[ph] = torch.from_numpy(
            rng.uniform(0.0, 0.8 * thr, k).astype(np.float32))
        st0.q_score[ph] = torch.from_numpy(score.astype(np.float32))
    if dup:
        for q in (st0.q_i, st0.q_j, st0.q_dist, st0.q_score):
            q[:, 1] = q[:, 0]
    budgets = (10_000, 10_000, E.NO_CURVATURE_STOP)
    sk = K1.run_segment_cuda(E.clone_state(st0), cfg, *budgets)
    sp = E.run_segment_plain(E.clone_state(st0), cfg, *budgets, None,
                             K1.SEGMENT_STEPS)
    assert int(sp.base.num_merges) > 3 * 1024
    assert int(sp.phase) == 3 and int(st0.phase) == 1
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
    tok = small_tokenizer(cuda, merge_batch=K1.MAX_BATCH + 1)
    with pytest.raises(ValueError, match="merge_batch"):
        K1.run_segment_cuda(tok.enh_state, tok.enh_config, 10, 10, 10)


# Sizes that cross the 64-row tile edges and the diagonal tile, the
# tensor-core path's 128-row tiles, 64-column tiles and depth padding
# (d+1 = 8, 9, 101 -> 104, 112), many work items (2000 rows), and the FFMA
# kernel past the tensor-core depth (d+1 = 128, 129, 301).
@pytest.mark.parametrize("max_v,vocab,d1", [
    (64, 1, 8), (64, 63, 8), (130, 64, 8), (130, 65, 101), (300, 257, 101),
    (520, 520, 128), (300, 257, 129), (520, 300, 301), (127, 127, 8),
    (128, 128, 9), (129, 129, 101), (257, 257, 101), (300, 129, 9),
    (400, 383, 112), (2048, 2000, 101)])
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
    samples = cfg.pop("coherence_samples", None)
    tok = small_tokenizer(device, **cfg)
    tok.enh_config = dataclasses.replace(tok.enh_config, phase2_step=6,
                                         phase3_step=14)
    if samples is not None:    # the next sync draws this many
        tok.enh_config = dataclasses.replace(tok.enh_config,
                                             coherence_samples=samples)
    return tok


K2_CASES = [
    {}, dict(merge_batch=16), dict(merge_batch=31), dict(max_token_len=4),
    dict(corpus_sample=None, use_frequency_aware=False,
         use_hierarchical=False, use_compression_aware=False,
         use_adaptive_curvature=False, merge_batch=2,
         merge_threshold=5.0),
    dict(merge_batch=32), dict(merge_batch=64), dict(d=128), dict(d=300),
    dict(coherence_samples=600),
    # Points close enough for dense candidates under the threshold, so the
    # coherence midpoint is staged in slabs; the fold's new rows outgrow
    # the staging buffer and are staged in slabs too.
    dict(d=300, sigma=0.003, merge_batch=64), dict(d=1100, sigma=0.0015)]
K2_IDS = ["all-features", "batch16", "batch31", "length-gate", "dense-only",
          "batch32", "batch64", "d1-129", "d1-301", "samples600",
          "d1-301-close-batch64", "d1-1101-close"]


@pytest.mark.parametrize("kw", K2_CASES, ids=K2_IDS)
def test_k2_step_lockstep_with_plain(cuda, kw):
    """K2 against its plain version on the card, one launch of one step at
    a time from the plain version's state: merges, rows, features and the
    candidate fold."""
    tok = dense_tokenizer(cuda, **kw)
    assert tok.enh_config.uses_dense
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


def hashed_sync(d):
    """The corpus sync with its table laid out as the v3 sharded sync lays
    it out for ``d`` ranks (``parallel.sharded.hash_partition_table``)."""
    from hyptokenizer_tpu_torch.parallel.sharded import hash_partition_table

    def sync(st, cfg, sampler):
        st = E.sync_corpus(st, cfg, sampler)
        keys, counts = hash_partition_table(st.pair_keys, st.pair_counts, d)
        return dataclasses.replace(st, pair_keys=keys, pair_counts=counts)
    return sync


@pytest.mark.parametrize("kw", [{}, dict(merge_batch=16)],
                         ids=["all-features", "batch16"])
def test_k2_hashed_lookup_matches_plain(cuda, kw):
    """K2 with ``n_buckets = 4`` (``pair_table_hashed``) reading a table
    in the v3 layout for 4 ranks, against its plain version step by step:
    the lookup searches the pair's owner slice in both."""
    import types
    tok = dense_tokenizer(cuda, **kw)
    holder = types.SimpleNamespace(
        enh_state=tok.enh_state,
        enh_config=dataclasses.replace(tok.enh_config, pair_table_hashed=4))
    out = {}
    K1.reset_launches()
    selfcheck._lockstep_steps(holder, 4, out, "k2h", sync=hashed_sync(4))
    assert out["k2h"] == "pass", out
    assert out["k2h_merges"] >= 16
    assert K1.dense_launches == out["k2h_steps"] and K1.launches == 0


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


# Kernel K4: the distance-only loop.

K4_CHUNK_CASES = {
    "adaptive": dict(n0=64, max_v=256, threshold=2.5),
    "unaligned": dict(n0=40, max_v=200, threshold=50.0),
    "non-adaptive": dict(n0=64, max_v=256, threshold=1e-6,
                         adaptive_threshold=False),
    "empty-growth": dict(n0=64, max_v=256, threshold=1e-6),
    "capacity": dict(n0=40, max_v=128, threshold=50.0),
    "length-gate": dict(n0=64, max_v=256, threshold=5.0, max_token_len=5,
                        lengths=torch.arange(64, dtype=torch.int32) % 3 + 1),
}


@pytest.mark.parametrize("case", list(K4_CHUNK_CASES))
def test_k4_chunk_lockstep_with_plain(cuda, case):
    """K4 against ``run_merges_plain`` at d=8 by the JAX package's chunk
    protocol (``selfcheck._check_base_kernel``), on the card."""
    st, cfg = selfcheck.base_state(cuda, d=7, **K4_CHUNK_CASES[case])
    out = {}
    K4.reset_launches()
    selfcheck._check_base_kernel(out, st, cfg, n_chunks=8, chunk=20)
    assert out["kernel_selfcheck"] == "pass", out
    assert K4.launches > 0
    if case in ("unaligned", "capacity"):
        assert out["kernel_selfcheck_merges"] == cfg.max_vocab_size - \
            int(st.vocab_size)
    elif case in ("non-adaptive", "empty-growth"):
        assert out["kernel_selfcheck_merges"] == 0
    else:
        assert out["kernel_selfcheck_merges"] >= 40


@pytest.mark.parametrize("d1", [101, 129, 301, 10_001])
def test_k4_step_lockstep_with_plain(cuda, d1):
    """K4 against ``run_merges_plain`` one launch of one step at a time, at
    the flagship's d=100 and wider states (d+1 = 10,001 keeps the new row
    in global memory, past the kernel's shared-memory row): scalars,
    merged pair, new row, merge distance and the fold."""
    sigma = 0.5 if d1 < 1000 else 0.02     # points within float32 range
    st, cfg = selfcheck.base_state(cuda, n0=512, d=d1 - 1, max_v=1024,
                                   threshold=50.0, sigma=sigma)
    out = {}
    K4.reset_launches()
    selfcheck._lockstep_base_steps(st, cfg, 60, out, "k4")
    assert out["k4"] == "pass", out
    assert out["k4_steps"] == 60 and K4.launches == 60
    assert out["k4_merges"] == 60


# K4's shared-memory plans at 50,176 slots: every owned row resident
# (d+1 = 101), part of them (d+1 = 301, prefix past the resident chunks),
# none (d+1 = 10,001; rows and the new row in global memory).
K4_RESIDENT_CASES = {
    "full": dict(n0=40_960, d=100, max_v=50_176, sigma=0.5),
    "partial": dict(n0=24_576, d=300, max_v=50_176, sigma=0.5),
    "global": dict(n0=512, d=10_000, max_v=1024, sigma=0.02),
}


@pytest.mark.parametrize("case", list(K4_RESIDENT_CASES))
def test_k4_step_lockstep_resident(cuda, case):
    """K4 against ``run_merges_plain`` one launch of one step at a time over
    100 steps, with all, part or none of each block's rows in shared
    memory (``merge_loop.smem_plan``)."""
    kw = K4_RESIDENT_CASES[case]
    st, cfg = selfcheck.base_state(cuda, threshold=50.0, **kw)
    plan = K4.smem_plan(kw["max_v"], kw["d"] + 1, K4.grid_size(cuda))
    want = {"full": plan.resident == plan.owned,
            "partial": 0 < plan.resident < plan.owned,
            "global": plan.resident == 0 and plan.row_floats == 0}
    assert want[case], plan
    out = {}
    K4.reset_launches()
    selfcheck._lockstep_base_steps(st, cfg, 100, out, "k4")
    assert out["k4"] == "pass", out
    assert out["k4_steps"] == 100 and K4.launches == 100
    assert out["k4_merges"] == 100


# (d, padded rows): the grid's fold with tens of rows on every block, and
# with a few rows on each.
K2_DEEP_CASES = [(8, 8192), (100, 8192), (8, 500)]


@pytest.mark.parametrize("d,rows", K2_DEEP_CASES)
def test_k2_step_lockstep_deep(cuda, d, rows):
    """K2 against its plain version step by step from an all-features
    state padded to ``rows`` active rows (``selfcheck.pad_dense_state``)."""
    tok = dense_tokenizer(cuda, d=d, max_vocab_size=10_240)
    tok.enh_state = selfcheck.pad_dense_state(tok.enh_state, rows)
    out = {}
    K1.reset_launches()
    selfcheck._lockstep_steps(tok, 2, out, "k2")
    assert out["k2"] == "pass", out
    assert out["k2_merges"] >= 8
    assert K1.dense_launches == out["k2_steps"] and K1.launches == 0


def test_k2_chunk_lockstep_padded(cuda):
    """K2 against its plain version chunk by chunk from 500 active rows:
    launches of many steps, each merging step a fold event that every
    block must finish before the next step's candidate."""
    tok = dense_tokenizer(cuda, max_vocab_size=2048, merge_batch=8)
    tok.enh_state = selfcheck.pad_dense_state(tok.enh_state, 500)
    out = {}
    K1.reset_launches()
    selfcheck._lockstep_enhanced(tok, 4, 8, out, "k2")
    assert out["k2"] == "pass", out
    assert out["k2_merges"] >= 16
    assert K1.dense_launches > 0 and K1.launches == 0


def test_k2_k4_wrappers_refuse_bad_tensors(cuda):
    """The K2 and K4 wrappers raise, never fall back, on a CPU state or a
    non-contiguous buffer."""
    st, cfg = selfcheck.base_state(cuda, n0=64, d=7, max_v=256)
    bad = dataclasses.replace(st, emb=st.emb.t().contiguous().t())
    assert not bad.emb.is_contiguous()
    for state in (bad, selfcheck.base_state("cpu", n0=64, d=7,
                                            max_v=256)[0]):
        with pytest.raises(ValueError):
            K4.run_merges_chunk(state, cfg, 4)
    tok = dense_tokenizer(cuda)
    cfg = tok.enh_config
    st = tok.enh_state
    bad = dataclasses.replace(st, base=dataclasses.replace(
        st.base, emb=st.base.emb.t().contiguous().t()))
    for state in (bad, E.clone_state(dense_tokenizer("cpu").enh_state)):
        with pytest.raises(ValueError):
            K1.run_segment_cuda(state, cfg, 10, 10, 10)


def test_k4_loop_scalars_match_plain(cuda):
    """Non-adaptive stop, empty-round growth and the periodic growth, over
    one launch each: the loop scalars equal the plain version's."""
    for kw in (dict(threshold=1e-6, adaptive_threshold=False),
               dict(threshold=1e-6), dict(threshold=0.9,
                                          threshold_growth_every=7)):
        st, cfg = selfcheck.base_state(cuda, n0=64, d=7, max_v=256, **kw)
        sk = S.run_merges(selfcheck.clone_merge_state(st), cfg, 50)
        sp = S.run_merges_plain(selfcheck.clone_merge_state(st), cfg, 50)
        for f in selfcheck.BASE_SCALARS:
            assert getattr(sk, f).item() == getattr(sp, f).item(), (kw, f)


def test_k4_training_on_the_card(cuda):
    """The distance-only tokenizer trains on the card through K3 (in the
    constructor) and K4, and its merges equal the CPU's above the acosh
    clamp floor; it trains on after save/load."""
    import tempfile

    vocab = [chr(0x41 + k) for k in range(48)]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    emb = L.random_points(gen, len(vocab), 8, sigma=0.6, device="cpu")
    toks = []
    launches = []
    for dev in (cuda, "cpu"):
        K3.reset_launches()
        tok = HyperbolicTokenizer(vocab, emb, merge_threshold=5.0,
                                  max_vocab_size=256, device=dev)
        tok.stats_sampler = NumpySampler(0, dev)
        K4.reset_launches()
        tok.optimize_merges(80, log_every=20)
        toks.append(tok)
        launches.append((K3.launches, K4.launches))
    tc, th = toks
    assert launches == [(1, 4), (0, 0)]   # the CPU runs the plain versions
    dists = th.state.merge_dists[:len(th.merge_history)]
    n = next((k for k, x in enumerate(dists.tolist()) if x <= 1e-3),
             len(th.merge_history))
    assert n >= 5
    assert tc.merge_history[:n] == th.merge_history[:n]
    assert [s["step"] for s in tc.training_stats] == \
        [s["step"] for s in th.training_stats]
    with tempfile.TemporaryDirectory() as d:
        tc.save(d)
        back = HyperbolicTokenizer.load(d, device=cuda)
    assert back.encode("ABCABD") == tc.encode("ABCABD")
    K4.reset_launches()
    back.optimize_merges(20, log_every=20)
    assert K4.launches == 1
    v = int(back.state.vocab_size)
    assert v == len(back.vocab)
    assert bool(torch.isfinite(back.state.emb[:v]).all())


def test_grams_stay_fp32_after_high_precision(cuda):
    """``torch.set_float32_matmul_precision("high")`` turns TF32 on for
    cuBLAS; the port's grams still run in full float32 and leave the
    setting as they found it."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    x = L.random_points(gen, 256, 100, sigma=0.5, device="cpu")
    ref = L.pairwise_minkowski_dot(x.double(), x.double())
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        g = L.pairwise_minkowski_dot(x.to(cuda), x.to(cuda)).double().cpu()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    bound = selfcheck.gram_error_bound(
        x.double(), torch.arange(256)[:, None], torch.arange(256)[None, :],
        101) / 2
    assert bool(((g - ref).abs() <= bound).all())


def test_kernel_selfcheck_passes_on_the_card(cuda):
    """``evals/selfcheck.kernel_selfcheck``: K4, K1 and K2 (with K3 in its
    constructor) against their plain versions, every verdict "pass"."""
    out = selfcheck.kernel_selfcheck()
    assert selfcheck.selfcheck_failures(out) == {}, out
    assert out["kernel_selfcheck_merges"] > 0
    assert out["enhanced_kernel_selfcheck_merges"] > 0
    assert out["enhanced_full_selfcheck_merges"] > 0


def test_train_embeddings_on_the_card_matches_cpu(cuda):
    """``tokenizer/embed_train.train_embeddings`` on the card against the
    same run on the CPU, with the same draws (a CPU generator for both):
    rows within ``rtol=1e-4, atol=1e-5`` and the loss traces too (float32
    autograd; the card sums the gradient in another order), and a second
    card run equal to the bit."""
    from hyptokenizer_tpu_torch.tokenizer import embed_train as ET
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    emb0 = L.random_points(gen, 64, 16, sigma=0.5, device="cpu")
    corpus = torch.from_numpy(np.random.default_rng(1).integers(
        -2, 64, 2000).astype(np.int32))
    runs = [ET.train_embeddings(emb0.to(dev), corpus, 64,
                                ET.GeneratorSampler(5, "cpu"), steps=60,
                                batch=256, negatives=5)
            for dev in ("cpu", cuda, cuda)]
    (e_cpu, l_cpu), (e_gpu, l_gpu), (e_again, _) = runs
    assert torch.equal(e_gpu, e_again)  # reproducible on the card too
    assert e_gpu.device.type == "cuda"
    torch.testing.assert_close(e_gpu.cpu(), e_cpu, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------ replay selection

SELECT_N = [0, 1, RS.TILE - 1, RS.TILE, RS.TILE + 1, 2_900_000]
SELECT_KINDS = ["all_true", "all_false", "edges", "0.1", "0.5", "0.9"]
WIKI_SLOTS = 200_000
WIKI_ROUNDS = 6          # pair-table rounds that make the merge window
WIKI_PER_ROUND = 64


def select_mask(kind, n, seed):
    """A mask of ``kind``: constant, random at a density, or ``edges``:
    random at 0.3 with a run of True across every tile edge."""
    rng = np.random.default_rng(seed)
    if kind in ("all_true", "all_false"):
        return np.full(n, kind == "all_true")
    m = rng.random(n) < (0.3 if kind == "edges" else float(kind))
    if kind == "edges":
        for e in range(RS.TILE, n, RS.TILE):
            m[max(e - int(rng.integers(1, 40)), 0):
              e + int(rng.integers(1, 40))] = True
    return m


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("n", SELECT_N)
def test_replay_select_take_matches_plain(cuda, n, kind):
    m = torch.from_numpy(select_mask(kind, n, n))
    RS.reset_launches()
    got = RS.parity_take(m.to(cuda))
    assert RS.launches == 1
    want = SC.parity_take_plain(m)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(SC._parity_take(m.to(cuda)).cpu(), want)
    assert RS.launches == 2


@pytest.mark.parametrize("kind", SELECT_KINDS)
@pytest.mark.parametrize("n", SELECT_N)
def test_replay_select_round_matches_plain(cuda, n, kind):
    rng = np.random.default_rng(n + 1)
    alive = torch.from_numpy(select_mask(kind, n, n + 2))
    # Few ranks, so that neighbours tie often; one rank at 2^31 - 1, the
    # value of an entry that is not alive.
    pri = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    if n:
        pri[n // 2] = 2**31 - 1
    sel = torch.from_numpy(rng.random(n) < 0.1)
    sel_card = sel.to(cuda)
    RS.reset_launches()
    alive_card, flag = RS.matching_round(alive.to(cuda), pri.to(cuda),
                                         sel_card)
    assert RS.launches == 1
    want_alive, want_live = SC.matching_round_plain(alive, pri, sel)
    assert torch.equal(alive_card.cpu(), want_alive)
    assert torch.equal(sel_card.cpu(), sel)
    assert int(flag) == int(want_live)


def test_replay_select_refuses_bad_tensors(cuda):
    m = torch.ones(100, dtype=torch.bool, device=cuda)
    pri = torch.zeros(100, dtype=torch.int32, device=cuda)
    for bad in (m.cpu(), m[::2], m[1:], m.int(), m.reshape(10, 10)):
        with pytest.raises(ValueError):
            RS.parity_take(bad)
    sel = torch.zeros_like(m)
    for args in ((m.cpu(), pri.cpu(), sel.cpu()), (m, pri[:50], sel),
                 (m, pri.long(), sel), (m, pri, sel[::2])):
        with pytest.raises(ValueError):
            RS.matching_round(*args)


@pytest.fixture(scope="module")
def wiki_window():
    """The first WIKI_SLOTS slots of the frozen wiki corpus, and a merge
    window made as training makes one: rounds of the most frequent pairs
    of the replayed corpus, so that later rules take ids made earlier."""
    from hyptokenizer_tpu_torch import bench
    lines = bench.load_corpus()
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + sorted(
        {ch for ln in lines for ch in ln})
    corpus = torch.from_numpy(data.encode_corpus_chars(
        lines, vocab, WIKI_SLOTS, unk_id=3, sep_id=SC.SEP_ID,
        pad_id=SC.PAD_ID, pre_split=WORDS_WITH_SPACE))
    n_init = len(vocab)
    merges = torch.full((WIKI_ROUNDS * WIKI_PER_ROUND, 2), -1,
                        dtype=torch.int32)
    c = corpus
    for r in range(WIKI_ROUNDS):
        keys, counts, _, _ = SC.build_pair_table(c, 1 << 16)
        top = torch.topk(counts, WIKI_PER_ROUND).indices
        at = r * WIKI_PER_ROUND
        merges[at:at + WIKI_PER_ROUND] = keys[top]
        c = SC.batch_rank_replay(c, merges, at, WIKI_PER_ROUND, n_init)
    return corpus, merges, n_init


@pytest.mark.parametrize("policy", ["rank", "fixpoint"])
def test_replay_on_wiki_corpus_matches_cpu(cuda, wiki_window, policy):
    """The replay of a real window on the card equals the CPU's plain one
    exactly, in two syncs as training replays it; every selection went
    through the kernel (``replay.select_launches`` equals
    ``replay.match_rounds`` under a profiler)."""
    replay = (SC.batch_rank_replay if policy == "rank"
              else SC.batch_fixpoint_replay)
    corpus, merges, n_init = wiki_window
    half = merges.shape[0] // 2
    want = corpus
    got = corpus.to(cuda)
    RS.reset_launches()
    metrics.tracing()   # a look with none recording: a record of its own
    with torch.profiler.profile():
        for start in (0, half):
            want = replay(want, merges, start, half, n_init)
            got = replay(got, merges.to(cuda), start, half, n_init)
        torch.cuda.synchronize()
    counters = metrics.trace_snapshot()["counters"]
    assert torch.equal(got.cpu(), want)
    assert int((want >= n_init).sum()) > 1000   # the rules did apply
    assert RS.launches > 0
    # The counters add the CPU replay's rounds too, which launch nothing.
    assert counters["replay.select_launches"] == RS.launches
    assert counters["replay.match_rounds"] == 2 * RS.launches


# The sync's scoring, kernel S1.

SCORE_SMALL = dict(n_vocab=300, d=16, n_samples=50)
SCORE_CASES = {
    "flagship_size": dict(selfcheck.SCORE_TABLE),
    "one_row": dict(SCORE_SMALL, table_size=1, n_pairs=1),
    "tile_minus_one": dict(SCORE_SMALL, table_size=63, n_pairs=50),
    "one_tile": dict(SCORE_SMALL, table_size=64, n_pairs=64),
    "tile_plus_one": dict(SCORE_SMALL, table_size=65, n_pairs=60),
    "ragged": dict(SCORE_SMALL, table_size=4097, n_pairs=3000),
    "all_sentinel_tail": dict(SCORE_SMALL, table_size=1024, n_pairs=70),
    "no_samples": dict(SCORE_SMALL, table_size=1000, n_pairs=900,
                       n_samples=0),
    "more_samples_than_a_pass": dict(SCORE_SMALL, table_size=1000,
                                     n_pairs=900, n_samples=150),
    "d1_9": dict(SCORE_SMALL, d=8, table_size=2000, n_pairs=1800),
    "d1_301": dict(SCORE_SMALL, d=300, table_size=2000, n_pairs=1800),
    "curvature_one": dict(SCORE_SMALL, table_size=2000, n_pairs=1800,
                          curvature=1.0),
    "near_origin": dict(SCORE_SMALL, table_size=2000, n_pairs=1800,
                        sigma=0.01, curvature=0.7),
}
SCORE_CONFIGS = {
    "flagship": dict(use_frequency=True, alpha=0.05, beta=0.9, gamma=0.05),
    "distance_only": dict(),
    "compression": dict(use_compression=True),
    "curriculum": dict(use_hierarchical=True),
    "all_features": dict(use_frequency=True, use_compression=True,
                         compression_weight=0.7, use_hierarchical=True),
    "gated": dict(use_frequency=True, use_compression=True,
                  use_hierarchical=True, min_pair_freq=2,
                  base=S.MergeConfig(max_token_len=3)),
    "gated_no_curriculum": dict(use_frequency=True, min_pair_freq=2,
                                base=S.MergeConfig(max_token_len=0)),
}


def check_scores(config, inputs):
    """S1 against the plain version on the same card tensors; returns the
    comparison (``selfcheck.compare_scores``)."""
    S1.reset_launches()
    got = E.score_candidates(config, **inputs)
    assert S1.launches == 1
    want = E.score_candidates_plain(config, **inputs)
    tol = selfcheck.score_tolerance(config, inputs)
    cmp = selfcheck.compare_scores(got, want, tol, inputs["curvature"])
    assert cmp["masks_equal"], cmp
    assert cmp["dist_gap_over_tol"] <= 1.0, cmp
    assert cmp["score_gap_over_tol"] <= 1.0, cmp
    return cmp


@pytest.mark.parametrize("case", list(SCORE_CASES))
def test_sync_score_matches_plain(cuda, case):
    inputs = selfcheck.score_table_inputs(cuda, **SCORE_CASES[case])
    for name, kw in SCORE_CONFIGS.items():
        cmp = check_scores(E.EnhancedConfig(**kw), inputs)
        if name == "all_features" and case == "flagship_size":
            assert cmp["candidates"] > 50_000


def test_sync_score_self_pairs_and_samples_on_rows(cuda):
    """A table of self pairs (a, a) only, every sample one of the rows:
    each row's coherence leaves out the samples equal to it."""
    inputs = selfcheck.score_table_inputs(cuda, **dict(
        SCORE_SMALL, table_size=200, n_pairs=150))
    ids = torch.arange(150, device=cuda, dtype=torch.int32) * 2
    inputs["keys"][:150] = torch.stack([ids, ids], dim=-1)
    inputs["coh_samples"] = ids[:50].flip(0).contiguous()
    for kw in SCORE_CONFIGS.values():
        check_scores(E.EnhancedConfig(**kw), inputs)


def test_sync_score_refuses_mismatched_tensors(cuda):
    inputs = selfcheck.score_table_inputs(cuda, **dict(
        SCORE_SMALL, table_size=100, n_pairs=80))
    cfg = E.EnhancedConfig(use_frequency=True)
    for name, bad in (("counts", inputs["counts"][:50]),
                      ("lengths", inputs["lengths"][:-1]),
                      ("emb", inputs["emb"].t().contiguous().t()),
                      ("keys", inputs["keys"].long()),
                      ("threshold", inputs["threshold"].cpu())):
        with pytest.raises(ValueError, match=name):
            E.score_candidates(cfg, **dict(inputs, **{name: bad}))


def state_to(st, dev):
    """A copy of the enhanced state ``st`` on ``dev``."""
    return dataclasses.replace(
        st, base=dataclasses.replace(st.base, **{
            f.name: getattr(st.base, f.name).to(dev)
            for f in dataclasses.fields(st.base)}),
        **{f.name: getattr(st, f.name).to(dev)
           for f in dataclasses.fields(st) if f.name != "base"})


@pytest.mark.parametrize("kw", [
    {}, dict(use_hierarchical=True, use_compression_aware=True,
             use_dense_channel=True, min_pair_freq=2)])
def test_sync_on_the_card_matches_cpu(cuda, kw):
    """One sync of a trained state on the card (S1) and on the CPU (the
    plain version), with the same draws: the same pair table exactly, and
    queues equal entry for entry up to near-ties within
    ``selfcheck.score_tolerance``; ``sync.score_launches`` counts the one
    launch under a profiler."""
    tok = small_tokenizer("cpu", d=16, **kw)
    tok.optimize_merges(steps=40, log_every=40)
    st_cpu = tok.enh_state
    st_card = state_to(st_cpu, cuda)
    cfg = tok.enh_config
    want = E.sync_corpus(st_cpu, cfg, NumpySampler(3, "cpu"))
    S1.reset_launches()
    metrics.tracing()
    with torch.profiler.profile():
        got = E.sync_corpus(st_card, cfg, NumpySampler(3, cuda))
        torch.cuda.synchronize()
    assert metrics.trace_snapshot()["counters"]["sync.score_launches"] == 1
    assert S1.launches == 1
    for name in ("pair_keys", "pair_counts", "coh_samples", "corpus",
                 "max_pair_count", "corpus_tokens", "q_valid_total"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    inputs = selfcheck.state_score_inputs(want)
    _, tol = selfcheck.score_tolerance(cfg, inputs)
    cmp = selfcheck.compare_queues(
        (got.q_i.cpu(), got.q_j.cpu(), got.q_score.cpu()),
        (want.q_i, want.q_j, want.q_score), want.pair_keys, tol)
    assert cmp["ok"], cmp
    assert int((want.q_score > -np.inf).sum()) > 0
