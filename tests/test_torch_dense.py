"""The port's second slice, the dense channel, == the JAX package.

* ``state``: the dense ``init_state`` branch (kernel K3's plain version)
  and ``merge_batch``'s invalidation and column fold through the port's
  ``insert_batch``.
* The slice as a whole: the all-features configuration of
  tests/test_enhanced_loop_kernel.py (dense channel, frequency, coherence,
  compression, hierarchical phases, adaptive curvature), three chunks that
  cross both phase transitions and curvature events, with the JAX draws
  injected. The merge history must be EXACTLY equal to both the XLA loop
  (``_run_enhanced_xla``) and the Pallas kernel in interpret mode. The
  dense-only configuration (no corpus) is compared up to the acosh clamp
  floor, as there.
* Save and load in both directions, the candidate re-scan after load, and
  training continued after load.

Tolerances: merge histories, lengths and hashes exact; rows 2e-4 (float32
sums in another order, compounded down merge chains, as in
tests/test_enhanced_loop_kernel.py); curvature rtol 1e-5; candidate
distances 1e-5 with partners equal except at ties within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.ops.pallas import enhanced_loop as JK
from hyptokenizer_tpu.tokenizer import EnhancedHyperbolicTokenizer as JaxTok
from hyptokenizer_tpu.tokenizer import enhanced_state as JE
from hyptokenizer_tpu.tokenizer import state as JSt
from hyptokenizer_tpu_torch import convert
from hyptokenizer_tpu_torch.evals import selfcheck
from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as TK
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer as TorchTok
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as TE
from hyptokenizer_tpu_torch.tokenizer import state as TSt
from tests.test_torch_tokenizer import TEXTS
from tests.torch_port_checks import assert_same_best, np_points
from tests.torch_port_common import (
    CORPUS, ReplaySampler, history, make_pair)

# tests/test_enhanced_loop_kernel.py::test_kernel_matches_xla_all_features
ALL_FEATURES = dict(
    use_dense_channel=True, use_hierarchical=True,
    use_adaptive_curvature=True, use_compression_aware=True,
    use_frequency_aware=True, alpha=0.4, beta=0.4, gamma=0.2,
    optimize_curvature_freq=7, merge_batch=3, merge_threshold=0.4,
    merge_policy="fixpoint")
PHASES = dict(phase2_step=6, phase3_step=14)


def all_features_pair(**overrides):
    kw = dict(ALL_FEATURES)
    kw.update(overrides)
    jt, tt = make_pair(**kw)
    jt.enh_config = jt.enh_config.replace(**PHASES)
    tt.enh_config = dataclasses.replace(tt.enh_config, **PHASES)
    return jt, tt


# ------------------------------------------------------------------- state

def test_init_state_candidates():
    """The dense branch of init_state builds JAX's best_dist/best_j."""
    emb, lens = np_points(11, 57, 7, lengths_max=3)
    cfg_j = JSt.MergeConfig(max_vocab_size=80, search_block=16)
    cfg_t = TSt.MergeConfig(max_vocab_size=80, search_block=16)
    jst = JSt.init_state(emb, lens, curvature=1.7, config=cfg_j)
    tst = TSt.init_state(emb, lens, curvature=1.7, config=cfg_t,
                         device="cpu")
    full = np.zeros((80, 8), np.float32)
    full[:57] = emb
    assert_same_best(full, 1.7, tst.best_dist.numpy(), tst.best_j.numpy(),
                     jst.best_dist, jst.best_j)
    assert np.isfinite(tst.best_dist.numpy()[:56]).all()
    assert not np.isfinite(tst.best_dist.numpy()[56:]).any()


def test_insert_batch_fold_matches_merge_batch():
    """merge_batch's invalidation and batched column fold, through the
    port's insert_batch, on a batch that consumes a tracked best and whose
    new tokens cross the length gate."""
    emb, lens = np_points(5, 40, 7, lengths_max=3)
    max_tok = 5
    jst = JSt.init_state(emb, lens, curvature=1.2,
                         config=JSt.MergeConfig(max_vocab_size=64,
                                                search_block=16))
    bj0 = np.asarray(jst.best_j)
    # Row 3's tracked best is consumed; the other pairs are not.
    ii = np.array([3, 10, 21, 7], np.int32)
    jj = np.array([bj0[3], 11, 30, 25], np.int32)
    assert bj0[10] != 11 and bj0[21] != 30 and bj0[7] != 25
    dd = np.array([0.5, 0.6, 0.7, 0.8], np.float32)
    new_len = lens[ii] + lens[jj]
    assert (lens[:, None] + new_len[None, :] > max_tok).any()   # gated
    assert (lens[:, None] + new_len[None, :] <= max_tok).any()  # passes
    j2 = JSt.merge_batch(jst, jnp.asarray(ii), jnp.asarray(jj),
                         jnp.asarray(dd), jnp.ones((4,), bool), max_tok)
    tst = convert.merge_state_from_arrays(jax.tree.map(np.asarray, jst),
                                          device="cpu")
    t2 = TSt.insert_batch(tst, torch.from_numpy(ii).long(),
                          torch.from_numpy(jj).long(), torch.from_numpy(dd),
                          fold=True, max_token_len=max_tok)
    j = jax.tree.map(np.asarray, j2)
    t = convert.merge_state_to_arrays(t2)
    for name in ("lengths", "merges", "vocab_size", "num_merges",
                 "empty_rounds"):
        np.testing.assert_array_equal(t[name], getattr(j, name),
                                      err_msg=name)
    np.testing.assert_allclose(t["emb"], j.emb, atol=1e-6)
    np.testing.assert_array_equal(t["merge_dists"], j.merge_dists)
    assert_same_best(j.emb, 1.2, t["best_dist"], t["best_j"], j.best_dist,
                     j.best_j)
    assert (t["best_j"] >= 40).sum() > 0        # the fold claimed rows
    assert t["best_j"][3] != bj0[3]             # row 3 was invalidated


def test_merge_state_convert_roundtrip():
    emb, lens = np_points(2, 20, 5, lengths_max=2)
    jst = JSt.init_state(emb, lens, config=JSt.MergeConfig(
        max_vocab_size=32, search_block=8))
    t = convert.merge_state_from_arrays(jax.tree.map(np.asarray, jst),
                                        device="cpu")
    back = convert.merge_state_to_arrays(t)
    for name, x in back.items():
        y = np.asarray(getattr(jst, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


# ---------------------------------------------------------- the slice

def test_all_features_matches_xla_and_pallas():
    """Three chunks (one sync + segments each) of the all-features
    configuration: the port's history equals the XLA loop's and the
    Pallas kernel's (interpret mode) exactly."""
    jt, tt = all_features_pair()
    sampler = ReplaySampler(jt.enh_state.key)
    jx = jax.tree.map(jnp.array, jt.enh_state)
    jk = jax.tree.map(jnp.array, jt.enh_state)
    tst = tt.enh_state
    for _ in range(3):
        jx = JE._run_enhanced_xla(jx, jt.enh_config, 8)
        jk = JK.run_enhanced_fused(jk, jt.enh_config, 8, interpret=True,
                                   segment_grid=64)
        tst = TK.run_chunk(tst, tt.enh_config, 8, sampler)
        np.testing.assert_array_equal(history(tst), history(jx))
        np.testing.assert_array_equal(history(tst), history(jk))
    assert int(tst.base.num_merges) > 10
    assert int(tst.phase) == int(jx.phase) == 3  # both transitions crossed
    assert int(tst.curv_t) == int(jx.curv_t) >= 1
    assert float(tst.base.curvature) != pytest.approx(1.0)
    np.testing.assert_allclose(float(tst.base.curvature),
                               float(jx.base.curvature), rtol=1e-5)
    assert int(tst.base.step) == int(jx.base.step)
    np.testing.assert_allclose(float(tst.base.threshold),
                               float(jx.base.threshold), rtol=1e-6)
    v = int(tst.base.vocab_size)
    np.testing.assert_allclose(tst.base.emb[:v].numpy(),
                               np.asarray(jx.base.emb[:v]), atol=2e-4)
    np.testing.assert_array_equal(tst.base.lengths[:v].numpy(),
                                  np.asarray(jx.base.lengths[:v]))
    np.testing.assert_array_equal(tst.token_hash[:v].numpy(),
                                  np.asarray(jx.token_hash[:v]))
    bd = tst.base.best_dist.numpy()
    np.testing.assert_allclose(bd[np.isfinite(bd)], np.asarray(
        jx.base.best_dist)[np.isfinite(bd)], atol=1e-4)
    # Teeth: without the dense channel the same draws give other merges.
    _, tc = all_features_pair(use_dense_channel=False)
    sampler = ReplaySampler(jt.enh_state.key)
    sc = tc.enh_state
    for _ in range(3):
        sc = TK.run_chunk(sc, tc.enh_config, 8, sampler)
    assert not np.array_equal(history(sc), history(tst))


def test_length_gate_matches_xla():
    """A merged-token length cap that binds (max_token_len=4): the fold's
    structural gate and the dense candidate's backstop, against the XLA
    loop. Compared up to the first exact distance tie between two partners
    of one row (tokens that copy a point), where two float32 paths may
    keep either partner; it must be such a tie."""
    jt, tt = all_features_pair(max_token_len=4)
    sampler = ReplaySampler(jt.enh_state.key)
    jx = jax.tree.map(jnp.array, jt.enh_state)
    tst = tt.enh_state
    for _ in range(3):
        jx = JE._run_enhanced_xla(jx, jt.enh_config, 8)
        tst = TK.run_chunk(tst, tt.enh_config, 8, sampler)
    hj, ht = history(jx), history(tst)
    n = min(len(hj), len(ht))
    same = np.all(hj[:n] == ht[:n], axis=1)
    k = n if same.all() else int(np.argmin(same))
    assert k >= 20
    if k < n:
        (a, b), (a2, b2) = hj[k], ht[k]
        assert a == a2, (hj[k], ht[k])
        emb = np.asarray(jx.base.emb, np.float64)
        sig = np.r_[1.0, -np.ones(emb.shape[1] - 1)]
        g1, g2 = (float(np.sum(emb[a] * sig * emb[x])) for x in (b, b2))
        assert abs(g1 - g2) <= 1e-5 * max(1.0, abs(g1)), (g1, g2)
    v, n0 = int(tst.base.vocab_size), tt.enh_config.n_init
    lens = tst.base.lengths.numpy()
    assert int(lens[n0:v].max()) == 4          # merged tokens reach the cap
    # The initial pass is ungated, so overlong candidates remain for the
    # dense candidate's backstop to refuse.
    bd, bj = tst.base.best_dist.numpy(), tst.base.best_j.numpy()
    fin = np.isfinite(bd)
    assert (lens[fin] + lens[bj[fin]] > 4).any()


def test_dense_only_matches_xla_and_pallas():
    """No corpus at all: the pure geometric scored loop, compared up to the
    acosh clamp floor (where exact-tie distances let the paths pick
    different, equally minimal pairs)."""
    jt, tt = make_pair(
        corpus_sample=None, use_hierarchical=False,
        use_adaptive_curvature=False, use_compression_aware=False,
        use_frequency_aware=False, merge_batch=2, merge_policy="fixpoint")
    assert not tt.enh_config.needs_corpus
    sampler = ReplaySampler(jt.enh_state.key)
    jx = jax.tree.map(jnp.array, jt.enh_state)
    jk = jax.tree.map(jnp.array, jt.enh_state)
    tst = tt.enh_state
    for _ in range(2):
        jx = JE._run_enhanced_xla(jx, jt.enh_config, 12)
        jk = JK.run_enhanced_fused(jk, jt.enh_config, 12, interpret=True,
                                   segment_grid=64)
        tst = TK.run_chunk(tst, tt.enh_config, 12, sampler)
    nx = int(jx.base.num_merges)
    assert nx == int(tst.base.num_merges) == int(jk.base.num_merges) > 10
    assert int(tst.base.step) == int(jx.base.step)
    da = np.asarray(jx.base.merge_dists[:nx])
    below = np.nonzero(da <= 1e-3)[0]
    comparable = int(below[0]) if len(below) else nx
    assert comparable >= 5
    np.testing.assert_array_equal(history(tst)[:comparable],
                                  history(jx)[:comparable])
    np.testing.assert_array_equal(history(tst)[:comparable],
                                  history(jk)[:comparable])


def test_lockstep_protocol_on_the_plain_version():
    """evals/selfcheck's lockstep, kernel path against its plain oracle:
    on the CPU both are the plain version, so every chunk is clean; and
    the chunk classifier tells reorders, near-ties and failures apart."""
    _, tt = all_features_pair()
    out = {}
    selfcheck._lockstep_enhanced(tt, 3, 8, out, "dense")
    assert out["dense"] == "pass"
    assert out["dense_merges"] >= 16
    assert out["dense_reorders"] == out["dense_dist_ties"] == 0
    selfcheck._lockstep_steps(tt, 3, out, "steps")
    assert out["steps"] == "pass", out
    assert out["steps_merges"] >= 16 and out["steps_steps"] >= 3
    assert out["steps_row_err"] == out["steps_gram_gap_over_bound"] == 0

    # The candidate comparison catches a fold that is off.
    st = TE.sync_corpus(TE.clone_state(tt.enh_state), tt.enh_config,
                        ReplaySampler(jax.random.PRNGKey(0)))
    bad = TE.clone_state(st)
    fin = torch.isfinite(bad.base.best_dist)
    bad.base.best_dist[fin] *= 1.01
    stats = {}
    assert selfcheck._compare_candidates(st.base, st.base, stats)
    assert not selfcheck._compare_candidates(bad.base, st.base, stats)
    assert "candidate_row" in stats["first_bad"]
    # ... and rows that are off.
    emb = st.base.emb
    pairs = torch.tensor([[5, 9], [7, 20]], dtype=torch.int32)
    lens, c = st.base.lengths, st.base.curvature
    assert selfcheck._compare_rows(emb, emb, lens, pairs, 30, c,
                                   1e-5) == (0.0, 0.0)
    off = emb.clone()
    off[31, 3] += 1e-2
    err, ratio = selfcheck._compare_rows(off, emb, lens, pairs, 30, c, 1e-5)
    assert err == pytest.approx(1e-2, rel=1e-3) and ratio > 1.0

    m = np.array([[1, 2], [3, 4]])
    d = np.array([0.5, 0.6], np.float32)
    stats = {}
    assert selfcheck._compare_chunks(m[::-1], d[::-1], m, d, stats)
    assert stats["reorders"] == 1
    assert selfcheck._compare_chunks(np.array([[1, 2], [5, 6]]), d, m,
                                     d + np.float32(1e-7), stats)
    assert stats["dist_ties"] == 1
    assert not selfcheck._compare_chunks(np.array([[1, 2], [5, 6]]), d, m,
                                         d + np.float32(0.1), stats)
    assert stats["first_bad"]["pos"] == 1


# ------------------------------------------------------- save and load

@pytest.fixture(scope="module")
def trained():
    """Both packages trained alike (same draws) on the all-features
    configuration, across both phase transitions."""
    kw = dict(ALL_FEATURES)
    jt, tt = make_pair(**kw)
    tt.sampler = ReplaySampler(jt.enh_state.key)
    steps = dict(steps=24, log_every=8,
                 phase_transition_steps={2: 6, 3: 14})
    jt.optimize_merges(**steps)
    tt.optimize_merges(**steps)
    assert tt.merge_history == jt.merge_history
    assert tt.current_phase == jt.current_phase == 3
    return jt, tt


def test_save_load_both_ways(tmp_path, trained):
    jt, tt = trained
    tt.save(str(tmp_path / "port"))
    jt.save(str(tmp_path / "jax"))
    jb = JaxTok.load(str(tmp_path / "port"))
    tb = TorchTok.load(str(tmp_path / "jax"), device="cpu")
    assert jb.vocab == tb.vocab == tt.vocab
    assert jb.merge_history == tb.merge_history == tt.merge_history
    for text in TEXTS + CORPUS[:5]:
        assert jb.encode(text) == tb.encode(text) == tt.encode(text) \
            == jt.encode(text)
    assert tb.enh_config.use_dense_channel and tb.enh_config.frozen_freqs


def test_load_rescan_and_continue(tmp_path, trained):
    """A loaded all-features tokenizer re-scans its candidates as JAX's
    does, and both continue training alike."""
    jt, _ = trained
    jt.save(str(tmp_path))
    jb = JaxTok.load(str(tmp_path))
    tb = TorchTok.load(str(tmp_path), device="cpu")
    jbase, tbase = jb.enh_state.base, tb.enh_state.base
    assert int(tbase.vocab_size) == int(jbase.vocab_size)
    assert_same_best(np.asarray(jbase.emb), float(jbase.curvature),
                     tbase.best_dist.numpy(), tbase.best_j.numpy(),
                     jbase.best_dist, jbase.best_j)
    assert np.isfinite(tbase.best_dist.numpy()).sum() > 10
    tb.sampler = ReplaySampler(jb.enh_state.key)
    n = len(jb.merge_history)
    jb.optimize_merges(steps=16, log_every=8)
    tb.optimize_merges(steps=16, log_every=8)
    assert tb.merge_history == jb.merge_history
    assert len(tb.merge_history) > n
    assert tb.training_stats[-1]["step"] == jb.training_stats[-1]["step"]
