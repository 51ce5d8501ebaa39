"""Port enhanced-loop pieces (tokenizer/enhanced_state.py, state.py,
convert.py) == the JAX package's, from the same constructor inputs and
with the same random draws injected.

Tolerances: integer state (corpus, ids, hashes, lengths, pair keys and
counts, queue ids, merge history) exact; embedding rows 1e-6 absolute;
queue scores and curvature state 1e-5 (float32 sums in another order).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.tokenizer import enhanced_state as JE
from hyptokenizer_tpu.tokenizer import state as JSt
from hyptokenizer_tpu_torch import convert
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as TE
from hyptokenizer_tpu_torch.tokenizer import state as TSt
from tests.torch_port_common import ReplaySampler, history, make_pair

INT_FIELDS = ("corpus", "corpus_synced", "corpus_tokens", "pair_keys",
              "pair_counts", "max_pair_count", "pair_unique", "q_i", "q_j",
              "q_valid_total", "coh_samples", "token_hash", "byte_lengths",
              "has_vowel", "hash_powers", "morph_table", "morph_size",
              "word_table", "word_size", "phase", "needs_resync", "curv_t",
              "curv_last")


def assert_states_match(jst, tst, score_tol=1e-5):
    j = jax.tree.map(np.asarray, jst)
    t = convert.enhanced_state_to_arrays(tst)
    for name in INT_FIELDS:
        assert t[name].dtype == getattr(j, name).dtype, name
        np.testing.assert_array_equal(t[name], getattr(j, name),
                                      err_msg=name)
    for name in ("lengths", "merges", "best_j", "vocab_size", "num_merges",
                 "step", "empty_rounds", "stopped"):
        np.testing.assert_array_equal(t["base"][name],
                                      getattr(j.base, name), err_msg=name)
    np.testing.assert_allclose(t["base"]["emb"], j.base.emb, atol=1e-6)
    for name in ("q_dist", "q_score"):
        np.testing.assert_allclose(t[name], getattr(j, name),
                                   rtol=score_tol, atol=score_tol,
                                   err_msg=name)
    for name in ("threshold", "curvature"):
        np.testing.assert_allclose(t["base"][name], getattr(j.base, name),
                                   rtol=score_tol, err_msg=name)
    for name in ("curv_m", "curv_v"):
        np.testing.assert_allclose(t[name], getattr(j, name),
                                   rtol=score_tol, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("overrides", [
    {},
    dict(use_hierarchical=True, use_compression_aware=True),
    dict(merge_policy="fixpoint", corpus_shards=4),
], ids=["flagship", "all-corpus-features", "fixpoint-sharded"])
def test_constructor_buffers(overrides):
    """The assembled state equals the JAX package's (corpus, hashes and
    lengths exactly; rows 1e-6), and the candidate arrays are poisoned."""
    jt, tt = make_pair(**overrides)
    assert_states_match(jt.enh_state, tt.enh_state)
    assert bool(torch.all(tt.enh_state.base.best_dist == -torch.inf))
    assert bool(torch.all(tt.enh_state.base.best_j == -1))
    assert tt.enh_config == dataclasses.replace(
        tt.enh_config, **{f.name: getattr(jt.enh_config, f.name)
                          for f in dataclasses.fields(tt.enh_config)
                          if f.name != "base"})


@pytest.mark.parametrize("overrides", [
    {}, dict(use_hierarchical=True, use_compression_aware=True)])
def test_one_sync(overrides):
    """One sync_corpus: pair keys and counts exact, queue scores 1e-5."""
    jt, tt = make_pair(**overrides)
    jst = JE.sync_corpus(jt.enh_state, jt.enh_config)
    tst = TE.sync_corpus(tt.enh_state, tt.enh_config,
                         ReplaySampler(jt.enh_state.key))
    assert int(tst.pair_unique) > 0
    assert_states_match(jst, tst)


def trained_pair(n=21):
    """Both packages after one JAX chunk of ``n`` merges, carried across."""
    jt, tt = make_pair(optimize_curvature_freq=1000)
    jst = JE.run_enhanced(jt.enh_state, jt.enh_config, n)
    tst = convert.enhanced_state_from_arrays(jax.tree.map(np.asarray, jst),
                                             device="cpu")
    return jt, tt, jst, tst


def test_convert_roundtrip():
    jt, tt, jst, tst = trained_pair()
    assert_states_match(jst, tst, score_tol=0.0)
    back = convert.enhanced_state_from_arrays(
        convert.enhanced_state_to_arrays(tst), device="cpu")
    assert_states_match(jst, back, score_tol=0.0)


def test_curvature_update():
    """A fired Adam step with the same draws: curvature, moments and the
    rescaled queue distances within 1e-5; the poisoned candidates stay."""
    jt, tt, jst, tst = trained_pair()
    jcfg = jt.enh_config.replace(curvature_freq=7)
    tcfg = dataclasses.replace(tt.enh_config, curvature_freq=7)
    sampler = ReplaySampler(jst.key)
    j2 = JE._maybe_update_curvature(jst, jcfg)
    t2 = TE._maybe_update_curvature(tst, tcfg, sampler)
    assert int(t2.curv_t) == int(j2.curv_t) == 1
    assert float(t2.base.curvature) != pytest.approx(1.0)
    assert_states_match(j2, t2)
    np.testing.assert_array_equal(t2.base.best_dist.numpy(),
                                  np.asarray(j2.base.best_dist))
    # No event pending: no draw, no change.
    t3 = TE._maybe_update_curvature(t2, tcfg, sampler)
    assert t3 is t2


def test_enhanced_step_sequence():
    """Plain scored steps (the kernel's plain version) from a synced state
    against the JAX step, step by step."""
    jt, tt = make_pair(use_adaptive_curvature=False)
    jst = JE.sync_corpus(jt.enh_state, jt.enh_config)
    tst = TE.sync_corpus(tt.enh_state, tt.enh_config,
                         ReplaySampler(jt.enh_state.key))
    for _ in range(12):
        jst = JE.enhanced_step(jst, jt.enh_config)
        tst = TE.enhanced_step(tst, tt.enh_config, None)
        np.testing.assert_array_equal(history(tst), history(jst))
    assert int(tst.base.num_merges) > 24
    assert_states_match(jst, tst)


def test_midpoint_insert():
    jt, tt, jst, tst = trained_pair()
    emb, lengths = TSt.midpoint_insert(tst.base.emb.clone(),
                                       tst.base.lengths.clone(), 5, 9, 200,
                                       torch.tensor(1.3))
    jemb, jlen = JSt.midpoint_insert(jst.base.emb, jst.base.lengths, 5, 9,
                                     200, 1.3)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=1e-6)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlen))


def test_poisoned_state_guard():
    """A dense-channel configuration on a corpus-only state raises, as in
    the JAX package; a state built with candidates carries JAX's."""
    jt, tt = make_pair()
    dense = dataclasses.replace(tt.enh_config, use_dense_channel=True)
    with pytest.raises(ValueError, match="poisoned"):
        TE.run_enhanced(tt.enh_state, dense, 8, tt.sampler)
    jdense = jt.enh_config.replace(use_dense_channel=True)
    with pytest.raises(ValueError, match="poisoned"):
        JE.run_enhanced(jt.enh_state, jdense, 8)
    emb = np.asarray(jt.enh_state.base.emb[:12])
    tst = TSt.init_state(emb, [1] * 12,
                         config=TSt.MergeConfig(max_vocab_size=16),
                         device="cpu")
    jst = JSt.init_state(emb, np.ones(12, np.int32),
                         config=JSt.MergeConfig(max_vocab_size=16))
    np.testing.assert_allclose(tst.best_dist.numpy(),
                               np.asarray(jst.best_dist), atol=1e-5)
    np.testing.assert_array_equal(tst.best_j.numpy(),
                                  np.asarray(jst.best_j))
