"""The port's first slice as a whole == the JAX package.

Corpus-only flagship training scaled down (tests/torch_port_common.SMALL):
several chunks that cross curvature events (every 7 merges) and mid-chunk
resyncs (a 128-entry queue that truncates and drains), with the JAX
package's own draws injected. The merge history must be EXACTLY equal:

* to ``enhanced_state.run_enhanced`` on the CPU (the XLA while-loop,
  ``_run_enhanced_xla``, with its resync loop);
* to the Pallas segment kernel ``run_enhanced_fused`` in interpret mode
  (``segment_grid=64``, as tests/test_enhanced_loop_kernel.py runs it);
* through the tokenizers' ``optimize_merges``.
"""

import dataclasses

import numpy as np
import pytest

from hyptokenizer_tpu.ops.pallas import enhanced_loop as JK
from hyptokenizer_tpu.tokenizer import enhanced_state as JE
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as TE
from tests.torch_port_common import ReplaySampler, history, make_pair


@pytest.mark.parametrize("overrides", [
    {},
    dict(merge_policy="fixpoint"),
    dict(use_hierarchical=True, use_compression_aware=True, merge_batch=3),
], ids=["flagship", "fixpoint", "all-corpus-features"])
def test_chunks_match_xla_loop(overrides):
    jt, tt = make_pair(**overrides)
    jcfg, tcfg = jt.enh_config, tt.enh_config
    if tcfg.use_hierarchical:
        jcfg = jcfg.replace(phase2_step=10, phase3_step=30)
        tcfg = dataclasses.replace(tcfg, phase2_step=10, phase3_step=30)
    sampler = ReplaySampler(jt.enh_state.key)
    jst, tst = jt.enh_state, tt.enh_state
    syncs = 0
    chunks = 5
    for _ in range(chunks):
        jst = JE.run_enhanced(jst, jcfg, 24)
        tst, rounds = TE.run_enhanced(tst, tcfg, 24, sampler)
        syncs += rounds
        np.testing.assert_array_equal(history(tst), history(jst))
    assert int(tst.base.num_merges) > 100
    assert syncs > chunks                       # crossed mid-chunk resyncs
    assert int(tst.curv_t) >= 10                # crossed curvature events
    assert int(tst.curv_t) == int(jst.curv_t)
    assert int(tst.base.step) == int(jst.base.step)
    assert int(tst.phase) == int(jst.phase)
    np.testing.assert_allclose(float(tst.base.curvature),
                               float(jst.base.curvature), rtol=1e-5)
    np.testing.assert_allclose(float(tst.base.threshold),
                               float(jst.base.threshold), rtol=1e-6)
    v = int(tst.base.vocab_size)
    np.testing.assert_allclose(tst.base.emb[:v].numpy(),
                               np.asarray(jst.base.emb[:v]), atol=2e-4)
    np.testing.assert_array_equal(tst.token_hash[:v].numpy(),
                                  np.asarray(jst.token_hash[:v]))
    np.testing.assert_array_equal(tst.corpus.numpy(), np.asarray(jst.corpus))


def test_chunks_match_pallas_kernel_interpret():
    """Against the TPU kernel itself (interpret mode): one sync + segments
    per chunk, two chunks, crossing curvature events inside each."""
    jt, tt = make_pair()
    sampler = ReplaySampler(jt.enh_state.key)
    jst, tst = jt.enh_state, tt.enh_state
    for _ in range(2):
        jst = JK.run_enhanced_fused(jst, jt.enh_config, 16, interpret=True,
                                    segment_grid=64)
        tst, _ = TE.run_chunk(tst, tt.enh_config, 16, sampler)
        np.testing.assert_array_equal(history(tst), history(jst))
    assert int(tst.base.num_merges) >= 32
    assert int(tst.curv_t) == int(jst.curv_t) >= 4
    assert bool(tst.needs_resync) == bool(jst.needs_resync)
    assert int(tst.base.step) == int(jst.base.step)


def test_optimize_merges_matches():
    """The tokenizers' training entry point: same vocabulary, same history,
    same chunk statistics."""
    jt, tt = make_pair()
    tt.sampler = ReplaySampler(jt.enh_state.key)
    jt.optimize_merges(steps=60, log_every=30)
    tt.optimize_merges(steps=60, log_every=30)
    assert tt.merge_history == jt.merge_history
    assert tt.vocab == jt.vocab
    assert len(tt.merge_history) >= 60
    for ts, js in zip(tt.training_stats, jt.training_stats):
        for key in ("step", "vocab_size", "merges", "phase", "chunk_merges",
                    "chunk_syncs", "pair_table_unique"):
            assert ts[key] == js[key], key
    assert tt.training_summary["merges"] == jt.training_summary["merges"]


def test_segment_relaunch_guard(monkeypatch):
    """A segment that leaves the step counter unchanged without halting is
    an error, not a loop."""
    jt, tt = make_pair(use_adaptive_curvature=False)
    monkeypatch.setattr(TE, "run_segment", lambda st, *a, **k: st)
    with pytest.raises(RuntimeError, match="no progress"):
        TE.run_chunk(tt.enh_state, tt.enh_config, 8, tt.sampler)
