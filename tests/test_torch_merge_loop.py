"""The port's distance-only merge loop == the JAX package's.

The port's ``merge_step`` looped (``state.run_merges_plain``, the plain
version of kernel K4) starts from the JAX package's own initial state and
is held, at the sizes of tests/test_merge_loop_kernel.py (n0=40, d=7,
max_v=256), to the XLA while-loop ``_run_merges_xla`` and to the Pallas
kernel ``run_merges_chunk`` in interpret mode, by that file's rules: merge
pairs equal while the distances stay above the acosh clamp floor (below it
every distance saturates to one value and either pick of a tie is right),
merge distances within ``1e-4 + 4e-6/d`` (acosh amplifies a gram's rounding
near the floor), rows within 1e-4, loop scalars equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hyptokenizer_tpu.ops import lorentz as JL
from hyptokenizer_tpu.ops.pallas.merge_loop import run_merges_chunk
from hyptokenizer_tpu.tokenizer import state as JS
from hyptokenizer_tpu_torch import convert
from hyptokenizer_tpu_torch.tokenizer import state as TS

NOISE = 1e-3   # above the clamp floor (~5e-4), as test_merge_loop_kernel.py


def fresh(n0=40, d=7, max_v=256, threshold=2.5, sigma=0.6, seed=0,
          lengths=None, **cfg_kw):
    """The same initial state in both packages (the port's copied from the
    JAX package's, candidates included) and both configurations."""
    emb0 = JL.random_points(jax.random.PRNGKey(seed), n0, d, sigma=sigma)
    lens = jnp.ones((n0,), jnp.int32) if lengths is None else \
        jnp.asarray(lengths, jnp.int32)
    jcfg = JS.MergeConfig(max_vocab_size=max_v, search_block=64,
                          use_pallas=False, **cfg_kw)
    jst = JS.init_state(emb0, lens, curvature=1.0, threshold=threshold,
                        config=jcfg)
    arrays = jax.tree.map(np.asarray, jst)
    tst = convert.merge_state_from_arrays(arrays, "cpu")
    tcfg = TS.MergeConfig(max_vocab_size=max_v, search_block=64, **cfg_kw)
    return jst, jcfg, tst, tcfg


def run_jax(jst, jcfg, steps, ref):
    if ref == "xla":
        return JS._run_merges_xla(jst, jcfg, steps)
    return run_merges_chunk(jst, jcfg, steps, interpret=True)


def assert_same_run(t, j, min_comparable=0):
    """The port's state ``t`` against the JAX package's ``j``."""
    for name in ("vocab_size", "num_merges", "step", "empty_rounds",
                 "stopped"):
        assert int(getattr(t, name)) == int(getattr(j, name)), name
    assert float(t.threshold) == float(j.threshold)
    n = int(j.num_merges)
    dt = t.merge_dists[:n].numpy()
    dj = np.asarray(j.merge_dists[:n])
    comparable = next((k for k in range(n) if dj[k] <= NOISE), n)
    assert comparable >= min_comparable   # the comparison has teeth
    np.testing.assert_array_equal(t.merges[:comparable].numpy(),
                                  np.asarray(j.merges[:comparable]))
    tol = 1e-4 + 4e-6 / np.maximum(dj[:comparable], 1e-5)
    assert np.all(np.abs(dt[:comparable] - dj[:comparable]) <= tol)
    v = int(j.vocab_size) - n + comparable
    np.testing.assert_allclose(t.emb[:v].numpy(), np.asarray(j.emb[:v]),
                               atol=1e-4)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_matches_above_clamp_floor(ref):
    jst, jcfg, tst, tcfg = fresh()
    t = TS.run_merges_plain(tst, tcfg, 60)
    j = run_jax(jst, jcfg, 60, ref)
    assert_same_run(t, j, min_comparable=5)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_chunked_equals_single_run(ref):
    jst, jcfg, tst, tcfg = fresh()
    a = TS.run_merges(tst, tcfg, 25)     # a CPU state: the plain version
    a = TS.run_merges(a, tcfg, 15)
    _, _, tst_b, _ = fresh()
    b = TS.run_merges_plain(tst_b, tcfg, 40)
    for name in ("merges", "best_dist", "best_j", "emb", "step",
                 "num_merges"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy())
    assert_same_run(a, run_jax(jst, jcfg, 40, ref), min_comparable=5)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_adaptive_growth_on_empty_rounds(ref):
    jst, jcfg, tst, tcfg = fresh(threshold=1e-6)
    t = TS.run_merges_plain(tst, tcfg, 20)
    assert int(t.step) == 20 and int(t.num_merges) == 0
    assert float(t.threshold) > 1e-6
    assert_same_run(t, run_jax(jst, jcfg, 20, ref))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_non_adaptive_stops_after_empty_rounds(ref):
    jst, jcfg, tst, tcfg = fresh(threshold=1e-6, adaptive_threshold=False)
    t = TS.run_merges_plain(tst, tcfg, 30)
    assert bool(t.stopped) and int(t.step) == 10
    assert_same_run(t, run_jax(jst, jcfg, 30, ref))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_stops_at_capacity(ref):
    jst, jcfg, tst, tcfg = fresh(max_v=128, threshold=50.0)
    t = TS.run_merges_plain(tst, tcfg, 200)
    assert bool(t.stopped) and int(t.vocab_size) == 128
    assert int(t.num_merges) == 88
    assert_same_run(t, run_jax(jst, jcfg, 200, ref))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_unaligned_max_vocab(ref):
    jst, jcfg, tst, tcfg = fresh(max_v=200, threshold=50.0)
    t = TS.run_merges_plain(tst, tcfg, 300)
    assert bool(t.stopped) and int(t.vocab_size) == 200
    assert int(t.num_merges) == 160
    assert_same_run(t, run_jax(jst, jcfg, 300, ref))


def test_length_gate_matches_xla():
    """``max_token_len > 0``: the XLA loop applies the gate (the Pallas
    kernel does not, so it is not compared here)."""
    lengths = np.random.default_rng(1).integers(1, 4, 40)
    jst, jcfg, tst, tcfg = fresh(threshold=5.0, lengths=lengths,
                                 max_token_len=6)
    t = TS.run_merges_plain(tst, tcfg, 80)
    assert int(t.num_merges) > 20
    n = int(t.num_merges)
    made = t.lengths[40:40 + n]
    assert int(made.max()) <= 6
    assert_same_run(t, run_jax(jst, jcfg, 80, "xla"), min_comparable=5)


def test_merge_step_scalars_are_tensors():
    """Every loop scalar stays a 0-d tensor of the JAX package's type."""
    _, _, tst, tcfg = fresh()
    t = TS.merge_step(tst, tcfg)
    for name, dtype in (("vocab_size", "int32"), ("num_merges", "int32"),
                        ("step", "int32"), ("empty_rounds", "int32"),
                        ("threshold", "float32"), ("curvature", "float32"),
                        ("stopped", "bool")):
        x = getattr(t, name)
        assert x.ndim == 0 and str(x.dtype) == f"torch.{dtype}", name
    assert int(TS.config_capacity(t)) == 256 - 41


def test_k4_checks_hold_the_plain_version_and_catch_a_fault():
    """The K4 checks of ``evals/selfcheck.py`` on the CPU: the plain
    version passes both against itself, and a loop whose new rows are off
    by 1e-3 fails the step-level check."""
    from hyptokenizer_tpu_torch.evals import selfcheck

    st, cfg = selfcheck.base_state("cpu", n0=64, d=7, max_v=160,
                                   threshold=50.0)
    out = {}
    selfcheck._check_base_kernel(out, st, cfg, n_chunks=3, chunk=10,
                                 device="cpu")
    assert out["kernel_selfcheck"] == "pass"
    assert out["kernel_selfcheck_merges"] == 30
    selfcheck._lockstep_base_steps(st, cfg, 20, out, "k4",
                                   kernel=TS.run_merges_plain)
    assert out["k4"] == "pass" and out["k4_steps"] == 20
    assert out["k4_merges"] == 20 and int(st.num_merges) == 0

    def faulty(state, config, n_steps):
        v = int(state.vocab_size)
        out = TS.run_merges_plain(state, config, n_steps)
        out.emb[v:int(out.vocab_size), 1] += 1e-3
        return out

    selfcheck._lockstep_base_steps(st, cfg, 20, out, "bad", kernel=faulty)
    assert out["bad"].startswith("FAIL") and out["bad_steps"] == 1
