"""Port geometry (hyptokenizer_tpu_torch/ops/lorentz.py) == the JAX package's.

Same float32 inputs, made with numpy from a seed, through both. Tolerance:
1e-6 relative (float32 rounding, sums taken in another order), with a
1e-6 absolute floor for components near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.ops import lorentz as JL
from hyptokenizer_tpu_torch.ops import lorentz as TL

RTOL = 1e-6
ATOL = 1e-6


def points(n, d=8, sigma=0.5, seed=0):
    """On-sheet points (projected tangent Gaussians), float32."""
    rng = np.random.default_rng(seed)
    sp = (sigma * rng.standard_normal((n, d))).astype(np.float32)
    x0 = np.sqrt(1.0 + np.sum(sp * sp, axis=1, keepdims=True))
    return np.concatenate([x0, sp], axis=1).astype(np.float32)


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def test_constants():
    assert TL.ACOSH_EPS == JL.ACOSH_EPS
    assert TL.EPS_NORM == JL.EPS_NORM
    assert TL.EXP_ZERO_TOL == JL.EXP_ZERO_TOL


def test_acosh_log_form():
    x = np.linspace(1.0, 60.0, 997, dtype=np.float32)
    close(TL.acosh(torch.from_numpy(x)), JL.acosh(jnp.asarray(x)))


@pytest.mark.parametrize("seed", [0, 1])
def test_minkowski_dot(seed):
    x, y = points(64, seed=seed), points(64, seed=seed + 10)
    close(TL.minkowski_dot(torch.from_numpy(x), torch.from_numpy(y)),
          JL.minkowski_dot(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("c", [1.0, 0.7, 2.5])
def test_distance(c):
    x, y = points(64), points(64, seed=3)
    close(TL.distance(torch.from_numpy(x), torch.from_numpy(y), c),
          JL.distance(jnp.asarray(x), jnp.asarray(y), c))
    close(TL.distance(torch.from_numpy(x), torch.from_numpy(y), c, eps=1e-6),
          JL.distance(jnp.asarray(x), jnp.asarray(y), c, eps=1e-6))


@pytest.mark.parametrize("w", [0.0, 0.25, 0.5, 0.9])
def test_geodesic_point(w):
    x, y = points(64, sigma=1.5), points(64, sigma=1.5, seed=5)
    y[0] = x[0]  # a degenerate (d = 0) pair returns x
    close(TL.geodesic_point(torch.from_numpy(x), torch.from_numpy(y), w),
          JL.geodesic_point(jnp.asarray(x), jnp.asarray(y), w))


def test_geodesic_point_per_row_weights():
    x, y = points(32), points(32, seed=7)
    w = np.linspace(0.05, 0.95, 32, dtype=np.float32)
    close(TL.geodesic_point(torch.from_numpy(x), torch.from_numpy(y),
                            torch.from_numpy(w)),
          JL.geodesic_point(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))


@pytest.mark.parametrize("c", [1.0, 0.4])
def test_project_to_hyperboloid(c):
    x = points(64) * np.float32(1.3)
    close(TL.project_to_hyperboloid(torch.from_numpy(x), c),
          JL.project_to_hyperboloid(jnp.asarray(x), c))


def test_pairwise_dist():
    x, y = points(40), points(24, seed=9)
    close(TL.pairwise_dist(torch.from_numpy(x), torch.from_numpy(y), 1.3,
                           eps=1e-6),
          JL.pairwise_dist(jnp.asarray(x), jnp.asarray(y), 1.3, eps=1e-6))


def test_exp_map_at_origin():
    rng = np.random.default_rng(4)
    v = np.concatenate([np.zeros((16, 1)), 0.3 * rng.standard_normal(
        (16, 8))], axis=1).astype(np.float32)
    v[0] = 0.0  # degenerate direction
    base = np.broadcast_to(np.eye(9, dtype=np.float32)[0], (16, 9)).copy()
    close(TL.exp_map(torch.from_numpy(base), torch.from_numpy(v)),
          JL.exp_map(jnp.asarray(base), jnp.asarray(v)))


def test_random_points_on_sheet():
    """Draws differ from jax.random's; the distribution and sheet do not."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    x = TL.random_points(gen, 4000, 8, sigma=0.5, device="cpu")
    assert x.shape == (4000, 9)
    np.testing.assert_allclose(TL.minkowski_dot(x, x).numpy(), 1.0,
                               rtol=1e-5)
    ref = np.asarray(JL.random_points(jax.random.PRNGKey(0), 4000, 8,
                                      sigma=0.5))
    assert abs(float(x[:, 1:].std()) - float(ref[:, 1:].std())) < 0.02
    assert abs(float(x[:, 0].mean()) - float(ref[:, 0].mean())) < 0.02


def test_default_device_needs_a_card():
    """Without a card the default device raises; the port never drops to
    the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    gen = torch.Generator(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.random_points(gen, 4, 8)
