"""The port's rest of ``ops/lorentz.py`` and its ``ops/poincare.py`` against
the JAX package's, on the same float32 inputs made with numpy from a seed,
and the invariants ``tests/test_lorentz.py`` and ``tests/test_poincare.py``
hold the JAX package to, on the port.

Tolerance against JAX: 1e-5 relative with a 1e-6 absolute floor. Each
function composes a few float32 operations (a signed sum, acosh, sqrt,
tanh/atanh, a division), each within a few ulp (6e-8) of its exact value,
and the two packages sum in other orders. The invariants keep the JAX
tests' own tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.ops import lorentz as JL
from hyptokenizer_tpu.ops import poincare as JP
from hyptokenizer_tpu_torch.ops import lorentz as TL
from hyptokenizer_tpu_torch.ops import poincare as TP

RTOL = 1e-5
ATOL = 1e-6


def sheet(n, d=10, sigma=0.3, seed=0):
    """On-sheet points, float32, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    sp = (sigma * rng.standard_normal((n, d))).astype(np.float32)
    x0 = np.sqrt(1.0 + np.sum(sp * sp, axis=1, keepdims=True))
    return np.concatenate([x0, sp], axis=1).astype(np.float32)


def ball(n, d=10, seed=0):
    """Points inside the unit ball, float32 (``exp_map_zero`` of tangent
    Gaussians at 0.3, as ``tests/test_poincare.py`` makes them)."""
    rng = np.random.default_rng(seed)
    v = (0.3 * rng.standard_normal((n, d))).astype(np.float32)
    return np.asarray(JP.exp_map_zero(jnp.asarray(v)))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ----------------------------------------------------------- against JAX

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sigma", [0.3, 1.5])
def test_lorentz_functions_match_jax(seed, sigma):
    x, y = sheet(16, sigma=sigma, seed=seed), sheet(16, sigma=sigma,
                                                     seed=seed + 10)
    g = jnp.asarray(np.random.default_rng(seed + 20).standard_normal(
        x.shape).astype(np.float32))
    x, y = jnp.asarray(x), jnp.asarray(y)
    close(TL.minkowski_norm(t(x)), JL.minkowski_norm(x))
    close(TL.lorentz_to_klein(t(x)), JL.lorentz_to_klein(x))
    close(TL.log_map(t(x), t(y)), JL.log_map(x, y), atol=1e-5)
    v = np.asarray(JL.log_map(x, y))
    close(TL.parallel_transport(t(v), t(x), t(y)),
          JL.parallel_transport(v, x, y), atol=1e-5)
    close(TL.tangent_project(t(x), t(g)), JL.tangent_project(x, g),
          atol=1e-5)
    close(TL.riemannian_gradient(t(x), t(g)), JL.riemannian_gradient(x, g),
          atol=1e-5)
    for lr in (0.01, 0.1):
        close(TL.rsgd_step(t(x), t(g), lr), JL.rsgd_step(x, g, lr),
              atol=1e-5)
    # exp_map with the curvature argument that both accept and ignore, at
    # a tenth of the log map: at distance d its cosh/sinh sum cancels to
    # e^d ulp, which would measure the formula and not the port.
    close(TL.exp_map(t(x), t(0.1 * v), 2.0), JL.exp_map(x, 0.1 * v, 2.0),
          atol=1e-5)
    close(TL.batch_distance(t(x), t(y)), JL.batch_distance(x, y))


def test_log_map_degenerate_and_capped():
    """Coincident points (m clamped to 1 + eps, the coefficient's NaN mask)
    and a far pair, as the JAX package evaluates them."""
    x = jnp.asarray(sheet(4, seed=3))
    far = jnp.asarray(sheet(4, sigma=8.0, seed=4))
    close(TL.log_map(t(x), t(x)), JL.log_map(x, x))
    close(TL.log_map(t(x), t(far)), JL.log_map(x, far), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("c", [1.0, 0.5, 2.0])
def test_poincare_functions_match_jax(c):
    x, y = jnp.asarray(ball(16, seed=1)), jnp.asarray(ball(16, seed=2))
    r = jnp.asarray(np.random.default_rng(3).uniform(0.2, 2.0, (16, 1))
                    .astype(np.float32))
    close(TP.norm(t(x)), JP.norm(x))
    close(TP.mobius_addition(t(x), t(y), c), JP.mobius_addition(x, y, c))
    close(TP.mobius_scalar_mul(t(r), t(x), c), JP.mobius_scalar_mul(r, x, c))
    close(TP.exp_map_zero(t(x), c), JP.exp_map_zero(x, c))
    close(TP.log_map_zero(t(x), c), JP.log_map_zero(x, c))
    if c <= 1.0:   # the ball of radius 1/sqrt(c) holds the points
        close(TP.distance(t(x), t(y), c), JP.distance(x, y, c))
    lor = jnp.asarray(sheet(16, seed=5))
    close(TP.lorentz_to_poincare(t(lor), c), JP.lorentz_to_poincare(lor, c))
    close(TP.poincare_to_lorentz(t(x) * 0.5, c),
          JP.poincare_to_lorentz(x * 0.5, c))


def test_poincare_zero_vectors_match_jax():
    z = jnp.zeros((4, 10), jnp.float32)
    for fn in ("exp_map_zero", "log_map_zero"):
        np.testing.assert_array_equal(getattr(TP, fn)(t(z)).numpy(),
                                      np.asarray(getattr(JP, fn)(z)))


def test_package_exports_poincare():
    import hyptokenizer_tpu_torch as port
    assert port.poincare is TP and port.lorentz is TL


# --------------------------------- the JAX tests' invariants, on the port

@pytest.fixture
def points():
    return t(sheet(32, sigma=0.3, seed=42))


def test_log_exp_roundtrip(points):
    x, y = points[:16], points[16:]
    close(TL.exp_map(x, TL.log_map(x, y)), y.numpy(), atol=1e-4)


def test_log_map_is_tangent_with_distance_norm(points):
    x, y = points[:16], points[16:]
    v = TL.log_map(x, y)
    close(TL.minkowski_dot(x, v), np.zeros(16), atol=1e-4)
    norm = torch.sqrt(-TL.minkowski_dot(v, v))
    close(norm, TL.distance(x, y).numpy(), atol=1e-4)


def test_parallel_transport_tangency(points):
    x, y = points[:16], points[16:]
    v_t = TL.parallel_transport(TL.log_map(x, y), x, y)
    close(TL.minkowski_dot(y, v_t), np.zeros(16), atol=1e-3)


def test_tangent_project_is_tangent(points, rng):
    g = t(rng.normal(size=points.shape))
    close(TL.minkowski_dot(points, TL.tangent_project(points, g)),
          np.zeros(32), atol=1e-4)


def test_rsgd_step_stays_on_manifold(points, rng):
    g = t(rng.normal(size=points.shape))
    out = TL.rsgd_step(points, g, lr=0.1)
    close(TL.minkowski_dot(out, out), np.ones(32), atol=1e-4)
    out0 = TL.rsgd_step(points, torch.zeros_like(points), lr=0.1)
    close(out0, points.numpy(), atol=1e-5)


def test_rsgd_descends(points):
    """Twenty steps on the squared distance to a target, with autograd's
    Euclidean gradient, halve the loss (tests/test_lorentz.py)."""
    target = points[0]

    def loss(x):
        return torch.sum(TL.distance(x, target.expand_as(x), eps=1e-6) ** 2)

    x = points[16:].clone()
    l0 = float(loss(x))
    for _ in range(20):
        x.requires_grad_(True)
        (g,) = torch.autograd.grad(loss(x), x)
        x = TL.rsgd_step(x.detach(), g, lr=0.05)
    assert float(loss(x)) < l0 * 0.5


def test_klein_inside_unit_ball(points):
    assert bool((torch.linalg.vector_norm(TL.lorentz_to_klein(points),
                                          dim=-1) < 1.0).all())


@pytest.fixture
def ball_points():
    return t(ball(16, seed=42))


def test_ball_invariants(ball_points):
    x, y = ball_points[:8], ball_points[8:]
    assert bool((torch.linalg.vector_norm(ball_points, dim=-1) < 1.0).all())
    z = torch.zeros_like(ball_points)
    close(TP.mobius_addition(z, ball_points), ball_points.numpy(), atol=1e-6)
    close(TP.mobius_addition(ball_points, z), ball_points.numpy(), atol=1e-6)
    close(TP.mobius_addition(-ball_points, ball_points),
          np.zeros(ball_points.shape), atol=1e-5)
    close(TP.distance(x, y), TP.distance(y, x).numpy(), atol=1e-5)
    r = torch.ones((16, 1))
    close(TP.mobius_scalar_mul(r, ball_points), ball_points.numpy(),
          atol=1e-4)


def test_ball_maps_roundtrip(rng):
    v = t(rng.normal(size=(16, 10)) * 0.3)
    close(TP.log_map_zero(TP.exp_map_zero(v)), v.numpy(), atol=1e-4)


def test_model_conversion_roundtrip(ball_points):
    lor = TP.poincare_to_lorentz(ball_points)
    close(TL.minkowski_dot(lor, lor), np.ones(16), atol=1e-4)
    close(TP.lorentz_to_poincare(lor), ball_points.numpy(), atol=1e-5)


def test_distance_agrees_across_models(ball_points):
    x, y = ball_points[:8], ball_points[8:]
    close(TP.distance(x, y),
          TL.distance(TP.poincare_to_lorentz(x),
                      TP.poincare_to_lorentz(y)).numpy(), atol=1e-3)
