"""Lorentz (hyperboloid) model operations, in PyTorch.

Port of ``hyptokenizer_tpu/ops/lorentz.py``. Conventions are the JAX
package's (see its module docstring and DEVIATIONS.md): points are
``(..., d+1)`` with the time-like coordinate first, ``<x,y>_L = x0*y0 -
sum_i x_i y_i`` is positive on the sheet, ``acosh`` takes its log form and
its argument is clamped to ``>= 1 + eps``. ``log_map``,
``parallel_transport`` and ``tangent_project`` carry the sign fixes of
DEVIATIONS.md §1-5 (the intended geometry, not the reference's).

Every gram runs in full float32 whatever the process-wide matmul setting:
:func:`pairwise_minkowski_dot` switches TF32 off around its matmul and
restores the caller's setting (:func:`fp32_matmul`), as the JAX package
pins ``precision=DOT_PREC`` on every call.
"""

from __future__ import annotations

import contextlib

import torch

from hyptokenizer_tpu_torch import _device

# --- stability constants (the JAX package's, lorentz.py:54-57) ---
EPS_NORM = 1e-8          # min squared-norm clamp
ACOSH_EPS = 1e-8         # <x,y>_L clamped to >= 1 + ACOSH_EPS
LOG_COEF_MAX = 1e4       # log-map coefficient cap
EXP_ZERO_TOL = 1e-6      # exp-map / geodesic degenerate-direction mask


def acosh(x: torch.Tensor) -> torch.Tensor:
    """``acosh`` for ``x >= 1`` as ``log(x + sqrt(x^2 - 1))``.

    The evaluation every kernel of both packages uses
    (``ops/pallas/merge_loop.py`` ``_acosh``; ``csrc/enhanced_loop.cu``).
    """
    return torch.log(x + torch.sqrt(x * x - 1.0))


def _signature(d1: int, like: torch.Tensor) -> torch.Tensor:
    """Metric signature ``(+1, -1, ..., -1)`` of length ``d1``, made on the
    device (assigning a Python number to an element of a CUDA tensor is a
    host-to-device copy, which synchronises)."""
    first = torch.arange(d1, device=like.device) == 0
    return torch.where(first, 1.0, -1.0).to(like.dtype)


def minkowski_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x0*y0 - <x_s, y_s>`` over the last axis, as one signed contraction."""
    return torch.sum(x * _signature(x.shape[-1], x) * y, dim=-1)


def minkowski_norm(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(<x,x>_L, 1e-8))``."""
    return torch.sqrt(torch.clamp_min(minkowski_dot(x, x), EPS_NORM))


def project_to_hyperboloid(x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Recompute the time coordinate: ``x0 = sqrt(1 + c * |x_spatial|^2)``."""
    spatial = x[..., 1:]
    sq = torch.sum(spatial * spatial, dim=-1, keepdim=True)
    return torch.cat([torch.sqrt(1.0 + c * sq), spatial], dim=-1)


def lorentz_to_klein(x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Klein-model coordinates ``x_spatial / x0``."""
    del c
    return x[..., 1:] / x[..., 0:1]


def exp_map(x: torch.Tensor, v: torch.Tensor, c=1.0) -> torch.Tensor:
    """Exponential map of tangent ``v`` at ``x`` (Minkowski tangent norm;
    ``c`` is accepted as the JAX package accepts it, and unused)."""
    del c
    v_sq = (torch.sum(v[..., 1:] * v[..., 1:], dim=-1, keepdim=True)
            - v[..., :1] * v[..., :1])
    v_norm = torch.sqrt(torch.clamp_min(v_sq, EPS_NORM))
    mask = (v_norm < EXP_ZERO_TOL).to(v.dtype)
    direction = (1.0 - mask) * (v / (v_norm + mask))
    return torch.cosh(v_norm) * x + torch.sinh(v_norm) * direction


def log_map(x: torch.Tensor, y: torch.Tensor, c=1.0) -> torch.Tensor:
    """Logarithmic map of ``y`` at ``x``: ``coef * (y - m x)`` with
    ``m = <x,y>_L`` and ``coef = acosh(m)/sqrt(m^2 - 1)``, capped at
    ``LOG_COEF_MAX`` and 1 where it is NaN, so that ``|log_x(y)| = d(x, y)``
    and ``<x, log_x(y)>_L = 0`` (the sign of ``m`` fixed, DEVIATIONS.md)."""
    del c
    m = minkowski_dot(x, y)
    m_c = torch.clamp_min(m, 1.0 + ACOSH_EPS)
    denom_sq = m_c * m_c - 1.0
    coef = torch.where(
        denom_sq > 0,
        acosh(m_c) / torch.sqrt(torch.clamp_min(denom_sq, EPS_NORM)),
        torch.ones_like(m_c))
    coef = torch.clamp_max(coef, LOG_COEF_MAX)
    coef = torch.where(torch.isnan(coef), torch.ones_like(coef), coef)
    return coef[..., None] * (y - m[..., None] * x)


def geodesic_point(x: torch.Tensor, y: torch.Tensor, w) -> torch.Tensor:
    """Point at fraction ``w`` along the geodesic from ``x`` to ``y``.

    ``[sinh((1-w) d) x + sinh(w d) y] / sinh(d)`` in the JAX package's
    scaled-exponential form (every exponent <= 0, no cancellation); ``d -> 0``
    returns ``x``. Midpoints live on the c=1 sheet (curvature scales
    distances only), so there is no curvature argument.
    """
    d = acosh(torch.clamp_min(minkowski_dot(x, y), 1.0 + ACOSH_EPS))
    w = torch.as_tensor(w, dtype=x.dtype, device=x.device)
    a = (1.0 - w) * d
    b = w * d
    num_x = torch.exp(-b) * (1.0 - torch.exp(-2.0 * a))
    num_y = torch.exp(-a) * (1.0 - torch.exp(-2.0 * b))
    den = torch.clamp_min(1.0 - torch.exp(-2.0 * d), EPS_NORM)
    out = (num_x[..., None] * x + num_y[..., None] * y) / den[..., None]
    return torch.where((d < EXP_ZERO_TOL)[..., None], x, out)


def distance(x: torch.Tensor, y: torch.Tensor, c=1.0,
             eps: float = ACOSH_EPS) -> torch.Tensor:
    """Geodesic distance ``acosh(max(<x,y>_L, 1+eps)) / sqrt(c)``.

    ``eps >= 1e-6`` keeps the gradient finite at coincident points (the
    default rounds to exactly 1.0 in float32).
    """
    xy = torch.clamp_min(minkowski_dot(x, y), 1.0 + eps)
    return acosh(xy) / torch.sqrt(torch.as_tensor(c, dtype=x.dtype,
                                                  device=x.device))


@contextlib.contextmanager
def fp32_matmul():
    """Run the enclosed matmuls in full float32 (no TF32), then restore the
    process-wide setting, whatever a caller set it to with
    ``torch.set_float32_matmul_precision`` after ``_device.py``'s import."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def pairwise_minkowski_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Gram matrix ``G[i, j] = <x_i, y_j>_L`` as one full-float32 matmul.

    Every gram of the port goes through here."""
    with fp32_matmul():
        return torch.matmul(x * _signature(x.shape[-1], x),
                            y.transpose(-1, -2))


def pairwise_dist(x: torch.Tensor, y: torch.Tensor, c=1.0,
                  eps: float = ACOSH_EPS) -> torch.Tensor:
    """Pairwise distance matrix ``(B1, B2)``."""
    xy = torch.clamp_min(pairwise_minkowski_dot(x, y), 1.0 + eps)
    return acosh(xy) / torch.sqrt(torch.as_tensor(c, dtype=x.dtype,
                                                  device=x.device))


# The reference's names for the pairwise distance (the JAX package's too).
batch_distance = pairwise_dist
batch_distance_optimized = pairwise_dist


def parallel_transport(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       c=1.0) -> torch.Tensor:
    """Parallel transport of tangent ``v`` from ``x`` to ``y``:
    ``v - <y,v>_L / (1 + <x,y>_L) * (x + y)``, tangent at ``y``."""
    del c
    m = minkowski_dot(x, y)[..., None]
    coef = minkowski_dot(y, v)[..., None] / (1.0 + m)
    return v - coef * (x + y)


def tangent_project(x: torch.Tensor, g: torch.Tensor, c=1.0) -> torch.Tensor:
    """Project an ambient vector onto the tangent space at ``x``:
    ``g - <x, g>_L * x``."""
    del c
    return g - minkowski_dot(x, g)[..., None] * x


riemannian_gradient = tangent_project


def rsgd_step(x: torch.Tensor, euclidean_grad: torch.Tensor, lr: float,
              c=1.0) -> torch.Tensor:
    """One Riemannian SGD step: flip the gradient's time component (the
    inverse ambient metric), project it onto the tangent space at ``x``,
    retract ``-lr`` times it through the exponential map, re-project onto
    the sheet."""
    h = euclidean_grad.clone()
    h[..., 0] = -h[..., 0]
    step = -lr * tangent_project(x, h)
    return project_to_hyperboloid(exp_map(x, step), c)


def origin(d: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """The hyperboloid origin ``(1, 0, ..., 0)`` in ``R^{d+1}``."""
    out = torch.zeros(d + 1, dtype=dtype, device=_device.resolve(device))
    out[0] = 1.0
    return out


def random_points(generator: torch.Generator, n: int, d: int, c=1.0,
                  sigma: float = 0.01, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """Points near the origin: tangent Gaussian(0, sigma^2) -> exp map.

    Draws from ``generator``, which must live on ``device``. The numbers
    differ from ``jax.random``'s for the same seed; the distribution is the
    same.
    """
    dev = _device.resolve(device)
    spatial = sigma * torch.randn((n, d), generator=generator, device=dev,
                                  dtype=dtype)
    tangent = torch.cat([torch.zeros((n, 1), device=dev, dtype=dtype),
                         spatial], dim=-1)
    base = origin(d, dev, dtype).expand(n, d + 1)
    return project_to_hyperboloid(exp_map(base, tangent), c)
