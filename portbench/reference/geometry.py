"""Hyperboloid geometry in plain PyTorch, for the benchmark's references.

Points are ``(..., d+1)`` with the time-like coordinate first and
``<x, y>_L = x0 y0 - sum_i x_i y_i``. ``acosh`` is taken in its log form
with its argument clamped to ``>= 1 + eps``; a geodesic point is taken in
the scaled-exponential form (every exponent <= 0); a merged token's point
is re-projected onto the sheet of the curvature in force. These are the
definitions the tokenizer's published description states (HypTokenizer's
``lorentz`` module, as this repository's README documents it). Every
function works in the dtype of its inputs, so that a control can run the
same mathematics in a lower precision.
"""

from __future__ import annotations

import torch

ACOSH_EPS = 1e-8     # <x,y>_L clamped to >= 1 + ACOSH_EPS for distances
GRAD_EPS = 1e-6      # the clamp of the differentiable distances
EPS_NORM = 1e-8      # the least squared norm
EXP_ZERO_TOL = 1e-6  # below this a geodesic or a tangent is degenerate


def signature(d1: int, like: torch.Tensor) -> torch.Tensor:
    sig = torch.full((d1,), -1.0, dtype=like.dtype, device=like.device)
    sig[0] = 1.0
    return sig


def mdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Minkowski inner product over the last axis."""
    return (x * signature(x.shape[-1], x) * y).sum(-1)


def acosh(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x + torch.sqrt(x * x - 1.0))


def distance(x, y, c, eps: float = ACOSH_EPS) -> torch.Tensor:
    g = torch.clamp_min(mdot(x, y), 1.0 + eps)
    return acosh(g) / torch.sqrt(torch.as_tensor(c, dtype=x.dtype,
                                                 device=x.device))


def grad_distance(x, y, c) -> torch.Tensor:
    """Distance with the clamp taken by ``torch.maximum``, which splits the
    gradient at an exact tie."""
    g = mdot(x, y)
    g = torch.maximum(g, g.new_full((), 1.0 + GRAD_EPS))
    return acosh(g) / torch.sqrt(torch.as_tensor(c, dtype=x.dtype,
                                                 device=x.device))


def pairwise_distance(x, y, c, eps: float = ACOSH_EPS) -> torch.Tensor:
    """(n, m) distances; the gram is an explicit sum of products, so no
    matrix unit and no TF32 touches it."""
    g = (x[:, None, :] * signature(x.shape[-1], x) * y[None, :, :]).sum(-1)
    g = torch.clamp_min(g, 1.0 + eps)
    return acosh(g) / torch.sqrt(torch.as_tensor(c, dtype=x.dtype,
                                                 device=x.device))


def geodesic_point(x, y, w) -> torch.Tensor:
    """The point at fraction ``w`` from ``x`` to ``y``; ``x`` where the
    two coincide."""
    d = acosh(torch.clamp_min(mdot(x, y), 1.0 + ACOSH_EPS))
    w = torch.as_tensor(w, dtype=x.dtype, device=x.device)
    a = (1.0 - w) * d
    b = w * d
    num_x = torch.exp(-b) * (1.0 - torch.exp(-2.0 * a))
    num_y = torch.exp(-a) * (1.0 - torch.exp(-2.0 * b))
    den = torch.clamp_min(1.0 - torch.exp(-2.0 * d), EPS_NORM)
    out = (num_x[..., None] * x + num_y[..., None] * y) / den[..., None]
    return torch.where((d < EXP_ZERO_TOL)[..., None], x, out)


def project(x, c) -> torch.Tensor:
    """Onto the sheet: ``x0 = sqrt(1 + c |x_spatial|^2)``."""
    sp = x[..., 1:]
    c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    return torch.cat([torch.sqrt(1.0 + c * (sp * sp).sum(-1, keepdim=True)),
                      sp], dim=-1)


def exp_map(x, v) -> torch.Tensor:
    v_sq = (v[..., 1:] * v[..., 1:]).sum(-1, keepdim=True) - v[..., :1] ** 2
    n = torch.sqrt(torch.clamp_min(v_sq, EPS_NORM))
    mask = (n < EXP_ZERO_TOL).to(v.dtype)
    direction = (1.0 - mask) * (v / (n + mask))
    return torch.cosh(n) * x + torch.sinh(n) * direction


def rsgd_step(x, grad, lr) -> torch.Tensor:
    """Riemannian SGD on the c=1 sheet: flip the time component of the
    Euclidean gradient, project it onto the tangent space, retract ``-lr``
    times it, re-project."""
    h = torch.cat([-grad[..., :1], grad[..., 1:]], dim=-1)
    tangent = h - mdot(x, h)[..., None] * x
    return project(exp_map(x, -lr * tangent), 1.0)


def random_points(generator: torch.Generator, n: int, d: int,
                  sigma: float) -> torch.Tensor:
    """``n`` points near the origin: a tangent Gaussian of scale ``sigma``
    through the exponential map at the origin, in float32, on the
    generator's device, in one draw."""
    dev = generator.device
    spatial = sigma * torch.randn((n, d), generator=generator, device=dev)
    tangent = torch.cat([torch.zeros((n, 1), device=dev), spatial], dim=-1)
    origin = torch.zeros((n, d + 1), device=dev)
    origin[:, 0] = 1.0
    return project(exp_map(origin, tangent), 1.0)


POINTS = {
    "tangent_gaussian": lambda g, n, d, traffic: random_points(
        g, n, d, traffic["init_sigma"]),
}


def traffic_points(traffic: dict, generator: torch.Generator, n: int,
                   d: int) -> torch.Tensor:
    """The initial points that the traffic's rule (``points``: a key of
    ``POINTS``, with that rule's own keys) draws from ``generator``."""
    return POINTS[traffic["points"]](generator, n, d, traffic)
