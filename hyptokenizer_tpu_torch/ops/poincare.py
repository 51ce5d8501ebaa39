"""Poincaré ball model operations, in PyTorch.

Port of ``hyptokenizer_tpu/ops/poincare.py``: Möbius addition and scalar
multiplication, the exponential and logarithmic maps at the origin, the
ball distance and the conversions to and from the hyperboloid. Batch-first,
the manifold coordinate last, ``(..., d)``. The inner products are
elementwise sums, which no TF32 setting touches.
"""

from __future__ import annotations

import torch

EPS_NORM = 1e-8  # min-norm clamp


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, dim=-1, keepdim=True)


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, kept as an axis of size 1."""
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _sqrt_c(c, like: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.as_tensor(c, dtype=like.dtype,
                                      device=like.device))


def mobius_addition(x: torch.Tensor, y: torch.Tensor, c=1.0) -> torch.Tensor:
    """Möbius addition ``x ⊕_c y``."""
    x_sq, y_sq, xy = _dot(x, x), _dot(y, y), _dot(x, y)
    num = (1.0 + 2.0 * c * xy + c * y_sq) * x + (1.0 - c * x_sq) * y
    denom = 1.0 + 2.0 * c * xy + c * c * x_sq * y_sq
    return num / denom


def mobius_scalar_mul(r, x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Möbius scalar multiplication ``r ⊗_c x``."""
    sqrt_c = _sqrt_c(c, x)
    x_norm = torch.clamp_min(norm(x), EPS_NORM)
    return torch.tanh(r * torch.atanh(sqrt_c * x_norm)) / (sqrt_c * x_norm) \
        * x


def exp_map_zero(v: torch.Tensor, c=1.0) -> torch.Tensor:
    """Exponential map at the origin; an exactly-zero vector maps to
    itself."""
    sqrt_c = _sqrt_c(c, v)
    v_norm = norm(v)
    zeros_mask = (v_norm == 0).to(v.dtype)
    v_norm_c = torch.clamp_min(v_norm, EPS_NORM)
    mapped = torch.tanh(sqrt_c * v_norm_c) / (sqrt_c * v_norm_c) * v
    return mapped * (1.0 - zeros_mask) + zeros_mask * v


def log_map_zero(x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Logarithmic map at the origin; an exactly-zero point maps to
    itself."""
    sqrt_c = _sqrt_c(c, x)
    x_norm = norm(x)
    zeros_mask = (x_norm == 0).to(x.dtype)
    x_norm_c = torch.clamp_min(x_norm, EPS_NORM)
    mapped = torch.atanh(sqrt_c * x_norm_c) / (sqrt_c * x_norm_c) * x
    return mapped * (1.0 - zeros_mask) + zeros_mask * x


def distance(x: torch.Tensor, y: torch.Tensor, c=1.0) -> torch.Tensor:
    """Ball distance ``2/sqrt(c) * atanh(sqrt(c) ||(-x) ⊕ y||)``."""
    sqrt_c = _sqrt_c(c, x)
    diff = mobius_addition(-x, y, c)
    return (2.0 / sqrt_c) * torch.atanh(sqrt_c * norm(diff))[..., 0]


def lorentz_to_poincare(x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Stereographic projection from the hyperboloid to the ball."""
    sqrt_c = _sqrt_c(c, x)
    return x[..., 1:] / (x[..., 0:1] + 1.0 / sqrt_c)


def poincare_to_lorentz(x: torch.Tensor, c=1.0) -> torch.Tensor:
    """Inverse of :func:`lorentz_to_poincare`, onto the sheet
    ``<x,x>_L = 1`` for every ``c`` (the JAX package's formula, not the
    reference's, DEVIATIONS.md): with ``k = 1/sqrt(c)`` and
    ``s = ||y||^2``, ``x0 = (k s + sqrt(1 + s (k^2 - 1))) / (1 - s)`` and
    ``x_s = y (x0 + k)``."""
    k = 1.0 / _sqrt_c(c, x)
    s = _dot(x, x)
    x0 = (k * s + torch.sqrt(1.0 + s * (k * k - 1.0))) / (1.0 - s)
    return torch.cat([x0, x * (x0 + k)], dim=-1)
