"""Hyperbolic contrastive losses and retrieval metrics, in PyTorch.

Port of ``hyptokenizer_tpu/models/losses.py``: the symmetric InfoNCE over
the pairwise hyperbolic distance matrix, the triplet loss and Recall@K,
each one gram on the inputs' device (``lorentz.pairwise_minkowski_dot``,
full float32). The JAX package computes them in XLA, so plain PyTorch is
the port.

Gradient at the acosh clamp: the losses clamp ``<x,y>_L`` to
``>= 1 + GRAD_EPS`` with ``torch.maximum`` against a tensor, which splits
the gradient at an exact tie as ``jnp.maximum`` does (``clamp_min`` would
pass all of it); the values are ``lorentz.pairwise_dist``'s and
``lorentz.distance``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hyptokenizer_tpu_torch.ops import lorentz as L

GRAD_EPS = 1e-6


def _clamped_acosh(gram: torch.Tensor, c, eps: float) -> torch.Tensor:
    floor = torch.full_like(gram, 1.0 + eps)
    return L.acosh(torch.maximum(gram, floor)) / torch.sqrt(
        torch.as_tensor(c, dtype=gram.dtype, device=gram.device))


def hyperbolic_contrastive_loss(z1: torch.Tensor, z2: torch.Tensor,
                                temperature: float = 0.07,
                                c: float = 1.0) -> torch.Tensor:
    """Symmetric InfoNCE: similarities ``-distance / temperature``,
    cross-entropy with the diagonal as labels in both directions,
    averaged."""
    dist = _clamped_acosh(L.pairwise_minkowski_dot(z1, z2), c, GRAD_EPS)
    sims = -dist / temperature
    loss_12 = -torch.mean(torch.diagonal(F.log_softmax(sims, dim=1)))
    loss_21 = -torch.mean(torch.diagonal(F.log_softmax(sims.T, dim=1)))
    return 0.5 * (loss_12 + loss_21)


def hyperbolic_triplet_loss(anchor: torch.Tensor, positive: torch.Tensor,
                            negative: torch.Tensor, margin: float = 0.1,
                            c: float = 1.0) -> torch.Tensor:
    """``relu(d(a, p) - d(a, n) + margin)`` averaged."""
    d_pos = _clamped_acosh(L.minkowski_dot(anchor, positive), c, GRAD_EPS)
    d_neg = _clamped_acosh(L.minkowski_dot(anchor, negative), c, GRAD_EPS)
    return torch.mean(torch.relu(d_pos - d_neg + margin))


class HyperbolicInfoNCE:
    """Callable wrapper of :func:`hyperbolic_contrastive_loss`."""

    def __init__(self, temperature: float = 0.07, curvature: float = 1.0):
        self.temperature = temperature
        self.curvature = curvature

    def __call__(self, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        return hyperbolic_contrastive_loss(z1, z2, self.temperature,
                                           self.curvature)


def recall_at_k(query: torch.Tensor, gallery: torch.Tensor,
                ks=(1, 5, 10), c: float = 1.0) -> dict:
    """Recall@K both directions from one distance matrix, as 0-d tensors.

    The ranking is a stable sort (``jnp.argsort`` is stable; torch's is
    only when asked), so tied distances rank by index as in the JAX
    package."""
    dist = L.pairwise_dist(query, gallery, c)
    labels = torch.arange(query.shape[0], device=query.device)
    order_q = torch.argsort(dist, dim=1, stable=True)
    order_g = torch.argsort(dist.T, dim=1, stable=True)
    out = {}
    for k in ks:
        hit_q = torch.any(order_q[:, :k] == labels[:, None], dim=1)
        hit_g = torch.any(order_g[:, :k] == labels[:, None], dim=1)
        out[f"text_to_image_r@{k}"] = hit_q.float().mean()
        out[f"image_to_text_r@{k}"] = hit_g.float().mean()
    return out
