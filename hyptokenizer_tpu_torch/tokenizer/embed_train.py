"""Riemannian SGD training of token embeddings, in PyTorch.

Port of ``hyptokenizer_tpu/tokenizer/embed_train.py``: the hyperbolic
skip-gram on adjacent-token co-occurrence (:func:`train_embeddings`), its
explicit-pair form for hierarchy supervision
(:func:`train_embeddings_pairs`, with :func:`merge_tree_pairs`), and the
stress and ordinal objectives fitted to graph distances. Each trainer is a
Python loop over steps on the embeddings' device: ``torch.autograd`` gives
the gradient of the whole table, ``lorentz.rsgd_step`` retracts it (at
``lr/10`` for the first ``max(1, steps//10)`` steps), and a final
``project_to_hyperboloid`` returns ``(emb, losses)`` as the JAX package
does. The JAX package computes these in XLA (no Pallas kernel), so plain
PyTorch is the port; float32 throughout, TF32 off (``_device.py``).

Draws. Every step draws through a *sampler* passed in place of the JAX
package's key: an object with ``randint(shape, high)`` (ids in
``[0, high)``) and ``uniform(shape)`` (floats in ``[0, 1)``), called in the
order the JAX step splits its key. An int seed or a ``torch.Generator``
makes a :class:`GeneratorSampler`. The numbers differ from ``jax.random``'s
for the same seed; the distribution is the same. A test hands the trainers
a sampler that replays the JAX key chain.

Determinism. Rows are gathered through :func:`_take`, whose backward sums
each row's contributions in a fixed order with no atomics
(:func:`_scatter_rows`): a run is reproducible bit for bit on either
device, which autograd's own scatter-add of an indexing backward is not on
the CPU, and a small table (the pretraining's few dozen character rows)
does not serialise the card on atomic adds. The step makes no host
synchronisation.

Gradient at the acosh clamp. The distances of the losses clamp
``<x,y>_L`` to ``>= 1 + GRAD_EPS`` with ``torch.maximum`` against a
tensor, which splits the gradient at an exact tie as ``jnp.maximum`` does
(``torch.clamp_min`` would pass all of it); the forward value is that of
``lorentz.distance``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from hyptokenizer_tpu_torch.ops import lorentz as L

GRAD_EPS = 1e-6


class GeneratorSampler:
    """The trainers' default draws, from a seeded ``torch.Generator`` on
    ``device``."""

    def __init__(self, seed: Union[int, torch.Generator], device=None):
        if isinstance(seed, torch.Generator):
            self.generator = seed
            self.device = seed.device
        else:
            self.device = torch.device("cpu" if device is None else device)
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(int(seed))

    def randint(self, shape, high: int) -> torch.Tensor:
        return torch.randint(0, int(high), tuple(shape),
                             generator=self.generator, device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)


def _as_sampler(sampler, device):
    if isinstance(sampler, (int, np.integer, torch.Generator)):
        return GeneratorSampler(sampler, device)
    return sampler


def _scatter_rows(n_rows: int, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """(n_rows, d) sums of the rows ``vals`` at ``idx``, the same bits on
    every run, with no atomics and no host synchronisation: a stable sort
    by row, float64 prefix sums, and each row's sum as its run's inclusive
    prefix at the run's end minus the exclusive prefix at its start. Each
    of the two is written by exactly one position; every other position
    writes to a scratch row ``n_rows``, which is dropped."""
    order = torch.argsort(idx, stable=True)
    idx_s = idx[order]
    v = vals[order].to(torch.float64)
    # Scanned along the inner dimension: CUDA scans an outer dimension one
    # thread per column, serially (2-6 ms a step at these shapes).
    csum = torch.cumsum(v.t().contiguous(), dim=1).t()
    start = torch.ones_like(idx_s, dtype=torch.bool)
    start[1:] = idx_s[1:] != idx_s[:-1]
    end = torch.ones_like(start)
    end[:-1] = start[1:]
    scratch = torch.full_like(idx_s, n_rows)
    shape = (n_rows + 1, vals.shape[-1])
    hi = csum.new_zeros(shape).index_put_(
        (torch.where(end, idx_s, scratch),), csum)
    lo = csum.new_zeros(shape).index_put_(
        (torch.where(start, idx_s, scratch),), csum - v)
    return (hi[:n_rows] - lo[:n_rows]).to(vals.dtype)


class _Take(torch.autograd.Function):
    """``table[idx]`` with the deterministic backward of
    :func:`_scatter_rows`."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return _scatter_rows(ctx.n_rows, idx.reshape(-1),
                             grad.reshape(-1, grad.shape[-1])), None


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _Take.apply(table, idx)


def _distance(x: torch.Tensor, y: torch.Tensor, c) -> torch.Tensor:
    """``lorentz.distance`` at ``eps=GRAD_EPS`` with ``jnp.maximum``'s
    gradient at the clamp (module docstring). The constants are filled on
    the device (``new_full``): a host-to-device copy would synchronise."""
    xy = L.minkowski_dot(x, y)
    xy = torch.maximum(xy, xy.new_full((), 1.0 + GRAD_EPS))
    return L.acosh(xy) / torch.sqrt(xy.new_full((), c))


def _ranking_nll(e, u_idx, v_idx, neg_idx, c) -> torch.Tensor:
    """Per-pair ranking NLL of (u, v) against negatives (B,). The rows are
    gathered in one ``_take``, so the backward scatters once."""
    b, k = neg_idx.shape
    rows = _take(e, torch.cat([u_idx, v_idx, neg_idx.reshape(-1)]))
    u, v, n = rows[:b], rows[b:2 * b], rows[2 * b:].reshape(b, k, -1)
    d_pos = _distance(u, v, c)
    d_neg = _distance(u[:, None, :], n, c)
    logits = torch.cat([-d_pos[:, None], -d_neg], dim=1)
    return -torch.log_softmax(logits, dim=1)[:, 0]


def _loss(emb, u_idx, v_idx, neg_idx, c):
    """Mean ranking NLL of the positive pairs (u, v) with negatives
    ``neg_idx`` (B, K)."""
    return torch.mean(_ranking_nll(emb, u_idx, v_idx, neg_idx, c))


def _rsgd_loop(emb0, steps, lr, c, burn_in, draw, loss_fn, reduce=None):
    """The trainers' shared loop: ``draw(k)`` makes step k's indices,
    ``loss_fn(e, drawn)`` its loss; RSGD on the whole table. ``reduce``,
    when given, maps a rank's (loss, gradient) to the sums over the ranks
    (``parallel/sharded.run_embed_train_sharded``)."""
    emb = emb0.detach().to(torch.float32)
    burn_in = burn_in or max(1, steps // 10)
    lr_t = emb.new_tensor(lr)
    lr_burn = lr_t / 10.0
    losses = []
    for k in range(steps):
        drawn = draw(k)
        e = emb.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(e, drawn)
            g, = torch.autograd.grad(loss, e)
        if reduce is not None:
            loss, g = reduce(loss.detach(), g)
        emb = L.rsgd_step(emb, g, lr_burn if k < burn_in else lr_t, c)
        losses.append(loss.detach())
    out = torch.stack(losses) if losses else emb.new_zeros((0,))
    return L.project_to_hyperboloid(emb, c), out


def train_embeddings(emb0: torch.Tensor, corpus: torch.Tensor, vocab_size,
                     sampler, steps: int = 2000, batch: int = 1024,
                     negatives: int = 10, lr: float = 0.3, c: float = 1.0,
                     burn_in: int = 0, part=None):
    """RSGD-train embeddings on adjacent co-occurrence in ``corpus``.

    Args:
      emb0: (max_V, d+1) initial hyperboloid points (only rows <
        vocab_size are trained/used).
      corpus: (N,) int token ids; negatives (PAD/SEP) break adjacency.
      vocab_size: active vocab size (negatives sampled below it).
      sampler: the draws (module docstring): per step, positions
        ``randint((batch,), N-1)`` then negatives
        ``randint((batch, negatives), max(vocab_size, 1))``.
      part: ``(rank, size, reduce)`` to train as one of ``size`` ranks:
        every rank draws the whole batch, takes its ``rank``-th contiguous
        slice of it (the weights' total stays the batch's), and ``reduce``
        sums the loss and the table gradient over the ranks
        (``parallel/sharded.run_embed_train_sharded``).
    Returns: (trained embeddings on the manifold, per-step loss trace).

    A position whose pair touches PAD or SEP becomes a self-pair on token 0
    with weight 0; the mean divides by ``max(sum(w), 1)``. Its gradient is
    0 times a finite number: at ``GRAD_EPS`` the clamped self-distance has
    a finite derivative, so no NaN reaches the table.
    """
    dev = emb0.device
    corpus = torch.as_tensor(corpus).to(dev).long()
    n = corpus.shape[0]
    vhi = max(int(vocab_size), 1)
    sampler = _as_sampler(sampler, dev)

    def draw(_k):
        pos = sampler.randint((batch,), n - 1).to(dev).long()
        u_idx = corpus[pos]
        v_idx = corpus[pos + 1]
        valid = (u_idx >= 0) & (v_idx >= 0)
        u_idx = torch.where(valid, u_idx, 0)
        v_idx = torch.where(valid, v_idx, 0)
        neg = sampler.randint((batch, negatives), vhi).to(dev).long()
        w = valid.to(torch.float32)
        total = torch.sum(w)
        if part is not None:
            lo, hi = _slice_bounds(batch, part[0], part[1])
            u_idx, v_idx, neg, w = (u_idx[lo:hi], v_idx[lo:hi], neg[lo:hi],
                                    w[lo:hi])
        return u_idx, v_idx, neg, w, total

    def loss_fn(e, drawn):
        u_idx, v_idx, neg, w, total = drawn
        nll = _ranking_nll(e, u_idx, v_idx, neg, c)
        return torch.sum(nll * w) / torch.clamp_min(total, 1.0)

    return _rsgd_loop(emb0, steps, lr, c, burn_in, draw, loss_fn,
                      None if part is None else part[2])


def _slice_bounds(n: int, rank: int, size: int):
    """The ``rank``-th of ``size`` contiguous slices of ``range(n)``, the
    first ``n % size`` one longer."""
    q, r = divmod(n, size)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


def train_embeddings_pairs(emb0: torch.Tensor, pairs, weights, neg_pool,
                           sampler, steps: int = 2000, batch: int = 1024,
                           negatives: int = 10, lr: float = 0.3,
                           c: float = 1.0, burn_in: int = 0):
    """RSGD-train embeddings on an explicit positive-pair list.

    ``pairs`` (P, 2) are id pairs that should sit close (WordNet
    hypernym-path pairs, or the merge tree's (child, parent) edges);
    ``weights`` scale each pair's sampling probability (inverse CDF over
    their cumulative sum: ``uniform((batch,))`` times the total, then
    ``searchsorted``); negatives come from ``neg_pool`` through
    ``randint((batch, negatives), len(neg_pool))``. Same ranking NLL as
    :func:`train_embeddings`.
    """
    dev = emb0.device
    pairs = torch.as_tensor(pairs).to(dev).long()
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    neg_pool = torch.as_tensor(neg_pool).to(dev).long()
    n_pairs = pairs.shape[0]
    cw = torch.cumsum(torch.clamp_min(weights, 0.0), dim=0)
    total = cw[-1]
    sampler = _as_sampler(sampler, dev)

    def draw(_k):
        u01 = sampler.uniform((batch,)).to(dev) * total
        idx = torch.clamp(torch.searchsorted(cw, u01), 0, n_pairs - 1)
        neg = neg_pool[sampler.randint((batch, negatives),
                                       neg_pool.shape[0]).to(dev).long()]
        return pairs[idx, 0], pairs[idx, 1], neg

    def loss_fn(e, drawn):
        return _loss(e, *drawn, c)

    return _rsgd_loop(emb0, steps, lr, c, burn_in, draw, loss_fn)


def merge_tree_pairs(merge_history, n_init: int, max_vocab: int):
    """(child, parent) pairs + depth weights from the tokenizer's own merge
    tree — hierarchy supervision that needs no external graph.

    Merge k creates parent id ``n_init + k`` from (i, j): both children get
    an edge to the parent. Weight = 1/(1+depth) with depth = merge-tree
    height of the parent, so near-leaf structure (morpheme-like units)
    dominates over late agglomerations.
    """
    depth = np.zeros((max_vocab,), np.int32)
    pairs = []
    weights = []
    for k, (i, j) in enumerate(merge_history):
        p = n_init + k
        depth[p] = 1 + max(depth[i], depth[j])
        for ch in (i, j):
            pairs.append((ch, p))
            weights.append(1.0 / (1.0 + depth[p]))
    if not pairs:
        return (np.zeros((0, 2), np.int32), np.zeros((0,), np.float32))
    return (np.asarray(pairs, np.int32), np.asarray(weights, np.float32))


def train_embeddings_stress(emb0: torch.Tensor, pairs, targets, sampler,
                            steps: int = 2000, batch: int = 2048,
                            lr: float = 0.1, c: float = 1.0,
                            burn_in: int = 0):
    """RSGD metric-stress training: fit embedding distances to graph
    distances.

    Scale-free stress: per batch the optimal global scale
    ``s* = <d_e, d_g> / <d_g, d_g>`` is substituted (without gradient), and
    the loss is ``mean((d_e - s* d_g)^2 / d_g^2)``. One draw per step:
    ``randint((batch,), P)``.
    """
    dev = emb0.device
    pairs = torch.as_tensor(pairs).to(dev).long()
    targets = torch.as_tensor(targets, dtype=torch.float32).to(dev)
    n_pairs = pairs.shape[0]
    sampler = _as_sampler(sampler, dev)

    def draw(_k):
        idx = sampler.randint((batch,), n_pairs).to(dev).long()
        return pairs[idx, 0], pairs[idx, 1], targets[idx]

    def loss_fn(e, drawn):
        u_idx, v_idx, tg = drawn
        b = u_idx.shape[0]
        rows = _take(e, torch.cat([u_idx, v_idx]))
        d = _distance(rows[:b], rows[b:], c)
        s = (torch.sum(d * tg)
             / torch.clamp_min(torch.sum(tg * tg), 1e-9)).detach()
        return torch.mean(((d - s * tg) / torch.clamp_min(tg, 1e-6)) ** 2)

    return _rsgd_loop(emb0, steps, lr, c, burn_in, draw, loss_fn)


def train_embeddings_ordinal(emb0: torch.Tensor, pairs, targets, sampler,
                             steps: int = 2000, batch: int = 2048,
                             lr: float = 0.1, c: float = 1.0,
                             margin: float = 0.05, burn_in: int = 0):
    """RSGD ordinal-consistency training: rank-order embedding distances by
    graph distances.

    Per step two supervised pairs p, q are drawn (two
    ``randint((batch,), P)``); when ``d_graph(p) < d_graph(q)`` the loss
    is ``softplus(d_emb(p) - d_emb(q) + margin)``, equal-distance draws
    weigh 0.
    """
    dev = emb0.device
    pairs = torch.as_tensor(pairs).to(dev).long()
    targets = torch.as_tensor(targets, dtype=torch.float32).to(dev)
    n_pairs = pairs.shape[0]
    sampler = _as_sampler(sampler, dev)

    def draw(_k):
        ip = sampler.randint((batch,), n_pairs).to(dev).long()
        iq = sampler.randint((batch,), n_pairs).to(dev).long()
        tp, tq = targets[ip], targets[iq]
        swap = tp > tq
        a = torch.where(swap, iq, ip)
        b = torch.where(swap, ip, iq)
        return a, b, (tp != tq).to(torch.float32)

    def loss_fn(e, drawn):
        a, b, w = drawn
        n = a.shape[0]
        rows = _take(e, torch.cat([pairs[a, 0], pairs[a, 1], pairs[b, 0],
                                   pairs[b, 1]]))
        dp = _distance(rows[:n], rows[n:2 * n], c)
        dq = _distance(rows[2 * n:3 * n], rows[3 * n:], c)
        x = dp - dq + margin
        viol = torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus
        return torch.sum(viol * w) / torch.clamp_min(torch.sum(w), 1.0)

    return _rsgd_loop(emb0, steps, lr, c, burn_in, draw, loss_fn)
