"""The plain reference of the embedding pretraining, in PyTorch.

Hyperbolic skip-gram on adjacent characters (HypTokenizer's co-occurrence
pretraining, as this repository's README Quick start runs it with
``--embed-steps``): each step draws ``batch`` corpus positions and
``negatives`` random ids per position, takes the mean over the positions
whose pair lies inside a line of ``-log softmax([-d(u, v), -d(u, n_1),
...])[0]``, and moves the whole table one Riemannian SGD step, at a tenth
of the rate for the first tenth of the steps; the table is re-projected
at the end. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference import geometry as G


def train(emb0: torch.Tensor, corpus: torch.Tensor, vocab_size: int, draws,
          steps: int, batch: int, negatives: int, lr: float,
          dtype=torch.float32):
    """Returns (table, per-step losses). Draws positions then negatives
    from ``draws`` at every step, in that order. The table is held in
    ``dtype`` between steps; each step's arithmetic is float32 (float32
    arithmetic throughout at ``dtype`` float32)."""
    emb = emb0.to(dtype)
    corpus = corpus.long()
    n = corpus.shape[0]
    burn = max(1, steps // 10)
    losses = []
    for k in range(steps):
        pos = draws.randint((batch,), n - 1)
        u, v = corpus[pos], corpus[pos + 1]
        ok = (u >= 0) & (v >= 0)
        u = torch.where(ok, u, 0)
        v = torch.where(ok, v, 0)
        neg = draws.randint((batch, negatives), max(vocab_size, 1))
        w = ok.float()
        e = emb.detach().float().requires_grad_(True)
        with torch.enable_grad():
            d_pos = G.grad_distance(e[u], e[v], 1.0)
            d_neg = G.grad_distance(e[u][:, None, :], e[neg], 1.0)
            logits = torch.cat([-d_pos[:, None], -d_neg], dim=1)
            nll = -torch.log_softmax(logits, dim=1)[:, 0]
            loss = (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)
            g, = torch.autograd.grad(loss, e)
        emb = G.rsgd_step(e.detach(), g, lr / 10.0 if k < burn else lr
                          ).to(dtype)
        losses.append(loss.detach())
    return G.project(emb.float(), 1.0), torch.stack(losses)
