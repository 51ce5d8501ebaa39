"""Candidate search: exact per-row best-merge tracking, in PyTorch.

Port of ``hyptokenizer_tpu/tokenizer/search.py``. For every row i the
state keeps ``(best_dist[i], best_j[i])``, the closest unmerged partner
j > i. :func:`full_pass_best` recomputes it for every row in O(V^2 d),
tiled over row blocks of float32 grams (TF32 off, ``_device.py``);
:func:`row_best` and :func:`column_update` are the O(V d) single-row and
single-column updates.

Ties go to the lowest column, as ``jnp.argmin`` breaks them
(``torch.argmin`` returns the first minimal index); a row with no valid
column gets ``(inf, 0)``.

``full_pass_best`` with an empty history is the plain version of kernel
K3 (``ops/cuda/pairwise.py``). With a history and the length gate it is
the candidate re-scan of a loaded tokenizer (``core.py``), which stays in
PyTorch on every device, as the JAX package runs it in XLA everywhere.
"""

from __future__ import annotations

import torch

from hyptokenizer_tpu_torch.ops import lorentz as L

INF = float("inf")


def _row_block_best(emb: torch.Tensor, row_start: int, block: int,
                    n_cols: int, vocab_size: int, c, merges: torch.Tensor,
                    num_merges: int, lengths: torch.Tensor | None = None,
                    max_token_len: int = 0):
    """Best candidate per row for rows [row_start, row_start + block).

    Masks: j > i (upper triangle), j < vocab_size, (i, j) not already merged
    (each history entry (a, b) takes column b from row a), and, when
    ``max_token_len`` > 0 and ``lengths`` is given, pairs whose merged
    token would be longer than the cap. Only the first ``n_cols`` columns
    are formed (the caller passes the active prefix; every column past it
    is masked anyway).
    """
    rows = emb[row_start:row_start + block]
    block = rows.shape[0]
    dev = emb.device
    dists = L.pairwise_dist(rows, emb[:n_cols], c)         # (block, n_cols)
    row_ids = row_start + torch.arange(block, device=dev)[:, None]
    col_ids = torch.arange(n_cols, device=dev)[None, :]
    mask = (col_ids > row_ids) & (col_ids < vocab_size) & (row_ids
                                                           < vocab_size)
    if max_token_len > 0 and lengths is not None:
        row_len = lengths[row_start:row_start + block]
        mask &= (row_len[:, None] + lengths[None, :n_cols]) <= max_token_len
    dists = torch.where(mask, dists, INF)

    hist = merges[:num_merges].long()
    hi, hj = hist[:, 0], hist[:, 1]
    in_block = ((hi >= row_start) & (hi < row_start + block) & (hj >= 0)
                & (hj < n_cols))
    dists[hi[in_block] - row_start, hj[in_block]] = INF

    return dists.min(dim=1).values, torch.argmin(dists, dim=1).to(
        torch.int32)


def full_pass_best(emb: torch.Tensor, vocab_size, c, merges: torch.Tensor,
                   num_merges, block: int = 512,
                   lengths: torch.Tensor | None = None,
                   max_token_len: int = 0):
    """``(best_dist, best_j)`` for every row, tiled over row blocks.

    At most ``block * vocab_size`` distances live at once. Rows at or past
    ``vocab_size`` have no valid column and get ``(inf, 0)``; only the
    active prefix is computed, which gives the same output as the JAX
    package's sweep over the whole buffer.
    """
    max_v = emb.shape[0]
    vocab = int(vocab_size)
    nm = int(num_merges)
    best_dist = torch.full((max_v,), INF, device=emb.device)
    best_j = torch.zeros((max_v,), dtype=torch.int32, device=emb.device)
    n_act = min(vocab, max_v)
    for start in range(0, n_act, block):
        bd, bj = _row_block_best(emb, start, block, n_act, vocab, c, merges,
                                 nm, lengths, max_token_len)
        best_dist[start:start + bd.shape[0]] = bd
        best_j[start:start + bd.shape[0]] = bj
    return best_dist, best_j


def row_best(emb: torch.Tensor, i, vocab_size, c, merges: torch.Tensor,
             num_merges):
    """Best candidate of the single row ``i`` (O(V d))."""
    max_v = emb.shape[0]
    i = int(i)
    dists = L.pairwise_dist(emb[i:i + 1], emb, c)[0]
    col_ids = torch.arange(max_v, device=emb.device)
    dists = torch.where((col_ids > i) & (col_ids < int(vocab_size)), dists,
                        INF)
    hist = merges[:int(num_merges)].long()
    dists[hist[hist[:, 0] == i, 1]] = INF
    return dists.min(), torch.argmin(dists).to(torch.int32)


def column_update(emb: torch.Tensor, new_idx, c, best_dist: torch.Tensor,
                  best_j: torch.Tensor):
    """Fold the new token (column ``new_idx``) into every row's best.

    Every row r < new_idx gains the pair (r, new_idx); rows improve where
    ``dist(r, new) < best_dist[r]`` (strict). O(V d): one matvec.
    """
    max_v = emb.shape[0]
    new_idx = int(new_idx)
    dists = L.pairwise_dist(emb, emb[new_idx:new_idx + 1], c)[:, 0]
    row_ids = torch.arange(max_v, device=emb.device)
    dists = torch.where(row_ids < new_idx, dists, INF)
    improved = dists < best_dist
    return (torch.where(improved, dists, best_dist),
            torch.where(improved, torch.full_like(best_j, new_idx), best_j))
