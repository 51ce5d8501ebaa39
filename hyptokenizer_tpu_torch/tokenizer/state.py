"""The merge state: a dataclass of tensors.

Port of ``hyptokenizer_tpu/tokenizer/state.py`` for the enhanced loop.
``init_state`` builds the dense-candidate arrays ``best_dist``/``best_j``
with ``pairwise_min_best`` (kernel K3 on the card, its plain version on the
CPU), or, with ``init_candidates=False``, POISONS them (-inf / -1):
corpus-only training never reads them, and ``run_enhanced`` refuses to
start a dense configuration on them. :func:`insert_batch` is the plain
version of ``merge_batch``'s inserts and of its column fold. The
distance-only loop (``merge_pair``, ``merge_step``, ``run_merges``) comes
with a later slice.

Scalars are 0-d tensors on the state's device, float32 or int32 as in the
JAX package, so that float32 arithmetic on them (thresholds, curvature)
rounds exactly as it does there.
"""

from __future__ import annotations

import dataclasses

import torch

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.ops import lorentz as L

THRESHOLD_CAP = 1e6


@dataclasses.dataclass(frozen=True)
class MergeConfig:
    """Static configuration of the merge loop (the JAX package's fields)."""

    max_vocab_size: int = 100_000
    adaptive_threshold: bool = True
    threshold_growth_every: int = 1000
    threshold_growth: float = 1.1
    empty_growth_after: int = 6
    empty_growth: float = 1.5
    empty_stop_after: int = 10
    search_block: int = 512
    init_candidates: bool = True
    max_token_len: int = 0


@dataclasses.dataclass
class MergeState:
    """Training state. Buffers are updated in place by the merge steps (the
    JAX package rebuilds them functionally); scalars are replaced."""

    emb: torch.Tensor          # (max_V, d+1) f32 hyperboloid points
    lengths: torch.Tensor      # (max_V,) i32 token string lengths
    best_dist: torch.Tensor    # (max_V,) f32 closest-unmerged-partner distance
    best_j: torch.Tensor       # (max_V,) i32 partner index
    merges: torch.Tensor       # (max_V, 2) i32 merge history, -1 padded
    merge_dists: torch.Tensor  # (max_V,) f32 distance at merge time
    vocab_size: torch.Tensor   # i32 — active prefix length
    num_merges: torch.Tensor   # i32
    step: torch.Tensor         # i32
    threshold: torch.Tensor    # f32
    curvature: torch.Tensor    # f32
    empty_rounds: torch.Tensor  # i32
    stopped: torch.Tensor      # bool


def init_state(emb0, lengths0, *, curvature: float = 1.0,
               threshold: float = 0.1, config: MergeConfig,
               device=None) -> MergeState:
    """Pad the initial vocabulary into ``max_vocab_size`` buffers and run
    the one-time candidate pass (or poison the candidates, see above)."""
    dev = _device.resolve(device)
    emb0 = torch.as_tensor(emb0, dtype=torch.float32).to(dev)
    lengths0 = torch.as_tensor(lengths0, dtype=torch.int32).to(dev)
    max_v = config.max_vocab_size
    n0, d1 = emb0.shape
    if n0 > max_v:
        raise ValueError(f"initial vocab {n0} exceeds max_vocab_size {max_v}")
    emb = torch.zeros((max_v, d1), dtype=torch.float32, device=dev)
    emb[:n0] = emb0
    lengths = torch.zeros((max_v,), dtype=torch.int32, device=dev)
    lengths[:n0] = lengths0

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    c = f32(curvature)
    if config.init_candidates:
        # History is empty at init: kernel K3 applies directly.
        from hyptokenizer_tpu_torch.ops.cuda import pairwise
        best_dist, best_j = pairwise.pairwise_min_best(emb, n0, c)
    else:
        best_dist = torch.full((max_v,), -torch.inf, device=dev)
        best_j = torch.full((max_v,), -1, dtype=torch.int32, device=dev)
    return MergeState(
        emb=emb, lengths=lengths, best_dist=best_dist, best_j=best_j,
        merges=torch.full((max_v, 2), -1, dtype=torch.int32, device=dev),
        merge_dists=torch.zeros((max_v,), dtype=torch.float32, device=dev),
        vocab_size=i32(n0), num_merges=i32(0), step=i32(0),
        threshold=f32(threshold), curvature=c,
        empty_rounds=i32(0),
        stopped=torch.tensor(False, device=dev),
    )


def midpoint_insert(emb: torch.Tensor, lengths: torch.Tensor, i, j,
                    new_idx, c):
    """Write the length-weighted geodesic midpoint of tokens i and j at
    ``new_idx``, re-projected onto the sheet (in place; returns the
    buffers)."""
    len_i = lengths[i]
    len_j = lengths[j]
    w_j = len_j.float() / torch.clamp_min(len_i + len_j, 1).float()
    emb[new_idx] = L.project_to_hyperboloid(
        L.geodesic_point(emb[i], emb[j], w_j), c)
    lengths[new_idx] = len_i + len_j
    return emb, lengths


def insert_batch(state: MergeState, ii: torch.Tensor, jj: torch.Tensor,
                 dd: torch.Tensor, fold: bool = False,
                 max_token_len: int = 0) -> MergeState:
    """Merge the pairs (ii[k], jj[k]) into slots vocab_size + k, in place.

    ``state.merge_batch`` of the JAX package for a batch that is all valid
    and fits the remaining capacity. Midpoints come from the pre-batch rows
    (no pair of a batch refers to a token made in the same batch).

    With ``fold`` (the dense channel) the candidate arrays are maintained as
    there: rows whose tracked best was consumed are set to inf, then every
    row r gains the new columns slot > r that pass the length gate, with
    ties to the lowest new column and a strict ``<`` against the row's
    best. Without it (corpus-only states, whose candidate arrays are
    poisoned and never read) the fold is skipped, as the TPU kernel skips
    it.
    """
    n = ii.shape[0]
    dev = state.emb.device
    slot = state.vocab_size.long() + torch.arange(n, device=dev)
    hist = state.num_merges.long() + torch.arange(n, device=dev)
    len_i = state.lengths[ii]
    len_j = state.lengths[jj]
    w_j = len_j.float() / torch.clamp_min(len_i + len_j, 1).float()
    x_new = L.project_to_hyperboloid(
        L.geodesic_point(state.emb[ii], state.emb[jj], w_j), state.curvature)
    state.emb[slot] = x_new
    state.lengths[slot] = len_i + len_j
    state.merges[hist] = torch.stack([ii, jj], dim=-1).to(torch.int32)
    state.merge_dists[hist] = dd
    if fold:
        _fold_columns(state, ii, jj, slot, max_token_len)
    return dataclasses.replace(
        state, vocab_size=state.vocab_size + n,
        num_merges=state.num_merges + n,
        empty_rounds=torch.zeros_like(state.empty_rounds))


def _fold_columns(state: MergeState, ii: torch.Tensor, jj: torch.Tensor,
                  slot: torch.Tensor, max_token_len: int) -> None:
    """``merge_batch``'s invalidation and batched column fold, in place, on
    rows below the post-batch vocabulary (no other row can gain)."""
    ii = ii.long()
    tracked = state.best_j[ii] == jj.to(torch.int32)     # pre-batch best_j
    state.best_dist[ii[tracked]] = torch.inf
    v_post = int(slot[-1]) + 1
    dev = state.emb.device
    g = L.pairwise_dist(state.emb[:v_post], state.emb[slot],
                        state.curvature)                  # (v_post, n)
    ok = torch.arange(v_post, device=dev)[:, None] < slot[None, :]
    if max_token_len > 0:
        ok &= (state.lengths[:v_post, None] + state.lengths[slot][None, :]
               <= max_token_len)
    g = torch.where(ok, g, torch.inf)
    col_min = g.min(dim=1).values
    col_arg = slot[torch.argmin(g, dim=1)].to(torch.int32)
    improved = col_min < state.best_dist[:v_post]
    state.best_dist[:v_post] = torch.where(improved, col_min,
                                           state.best_dist[:v_post])
    state.best_j[:v_post] = torch.where(improved, col_arg,
                                        state.best_j[:v_post])
