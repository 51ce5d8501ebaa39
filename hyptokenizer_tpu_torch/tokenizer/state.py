"""The merge state and the distance-only merge loop.

Port of ``hyptokenizer_tpu/tokenizer/state.py``. ``init_state`` builds the
dense-candidate arrays ``best_dist``/``best_j`` with ``pairwise_min_best``
(kernel K3 on the card, its plain version on the CPU), or, with
``init_candidates=False``, POISONS them (-inf / -1): corpus-only training
never reads them, and ``run_enhanced`` refuses to start a dense
configuration on them. :func:`insert_batch` is the plain version of
``merge_batch``'s inserts and of its column fold.

The distance-only loop: :func:`merge_step` merges the global argmin of
``best_dist`` (:func:`merge_pair`) or runs the adaptive-threshold escape
(:func:`_no_candidate`); :func:`run_merges_plain` loops it, and is the
plain version of kernel K4; :func:`run_merges` launches K4 for a state on
the card and runs the plain version for a state on the CPU.

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
INF = float("inf")


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


class StatsSampler:
    """The draws of :func:`distance_statistics`, from a seeded
    ``torch.Generator`` on the state's device. A test hands the port the
    JAX package's draws instead (``tests/torch_port_common.ReplaySampler``).
    """

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def _randint(self, shape, high: int) -> torch.Tensor:
        return torch.randint(0, high, shape, generator=self.generator,
                             device=self.device, dtype=torch.int32)

    def stats(self, sample_size: int, n: int):
        """``(i, j)``: (sample_size,) ids in [0, n) and in [0, n - 1)."""
        return (self._randint((sample_size,), n),
                self._randint((sample_size,), n - 1))

    def get_state(self) -> torch.Tensor:
        """The generator's state, for a checkpoint (``utils/checkpoint``)."""
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)


def distance_statistics(emb: torch.Tensor, vocab_size, curvature,
                        sampler, sample_size: int = 1000) -> torch.Tensor:
    """min/max/mean/std of ``sample_size`` sampled pairwise distances, as a
    (4,) float32 tensor: pairs (i, j != i) drawn with replacement."""
    n = max(int(vocab_size), 2)
    i, j = sampler.stats(sample_size, n)
    i = i.to(emb.device).long()
    j = j.to(emb.device).long()
    j = torch.where(j >= i, j + 1, j)  # uniform over j != i
    d = L.distance(emb[i], emb[j], curvature)
    return torch.stack([d.min(), d.max(), d.mean(), d.std(unbiased=False)])


def _do_merge(state: MergeState, config: MergeConfig) -> MergeState:
    """Apply the current best merge (the argmin of ``best_dist``, lowest
    index on ties) and update the candidates."""
    i = torch.argmin(state.best_dist)
    return merge_pair(state, i, state.best_j[i], state.best_dist[i],
                      config.max_token_len)


def merge_pair(state: MergeState, i, j, d,
               max_token_len: int = 0) -> MergeState:
    """Merge the pair (i, j) at distance ``d`` into row ``vocab_size`` and
    update the candidates, in place.

    Candidate maintenance is ONE column fold, as in the JAX package
    (``state.merge_pair``, whose docstring proves its structural-exclusion
    invariant): row i is invalidated iff its tracked best was the consumed
    pair (``best_j[i] == j``), then every row r < new_idx that passes the
    length gate takes the new column iff it is strictly closer than its
    best. ``best_j`` therefore always points at an unconsumed column, and a
    consumed pair is never selected again.
    """
    new_idx = int(state.vocab_size)
    nm = int(state.num_merges)
    c = state.curvature
    midpoint_insert(state.emb, state.lengths, i, j, new_idx, c)
    state.merges[nm, 0] = i
    state.merges[nm, 1] = j
    state.merge_dists[nm] = d
    max_v = state.emb.shape[0]
    dev = state.emb.device
    d_new = L.pairwise_dist(state.emb, state.emb[new_idx:new_idx + 1],
                            c)[:, 0]
    ok = torch.arange(max_v, device=dev) < new_idx
    if max_token_len > 0:
        # Structural length gate (MergeConfig.max_token_len).
        ok &= state.lengths + state.lengths[new_idx] <= max_token_len
    d_new = torch.where(ok, d_new, INF)
    tracked = state.best_j[i] == j
    state.best_dist[i] = torch.where(tracked, INF, state.best_dist[i])
    improved = d_new < state.best_dist
    state.best_dist.copy_(torch.where(improved, d_new, state.best_dist))
    state.best_j.copy_(torch.where(improved, new_idx, state.best_j))
    return dataclasses.replace(
        state, vocab_size=state.vocab_size + 1,
        num_merges=state.num_merges + 1,
        empty_rounds=torch.zeros_like(state.empty_rounds))


def _no_candidate(state: MergeState, config: MergeConfig) -> MergeState:
    """The adaptive-threshold escape: x``empty_growth`` after
    ``empty_growth_after`` empty rounds, or, without adaptation, a stop
    after ``empty_stop_after``."""
    empty = state.empty_rounds + 1
    if config.adaptive_threshold:
        grow = empty >= config.empty_growth_after
        threshold = torch.clamp_max(
            torch.where(grow, state.threshold * config.empty_growth,
                        state.threshold), THRESHOLD_CAP)
        empty = torch.where(grow, torch.zeros_like(empty), empty)
        return dataclasses.replace(state, threshold=threshold,
                                   empty_rounds=empty)
    return dataclasses.replace(state, empty_rounds=empty,
                               stopped=empty >= config.empty_stop_after)


def merge_step(state: MergeState, config: MergeConfig) -> MergeState:
    """One step: merge the best candidate, or adapt the threshold; then the
    periodic threshold growth and the capacity stop."""
    best = torch.min(state.best_dist)
    has = bool((best < state.threshold)
               & (state.vocab_size < config.max_vocab_size))
    state = _do_merge(state, config) if has else _no_candidate(state, config)
    step = state.step + 1
    threshold = state.threshold
    if config.adaptive_threshold and config.threshold_growth_every > 0:
        grow = (step % config.threshold_growth_every) == 0
        threshold = torch.clamp_max(
            torch.where(grow, threshold * config.threshold_growth,
                        threshold), THRESHOLD_CAP)
    full = state.vocab_size >= config.max_vocab_size
    return dataclasses.replace(state, step=step, threshold=threshold,
                               stopped=state.stopped | full)


def config_capacity(state: MergeState) -> torch.Tensor:
    """Remaining vocab slots."""
    return state.emb.shape[0] - state.vocab_size


def run_merges_plain(state: MergeState, config: MergeConfig,
                     n_steps: int) -> MergeState:
    """Up to ``n_steps`` merge steps, stopping at ``stopped``: the port of
    the JAX package's ``_run_merges_xla`` and the plain version of kernel
    K4. Updates the buffers in place."""
    start = int(state.step)
    while not bool(state.stopped) and int(state.step) - start < n_steps:
        state = merge_step(state, config)
    return state


def run_merges(state: MergeState, config: MergeConfig,
               n_steps: int) -> MergeState:
    """Up to ``n_steps`` merge steps on the state's own device: kernel K4
    (one launch) for a state on the card, :func:`run_merges_plain` for a
    state on the CPU."""
    if state.emb.device.type == "cpu":
        return run_merges_plain(state, config, n_steps)
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop
    return merge_loop.run_merges_chunk(state, config, n_steps)
