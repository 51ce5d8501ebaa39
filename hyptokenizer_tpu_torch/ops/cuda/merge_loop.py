"""Kernel K4: a chunk of the distance-only merge loop in one launch.

Replaces ``hyptokenizer_tpu/ops/pallas/merge_loop.py`` (its Pallas
``_kernel``, :81, launched by ``run_merges_chunk``, :348). The kernel is
``csrc/merge_loop.cu`` (see the note at its top for its design and its
bound); its plain version is ``tokenizer/state.run_merges_plain``.
:func:`smem_plan` decides how many of a block's owned rows the kernel
keeps in shared memory.

:func:`run_merges_chunk` launches the kernel for a state on the card; for a
CUDA state it launches or raises, never falls back (``state.run_merges``
takes the plain version for a CPU state). ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from hyptokenizer_tpu_torch.ops.cuda import _build

SOURCE = "merge_loop"
SMEM_LIMIT = 232_448    # shared memory a block may use on sm_90 (227 KB)
SMEM_RESERVE = 1024     # kept for the kernel's static shared memory
SMEM_ROW_MAX = 8192     # the new row sits in shared memory up to this d1
CHUNK = 32              # rows per ownership chunk (common.cuh kOwnChunk)

launches = 0            # kernel launches since the last reset_launches()
_SMS: dict = {}         # device index -> SM count (the grid: one block each)
_FITS: dict = {}        # (device index, dynamic smem bytes) -> checked


def reset_launches() -> None:
    global launches
    launches = 0


@dataclasses.dataclass(frozen=True)
class SmemPlan:
    """How K4 lays a block's owned rows out in dynamic shared memory."""

    owned: int        # most rows one block owns
    resident: int     # owned rows kept in shared memory, in whole chunks
    stride: int       # floats per resident row: d1 rounded up to 4 mod 8
    row_floats: int   # the new row's floats in shared memory (0: global)
    bytes: int        # dynamic shared memory per block


def smem_plan(max_v: int, d1: int, n_sms: int) -> SmemPlan:
    """The shared-memory plan of K4 for ``max_v`` slots of ``d1`` floats
    over a grid of ``n_sms`` blocks: each block keeps as many of its owned
    rows as fit, in whole 32-row ownership chunks: their coordinates at a
    stride of 4 mod 8 floats (so that a thread per row reads 16 bytes at a
    time without bank conflicts), then best_dist, best_j and the length;
    beside them the fold's copy of the new row (one stride) and the new
    row itself (in shared memory up to ``SMEM_ROW_MAX`` coordinates). The
    rest stay in global memory."""
    chunks = -(-max_v // CHUNK)
    owned = -(-chunks // n_sms) * CHUNK
    stride = -(-d1 // 4) * 4
    stride += 4 if stride % 8 == 0 else 0
    row_floats = d1 if d1 <= SMEM_ROW_MAX else 0
    per_row = stride * 4 + 3 * 4
    room = max(SMEM_LIMIT - SMEM_RESERVE - row_floats * 4 - stride * 4, 0)
    resident = min(owned, room // per_row // CHUNK * CHUNK)
    fold_row = stride if resident else 0
    return SmemPlan(owned=owned, resident=resident, stride=stride,
                    row_floats=row_floats,
                    bytes=(row_floats + fold_row) * 4 + resident * per_row)


def _launcher():
    lib = _build.load(SOURCE)
    fn = lib.merge_loop_launch
    if fn.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr] * 13 + [i] * 8 + [f, i, f, i] + [i] * 4 + [ptr]
        fn.restype = ctypes.c_int
        lib.merge_loop_sm_count.argtypes = []
        lib.merge_loop_sm_count.restype = ctypes.c_int
        lib.merge_loop_blocks_per_sm.argtypes = [i]
        lib.merge_loop_blocks_per_sm.restype = ctypes.c_int
    return lib


def _check_state(state) -> None:
    want = {"emb": torch.float32, "lengths": torch.int32,
            "best_dist": torch.float32, "best_j": torch.int32,
            "merges": torch.int32, "merge_dists": torch.float32}
    for name, dtype in want.items():
        t = getattr(state, name)
        if t.device.type != "cuda" or t.dtype != dtype or \
                not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    max_v = state.emb.shape[0]
    if state.merges.shape != (max_v, 2) or any(
            getattr(state, n).shape != (max_v,)
            for n in ("lengths", "best_dist", "best_j", "merge_dists")):
        raise ValueError("state buffers must all have max_vocab_size rows")


def grid_size(device: torch.device) -> int:
    """Blocks of K4's cooperative grid on ``device``: one per SM."""
    key = device.index
    if key not in _SMS:
        with torch.cuda.device(device):
            n = _launcher().merge_loop_sm_count()
        if n < 1:
            raise RuntimeError("merge_loop: the SM count query failed")
        _SMS[key] = n
    return _SMS[key]


def _check_fits(device: torch.device, smem: int) -> None:
    """Allow ``smem`` bytes of dynamic shared memory and check that an SM
    holds a block of that size; raises if either fails."""
    key = (device.index, smem)
    if key not in _FITS:
        with torch.cuda.device(device):
            per_sm = _launcher().merge_loop_blocks_per_sm(smem)
        if per_sm < 1:
            raise RuntimeError(
                f"merge_loop: a block with {smem} B of dynamic shared memory "
                f"does not fit an SM (occupancy query returned {per_sm})")
        _FITS[key] = True


def run_merges_chunk(state, config, n_steps: int):
    """Up to ``n_steps`` merge steps of ``state`` (on the card) in one
    launch of K4, in place; the loop scalars come back as 0-d tensors on
    the card, with no host synchronisation."""
    global launches
    _check_state(state)
    if n_steps <= 0:
        return state
    dev = state.emb.device
    max_v, d1 = state.emb.shape
    g = grid_size(dev)
    plan = smem_plan(max_v, d1, g)
    _check_fits(dev, plan.bytes)
    si = torch.stack([state.vocab_size, state.num_merges, state.step,
                      state.empty_rounds, state.stopped.int()]).int()
    sf = torch.stack([state.threshold, state.curvature]).float()
    part_v = torch.empty((2 * g,), dtype=torch.float32, device=dev)
    part_ij = torch.empty((2, 2 * g), dtype=torch.int32, device=dev)
    barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    # Each block's copy of the new row, for rows too wide for shared memory.
    x_scratch = torch.empty((g * d1 if not plan.row_floats else 1,),
                            dtype=torch.float32, device=dev)
    rc = _launcher().merge_loop_launch(
        state.emb.data_ptr(), state.lengths.data_ptr(),
        state.best_dist.data_ptr(), state.best_j.data_ptr(),
        state.merges.data_ptr(), state.merge_dists.data_ptr(),
        si.data_ptr(), sf.data_ptr(), part_v.data_ptr(),
        part_ij[0].data_ptr(), part_ij[1].data_ptr(), barrier.data_ptr(),
        x_scratch.data_ptr(), g, max_v, d1, config.max_vocab_size, n_steps,
        config.max_token_len, int(config.adaptive_threshold),
        config.threshold_growth_every, config.threshold_growth,
        config.empty_growth_after, config.empty_growth,
        config.empty_stop_after, plan.resident, plan.stride,
        plan.row_floats, plan.bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"merge_loop kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return dataclasses.replace(
        state, vocab_size=si[0], num_merges=si[1], step=si[2],
        empty_rounds=si[3], stopped=si[4].bool(), threshold=sf[0])


def chunk_bytes(vocab0: int, n_merges: int, d1: int, max_v: int,
                max_token_len: int = 0) -> int:
    """Bytes a chunk from an active prefix of ``vocab0`` rows that made
    ``n_merges`` merges must move, each input read once and each output
    written once, whatever the kernel reads again: the active rows'
    coordinates; ``best_dist`` over all ``max_v`` slots (the argmin's
    domain) and ``best_j`` over the final prefix, each read and written
    back; the lengths of the active rows with the length gate, else of the
    merged pairs' rows; the new rows, their lengths and the history (pair
    and distance) written."""
    v1 = vocab0 + n_merges
    lengths = vocab0 if max_token_len > 0 else min(vocab0, 2 * n_merges)
    return (vocab0 * d1 * 4 + max_v * 4 + v1 * 4 + v1 * 8 + lengths * 4
            + n_merges * (d1 * 4 + 4 + 8 + 4))


def chunk_bytes_rereading(vocab0: int, n_merges: int, n_steps: int, d1: int,
                          max_v: int, max_token_len: int = 0) -> int:
    """The traffic of a kernel that keeps nothing on chip between steps:
    every step's argmin reads all ``max_v`` entries of ``best_dist``, and
    the k-th merge's fold reads each of its vocab0 + k rows (coordinates,
    ``best_j``, and the length with the length gate) and writes its
    ``best_dist``/``best_j``. For the reader; not a bound."""
    per_row = d1 * 4 + 4 + 8 + (4 if max_token_len > 0 else 0)
    rows = n_merges * vocab0 + n_merges * (n_merges - 1) // 2
    return n_steps * max_v * 4 + rows * per_row + n_merges * (d1 * 4 + 16)


def chunk_ops(vocab0: int, n_merges: int, n_steps: int, d1: int) -> int:
    """Operations a chunk needs on its data: the k-th merge's fold takes a
    d1-long Minkowski dot (2 d1 FLOP) and an acosh (counted as 8) for each
    of its vocab0 + k rows, and every step's argmin compares at least the
    ``vocab0`` active entries."""
    rows = n_merges * vocab0 + n_merges * (n_merges - 1) // 2
    return rows * (2 * d1 + 8) + n_steps * vocab0
