"""Kernel K4: a chunk of the distance-only merge loop in one launch.

Replaces ``hyptokenizer_tpu/ops/pallas/merge_loop.py`` (its Pallas
``_kernel``, :81, launched by ``run_merges_chunk``, :348). The kernel is
``csrc/merge_loop.cu`` (see the note at its top for its design and its
bound); its plain version is ``tokenizer/state.run_merges_plain``.

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

launches = 0            # kernel launches since the last reset_launches()
_GRID: dict = {}        # (device index, d1) -> blocks of the cooperative grid


def reset_launches() -> None:
    global launches
    launches = 0


def _launcher():
    lib = _build.load(SOURCE)
    fn = lib.merge_loop_launch
    if fn.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr] * 13 + [i] * 8 + [f, i, f, i, ptr]
        fn.restype = ctypes.c_int
        lib.merge_loop_grid_size.argtypes = [i]
        lib.merge_loop_grid_size.restype = ctypes.c_int
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


def grid_size(device: torch.device, d1: int) -> int:
    """Blocks of K4's cooperative grid on ``device``: the occupancy query
    times the SM count."""
    key = (device.index, d1)
    if key not in _GRID:
        with torch.cuda.device(device):
            g = _launcher().merge_loop_grid_size(d1)
        if g < 1:
            raise RuntimeError("merge_loop: the occupancy query failed")
        _GRID[key] = g
    return _GRID[key]


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
    g = grid_size(dev, d1)
    si = torch.stack([state.vocab_size, state.num_merges, state.step,
                      state.empty_rounds, state.stopped.int()]).int()
    sf = torch.stack([state.threshold, state.curvature]).float()
    part_v = torch.empty((2 * g,), dtype=torch.float32, device=dev)
    part_ij = torch.empty((2, 2 * g), dtype=torch.int32, device=dev)
    barrier = torch.zeros((2,), dtype=torch.int32, device=dev)
    # Each block's copy of the new row, for rows too wide for shared memory.
    x_scratch = torch.empty((g * d1,), dtype=torch.float32, device=dev)
    lib = _launcher()
    rc = lib.merge_loop_launch(
        state.emb.data_ptr(), state.lengths.data_ptr(),
        state.best_dist.data_ptr(), state.best_j.data_ptr(),
        state.merges.data_ptr(), state.merge_dists.data_ptr(),
        si.data_ptr(), sf.data_ptr(), part_v.data_ptr(),
        part_ij[0].data_ptr(), part_ij[1].data_ptr(), barrier.data_ptr(),
        x_scratch.data_ptr(), g, max_v, d1, config.max_vocab_size, n_steps, config.max_token_len,
        int(config.adaptive_threshold), config.threshold_growth_every,
        config.threshold_growth, config.empty_growth_after,
        config.empty_growth, config.empty_stop_after,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"merge_loop kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return dataclasses.replace(
        state, vocab_size=si[0], num_merges=si[1], step=si[2],
        empty_rounds=si[3], stopped=si[4].bool(), threshold=sf[0])


def chunk_bytes(vocab0: int, n_merges: int, n_steps: int, d1: int,
                max_v: int, max_token_len: int = 0) -> int:
    """Bytes a chunk of ``n_steps`` steps from an active prefix of
    ``vocab0`` rows that made ``n_merges`` merges must move, each input read
    once and each output written once: every step's argmin reads all
    ``max_v`` entries of ``best_dist``; the k-th merge's fold reads each of
    its vocab0 + k rows (coordinates, ``best_j``, and the length with the
    length gate) and writes its ``best_dist``/``best_j``, and writes the new
    row and its bookkeeping (length, history pair, distance)."""
    per_row = d1 * 4 + 4 + 8 + (4 if max_token_len > 0 else 0)
    rows = n_merges * vocab0 + n_merges * (n_merges - 1) // 2
    return n_steps * max_v * 4 + rows * per_row + n_merges * (d1 * 4 + 16)
