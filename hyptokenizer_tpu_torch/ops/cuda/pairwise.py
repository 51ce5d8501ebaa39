"""Kernel K3: per-row best merge candidate over the upper triangle.

Replaces ``hyptokenizer_tpu/ops/pallas/pairwise.py`` ``pairwise_min_best``
(its Pallas ``_kernel``, :44). The kernel is ``csrc/pairwise.cu`` (see the
note at its top for its design and its bound); its plain version is
``tokenizer/search.full_pass_best`` with an empty history.
:func:`tile_plan` lays out the tensor-core path's operands and work items;
:func:`tf32_round`, :func:`split_tf32` and :func:`split_gram` are the
3xTF32 split in plain PyTorch, for the tests.

:func:`pairwise_min_best` launches the kernel for a CUDA tensor and runs
the plain version for a CPU tensor; for a CUDA tensor it launches or
raises, never falls back. ``launches`` counts its calls on the card (each
one launch of the kernel, with its pre-pass and finishing pass on the
tensor-core path).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.tokenizer import search

SOURCE = "pairwise"
ROW_TILE = 128          # rows of a work item (csrc kRowTile)
COL_TILE = 64           # columns of a streamed tile (csrc kColTile)
STEP = 8                # coordinates per tensor-core product
TC_MAX_DEPTH = 112      # padded d+1 whose tiles fit shared memory
SUB_ROWS = 64           # rows of a block of the split layout (kSubRows)
MIN_CHUNK = 4           # fewest column tiles in a work item
ITEMS_PER_SM = 4        # work items per SM the plan aims at

launches = 0            # kernel launches since the last reset_launches()
_SMS: dict = {}         # device index -> SM count


def reset_launches() -> None:
    global launches
    launches = 0


def _launcher():
    lib = _build.load(SOURCE)
    fn = lib.pairwise_min_best_launch
    if fn.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr, ptr, ptr, i, i, i, f, ptr]
        fn.restype = ctypes.c_int
        lib.pairwise_tc_launch.argtypes = [ptr, ptr, ptr, i, i, f] + \
            [ptr] * 4 + [i, ptr, i, i, i, ptr]
        lib.pairwise_tc_launch.restype = ctypes.c_int
    return lib


def _items(plan: TilePlan, device: torch.device):
    """The plan's work items on the card, (n, 3) int32, kept with the
    cached plan."""
    if device.index not in plan.on_card:
        plan.on_card[device.index] = torch.tensor(
            plan.items, dtype=torch.int32, device=device).reshape(-1, 3)
    return plan.on_card[device.index]


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How K3's tensor-core path covers the upper triangle."""

    tensor_cores: bool   # depth <= TC_MAX_DEPTH (else the FFMA kernel)
    depth: int           # d+1 rounded up to STEP, zero-padded
    rows: int            # active rows rounded up to ROW_TILE, zero-padded
    row_tiles: int       # rows // ROW_TILE
    col_tiles: int       # COL_TILE-column tiles holding the active rows
    chunk: int           # column tiles per work item (at most)
    items: tuple         # (row tile, first, end column tile), largest first
    scratch_bytes: int   # hi and lo (rows x depth floats), keys, counter
    smem_bytes: int      # dynamic shared memory per block
    on_card: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)  # device -> items tensor


@functools.lru_cache(maxsize=64)
def tile_plan(vocab: int, d1: int, n_sms: int) -> TilePlan:
    """The tensor-core path's plan for ``vocab`` active rows of ``d1``
    coordinates on ``n_sms`` SMs. Row tile ``rt`` meets the column tiles
    from ``2 rt`` (the first holding a column above one of its rows) to the
    last active one, cut into work items of at most ``chunk`` tiles, so
    that the card holds about ``ITEMS_PER_SM`` items per SM; the blocks take
    them largest first. A block keeps a row tile (hi and lo) and two stages
    of a column tile in shared memory: 8 blocks of ``SUB_ROWS`` x depth
    floats."""
    depth = -(-d1 // STEP) * STEP
    rows = -(-vocab // ROW_TILE) * ROW_TILE
    row_tiles = rows // ROW_TILE
    col_tiles = -(-vocab // COL_TILE)
    spans = [(rt, 2 * rt, col_tiles) for rt in range(row_tiles)
             if 2 * rt < col_tiles]
    total = sum(end - first for _, first, end in spans)
    chunk = max(MIN_CHUNK, -(-total // (ITEMS_PER_SM * max(1, n_sms))))
    items = [(rt, c, min(c + chunk, end)) for rt, first, end in spans
             for c in range(first, end, chunk)]
    items.sort(key=lambda it: (it[1] - it[2], it[0], it[1]))
    return TilePlan(
        tensor_cores=depth <= TC_MAX_DEPTH, depth=depth, rows=rows,
        row_tiles=row_tiles, col_tiles=col_tiles, chunk=chunk,
        items=tuple(items),
        scratch_bytes=2 * rows * depth * 4 + rows * 8 + 4,
        smem_bytes=8 * SUB_ROWS * depth * 4)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` in plain PyTorch: float32 rounded to 10 stored
    mantissa bits, to nearest with ties away from zero (add half of the 13
    dropped bits to the magnitude, then clear them)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); hi + lo is x to within
    2^-22 of |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def split_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The Minkowski gram <x_i, y_j>_L from the 3xTF32 split as the kernel
    forms it, lo*hi + hi*lo + hi*hi with lo*lo dropped, each product
    summed exactly (float64). It differs from the exact gram by at most
    :func:`split_error_bound`; the kernel adds its fp32 sum's rounding."""
    sig = torch.ones(x.shape[-1], dtype=torch.float64, device=x.device)
    sig[1:] = -1.0
    xh, xl = split_tf32(x)
    yh, yl = split_tf32(y)

    def prod(a, b):
        return (a.double() * sig) @ b.double().T

    return prod(xl, yh) + prod(xh, yl) + prod(xh, yh)


def split_error_bound(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per gram entry, 3.01 * 2^-22 * sum_e |x_e y_e|: hi + lo leaves out
    at most 2^-22 of each operand and lo*lo is at most 2^-22 of the
    product (the 0.01 covers the second-order terms)."""
    return 3.01 * 2.0 ** -22 * (x.double().abs() @ y.double().abs().T)


def pairwise_min_best_plain(emb: torch.Tensor, vocab_size, c):
    """The plain version: ``full_pass_best`` with an empty history."""
    empty = torch.empty((0, 2), dtype=torch.int32, device=emb.device)
    return search.full_pass_best(emb, vocab_size, c, empty, 0)


def pairwise_min_best(emb: torch.Tensor, vocab_size, c):
    """``(best_dist, best_j)``: (max_V,) float32 / int32, the contract of
    ``search.full_pass_best`` with an empty history. Kernel K3 for a CUDA
    ``emb``, the plain version for a CPU one."""
    if emb.device.type == "cpu":
        return pairwise_min_best_plain(emb, vocab_size, c)
    global launches
    if emb.dtype != torch.float32 or emb.ndim != 2 or \
            not emb.is_contiguous():
        raise ValueError(f"emb: need a contiguous (max_V, d+1) float32 CUDA "
                         f"tensor, got {emb.dtype} {tuple(emb.shape)}")
    max_v, d1 = emb.shape
    vocab = int(vocab_size)
    if not 0 <= vocab <= max_v:
        raise ValueError(f"vocab_size {vocab} outside [0, {max_v}]")
    lib = _launcher()
    dev = emb.device
    best_dist = torch.full((max_v,), float("inf"), device=dev)
    best_j = torch.zeros((max_v,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    sms = _SMS[dev.index]
    plan = tile_plan(vocab, d1, sms)
    if plan.tensor_cores and vocab > 0:
        items = _items(plan, dev)
        # One scratch buffer: hi, lo (rows x depth floats each), the keys
        # (8-byte aligned: rows is a multiple of ROW_TILE), the counter.
        scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8,
                              device=dev)
        hi = scratch.data_ptr()
        lo = hi + plan.rows * plan.depth * 4
        keys = lo + plan.rows * plan.depth * 4
        rc = lib.pairwise_tc_launch(
            emb.data_ptr(), best_dist.data_ptr(), best_j.data_ptr(), d1,
            vocab, float(c), hi, lo, keys, items.data_ptr(),
            items.shape[0], keys + plan.rows * 8, plan.rows, plan.depth,
            min(items.shape[0], sms), stream)
    else:
        rc = lib.pairwise_min_best_launch(
            emb.data_ptr(), best_dist.data_ptr(), best_j.data_ptr(), max_v,
            d1, vocab, float(c), stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_min_best kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return best_dist, best_j


def pairwise_flops(vocab_size: int, d1: int) -> int:
    """Operations the upper triangle of a V x V gram needs: V(V-1)/2 dot
    products of d1 multiply-adds."""
    return vocab_size * (vocab_size - 1) // 2 * d1 * 2
