"""The corpus replay's selection on the card: the run-parity take and one
round of the priority matching, one kernel launch each.

Replaces no ``pl.pallas_call``: the JAX package takes the parity with
XLA's scan ``blocked_cummax`` (``hyptokenizer_tpu/tokenizer/scoring.py``
:141, in ``batch_rank_replay`` :569 and the fixpoint replay :502). The
kernel is ``csrc/replay_select.cu`` (see the note at its top for its
design and its bound); its plain versions are
``tokenizer/scoring.parity_take_plain`` and ``matching_round_plain``.

:func:`parity_take` and :func:`matching_round` launch the kernel for CUDA
tensors, or raise; they never fall back (``scoring`` takes the plain
versions for CPU tensors). ``launches`` counts kernel launches; while a
profiler records, each launch also counts ``replay.select_launches``
(``utils/metrics.py``).
"""

from __future__ import annotations

import ctypes

import torch

from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.utils import metrics

SOURCE = "replay_select"
TILE = 4096             # entries a block takes (csrc kTile)
MAX_N = 2**31 - 1 - 2 * TILE   # int32 indices past the last tile's halo
_HEAD = 4               # scratch words before the tiles' status words

launches = 0            # kernel launches since the last reset_launches()
# (device index, stream) -> int32 scratch, zero between launches (the
# kernel's last block zeroes it again); launches that share one are ordered
# by their stream.
_SCRATCH: dict = {}


def reset_launches() -> None:
    global launches
    launches = 0


def _launcher():
    lib = _build.load(SOURCE)
    if lib.replay_select_round_launch.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.replay_select_take_launch.argtypes = [ptr, ptr, i, ptr, ptr]
        lib.replay_select_take_launch.restype = ctypes.c_int
        lib.replay_select_round_launch.argtypes = [ptr] * 5 + [i, ptr, ptr]
        lib.replay_select_round_launch.restype = ctypes.c_int
        lib.replay_select_tile.argtypes = []
        lib.replay_select_tile.restype = ctypes.c_int
        if lib.replay_select_tile() != TILE:
            raise RuntimeError("replay_select: the library's tile is not "
                               f"{TILE}")
    return lib


def _check(name: str, t: torch.Tensor, dtype, n: int = None) -> int:
    """Raise unless ``t`` is what the kernel reads (a contiguous, 16-byte
    aligned 1-D ``dtype`` CUDA tensor of ``n`` entries, if given); returns
    its length."""
    if t.device.type != "cuda" or t.dtype != dtype or t.dim() != 1 or \
            not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 1-D {dtype} CUDA "
                         f"tensor, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: {t.shape[0]} entries, expected {n}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16 bytes at a time and "
                         f"needs a 16-byte aligned start")
    if t.shape[0] > MAX_N:
        raise ValueError(f"{name}: {t.shape[0]} entries, at most {MAX_N}")
    return t.shape[0]


def _scratch_and_stream(t: torch.Tensor) -> tuple:
    stream = torch.cuda.current_stream(t.device).cuda_stream
    key = (t.device.index, stream)
    words = _HEAD + max(-(-t.shape[0] // TILE), 1)
    buf = _SCRATCH.get(key)
    if buf is None or buf.shape[0] < words:
        buf = torch.zeros((max(words, 1024),), dtype=torch.int32,
                          device=t.device)
        _SCRATCH[key] = buf
    return buf.data_ptr(), stream


def _launched(rc: int) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"replay_select kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    metrics.count("replay.select_launches")


def parity_take(m: torch.Tensor) -> torch.Tensor:
    """Within each run of True in the bool mask ``m``, every other entry
    from the run head, in one launch."""
    n = _check("m", m, torch.bool)
    out = torch.empty_like(m)
    scratch, stream = _scratch_and_stream(m)
    _launched(_launcher().replay_select_take_launch(
        m.data_ptr(), out.data_ptr(), n, scratch, stream))
    return out


def matching_round(alive: torch.Tensor, pri: torch.Tensor,
                   sel: torch.Tensor) -> tuple:
    """One round of the priority matching, in one launch: the alive local
    minima of ``pri``, every other one of each run of them, join ``sel``
    (in place). Returns the entries still alive (new tensor) and whether
    any is, as a 0-d int32 tensor on the card (no host synchronisation)."""
    n = _check("alive", alive, torch.bool)
    _check("pri", pri, torch.int32, n)
    _check("sel", sel, torch.bool, n)
    out = torch.empty_like(alive)
    flag = torch.empty((), dtype=torch.int32, device=alive.device)
    scratch, stream = _scratch_and_stream(alive)
    _launched(_launcher().replay_select_round_launch(
        alive.data_ptr(), pri.data_ptr(), sel.data_ptr(), out.data_ptr(),
        flag.data_ptr(), n, scratch, stream))
    return out, flag
