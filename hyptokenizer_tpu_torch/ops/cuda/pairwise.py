"""Kernel K3: per-row best merge candidate over the upper triangle.

Replaces ``hyptokenizer_tpu/ops/pallas/pairwise.py`` ``pairwise_min_best``
(its Pallas ``_kernel``, :44). The kernel is ``csrc/pairwise.cu`` (see the
note at its top for its design and its bound); its plain version is
``tokenizer/search.full_pass_best`` with an empty history.

:func:`pairwise_min_best` launches the kernel for a CUDA tensor and runs
the plain version for a CPU tensor; for a CUDA tensor it launches or
raises, never falls back. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.tokenizer import search

SOURCE = "pairwise"

launches = 0            # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _launcher():
    lib = _build.load(SOURCE)
    fn = lib.pairwise_min_best_launch
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, i, i, i, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return lib


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
    best_dist = torch.full((max_v,), float("inf"), device=emb.device)
    best_j = torch.zeros((max_v,), dtype=torch.int32, device=emb.device)
    rc = lib.pairwise_min_best_launch(
        emb.data_ptr(), best_dist.data_ptr(), best_j.data_ptr(), max_v, d1,
        vocab, float(c), torch.cuda.current_stream(emb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_min_best kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return best_dist, best_j


def pairwise_flops(vocab_size: int, d1: int) -> int:
    """Operations the upper triangle of a V x V gram needs: V(V-1)/2 dot
    products of d1 multiply-adds."""
    return vocab_size * (vocab_size - 1) // 2 * d1 * 2
