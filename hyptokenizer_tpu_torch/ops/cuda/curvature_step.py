"""The curvature Adam step on the card: the loss's curvature gradient in
closed form, the Adam update and the rescale of the cached distances, with
no read back to the host (kernel C1).

Replaces no ``pl.pallas_call``: the JAX package takes the step with XLA ops
in ``_maybe_update_curvature`` (``hyptokenizer_tpu/tokenizer/
enhanced_state.py`` :427-445, ``jax.grad`` and the Adam update). The kernel
is ``csrc/curvature_step.cu`` (see the note at its top for the closed form,
its design and its bound); its plain version is
``tokenizer/enhanced_state.curvature_adam_plain``.

:func:`step` launches the kernel for CUDA tensors, or raises; it never falls
back (``enhanced_state._maybe_update_curvature`` takes the plain version for
CPU tensors). A step is two kernel launches (the loss's terms, then the
update); ``launches`` counts steps, and while a profiler records each step
also counts ``curvature.kernel_launches`` (``utils/metrics.py``).
"""

from __future__ import annotations

import ctypes

import torch

from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.utils import metrics

SOURCE = "curvature_step"

launches = 0            # steps launched since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _launcher():
    lib = _build.load(SOURCE)
    if lib.curvature_step_launch.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.curvature_step_launch.argtypes = ([ptr] * 20 + [i] * 6
                                              + [f] * 5 + [ptr])
        lib.curvature_step_launch.restype = ctypes.c_int
    return lib


def _launched(rc: int) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"curvature_step kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    metrics.count("curvature.kernel_launches")


def step(emb, merges, num_merges, negs, ii, jj, curvature, curv_m, curv_v,
         curv_t, best_dist, q_dist, *, hierarchy_weight: float,
         distortion_weight: float, lr: float, curvature_min: float,
         curvature_max: float) -> tuple:
    """One curvature Adam step from the draws ``negs`` (hp, hn), ``ii`` and
    ``jj`` (ds,): fresh ``(curvature, curv_m, curv_v, curv_t, curv_last,
    best_dist, q_dist)``, with ``curv_t`` one up, ``curv_last`` the merge
    count ``num_merges`` and the distances rescaled by sqrt(c_old / c_new)
    (``best_dist`` where finite). The scalars (``num_merges``, ``curv_t``:
    int32; ``curvature``, ``curv_m``, ``curv_v``: float32) are one-element
    tensors on the card, read there."""
    _build.check("emb", emb, torch.float32, (None, None))
    _build.check("negs", negs, torch.int32, (None, None))
    _build.check("ii", ii, torch.int32, (None,))
    v, d1 = emb.shape
    hp, hn = negs.shape
    ds = ii.shape[0]
    tensors = (("emb", emb, None, None),
               ("merges", merges, torch.int32, (v, 2)),
               ("num_merges", num_merges, torch.int32, None),
               ("negs", negs, None, None),
               ("ii", ii, None, None),
               ("jj", jj, torch.int32, (ds,)),
               ("curvature", curvature, torch.float32, None),
               ("curv_m", curv_m, torch.float32, None),
               ("curv_v", curv_v, torch.float32, None),
               ("curv_t", curv_t, torch.int32, None),
               ("best_dist", best_dist, torch.float32, (v,)),
               ("q_dist", q_dist, torch.float32, (3, None)))
    for name, t, dtype, shape in tensors:
        if dtype is not None:
            _build.check(name, t, dtype, shape)
    dev = emb.device
    _build.check_devices([(name, t) for name, t, _, _ in tensors], dev)
    if d1 < 1:
        raise ValueError("curvature_step: empty embedding rows")

    def scalar(dtype):
        return torch.empty((), dtype=dtype, device=dev)

    terms = torch.empty((hp + ds,), dtype=torch.float32, device=dev)
    out = (scalar(torch.float32), scalar(torch.float32),
           scalar(torch.float32), scalar(torch.int32), scalar(torch.int32),
           torch.empty_like(best_dist), torch.empty_like(q_dist))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _launcher().curvature_step_launch(
            *(t.data_ptr() for t in (
                emb, merges, num_merges, negs, ii, jj, curvature, curv_m,
                curv_v, curv_t, best_dist, q_dist, terms) + out),
            d1, hp, hn, ds, best_dist.numel(), q_dist.numel(),
            float(hierarchy_weight), float(distortion_weight), float(lr),
            float(curvature_min), float(curvature_max), stream)
    _launched(rc)
    return out
