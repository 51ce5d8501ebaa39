"""The rank layout of sharded training and the collectives it uses.

Port of ``hyptokenizer_tpu/parallel/mesh.py``. The JAX package shards the
embeddings and every row array over a 1-D device mesh and lets XLA put a
collective into every merge step. Here a *rank* is one process with one
device (a card under NCCL, or the CPU under gloo), and a step of the merge
kernels costs a few microseconds, less than one collective, so the port
places the state otherwise (``parallel/sharded.py``):

- ``"row"``: the corpus, each rank holding its N/D slice during a chunk
  (the v2 and v3 syncs replay and count pairs on it);
- ``"owner"``: the v3 sync's pair-table slices before they are gathered;
- ``"rep"``: everything else, the embeddings, the row arrays, the merge
  table, the queues and the scalars, the same on every rank, so that
  every rank runs the merge segment on the same inputs.

Every rank keeps the whole state between chunks. :class:`Mesh` names the
process group, the rank, the world size and the rank's device;
:func:`make_mesh` builds it from the initialised default group, or a world
of one when none is initialised.

The collectives (:func:`all_gather`, :func:`all_to_all`,
:func:`all_reduce`) take tensors on the rank's device. Gloo takes only
host tensors, so under gloo a CUDA tensor goes through the host in
:func:`_collective`, the one place that stages; under NCCL nothing is
staged. A failed collective raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from hyptokenizer_tpu_torch import _device

# The one mesh axis: the vocabulary/row dimension (the JAX package's name).
VOCAB_AXIS = "vocab"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a sharded run, as this process sees them."""

    group: Any                 # the torch.distributed process group
    rank: int
    size: int
    device: torch.device       # this rank's device
    backend: str               # "nccl" or "gloo"
    axis_names: tuple = (VOCAB_AXIS,)


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    """The rank's card: ``LOCAL_RANK`` (torchrun's), else the rank modulo
    the cards present; ranks share a card when there are more ranks than
    cards (gloo only: NCCL refuses two ranks on one device)."""
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, device=None,
              backend: Optional[str] = None) -> Mesh:
    """The mesh of every rank of the initialised default group, on
    ``device`` (default: the card). With no group initialised, a world of
    one is created (``backend``, by default NCCL for a CUDA device and gloo
    for the CPU); it is made
    only here, when a mesh is asked for, and never stands in for a
    multi-rank initialisation that failed (that raises in
    :func:`multihost.initialize_multihost`).

    ``n_devices`` must be the world size when given: each process is one
    rank, and every rank of the group joins every collective."""
    dev = _device.resolve(device)
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks asked for in a world "
                         f"of {size}: each process is one rank, and every "
                         "rank joins every collective")
    rank = dist.get_rank()
    dev = _rank_device(dev, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD, rank=rank, size=size, device=dev,
                backend=str(dist.get_backend()))


def _collective(mesh: Mesh, op: str, x: torch.Tensor, reduce_op=None
                ) -> torch.Tensor:
    """One collective on the rank's tensor ``x``; returns a tensor on
    ``x``'s device. ``op``: "all_gather" (a new leading axis of size D),
    "all_to_all" (equal blocks along axis 0: block d goes to rank d, and
    block s of the result came from rank s) or "all_reduce"."""
    home = x.device
    staged = mesh.backend == "gloo" and home.type == "cuda"
    if staged:
        x = x.cpu()
    x = x.contiguous()
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        out = torch.stack(parts)
    elif op == "all_to_all":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.group)
    elif op == "all_reduce":
        out = x.clone()
        dist.all_reduce(out, op=reduce_op, group=mesh.group)
    else:
        raise ValueError(op)
    return out.to(home) if staged else out


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(D, *x.shape): every rank's ``x``, in rank order."""
    if mesh.size == 1:
        return x[None]
    return _collective(mesh, "all_gather", x)


def all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` of D equal blocks along axis 0: block d is sent to rank d,
    and block s of the result is rank s's block for this rank."""
    if mesh.size == 1:
        return x
    return _collective(mesh, "all_to_all", x)


def all_reduce(mesh: Mesh, x: torch.Tensor, op: str = "sum"
               ) -> torch.Tensor:
    """The elementwise sum ("sum") or maximum ("max") of ``x`` over the
    ranks."""
    if mesh.size == 1:
        return x
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    return _collective(mesh, "all_reduce", x, rop)


def state_shardings(mesh: Mesh):
    """A ``MergeState`` of placements: every field ``"rep"`` (the merge
    loop runs on every rank on the whole state; module docstring)."""
    from hyptokenizer_tpu_torch.tokenizer.state import MergeState
    del mesh
    return MergeState(**{f.name: "rep"
                         for f in dataclasses.fields(MergeState)})


def enhanced_state_shardings(mesh: Mesh, st=None, path: str = "v3"):
    """An ``EnhancedState`` of placements for a sharded chunk on sync
    ``path`` (``sharded.select_sync_path``): the corpus ``"row"`` for the
    v2 and v3 syncs (``"rep"`` for the replicated sync and v3f, which read
    the whole corpus or the restored table), the pair table ``"owner"``
    for v3 (each rank's T/D slice, until the sync gathers them), the rest
    ``"rep"``."""
    from hyptokenizer_tpu_torch.tokenizer.enhanced_state import EnhancedState
    del st
    fields = {f.name: "rep" for f in dataclasses.fields(EnhancedState)
              if f.name != "base"}
    if path in ("v2", "v3"):
        fields["corpus"] = "row"
    if path == "v3":
        fields["pair_keys"] = fields["pair_counts"] = "owner"
    return EnhancedState(base=state_shardings(mesh), **fields)


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def shard_state(state, mesh: Mesh):
    """The state on the rank's device (every field replicated). Requires
    ``max_vocab_size`` divisible by the mesh size, as the JAX package's
    sharding does (constructors round up with :func:`pad_vocab_for_mesh`).
    """
    return dataclasses.replace(state, **{
        f.name: _to(getattr(state, f.name), mesh.device)
        for f in dataclasses.fields(state)})


def shard_enhanced_state(st, mesh: Mesh, path: str = "replicated"):
    """The state on the rank's device, with this rank's N/D slice of the
    corpus for the v2 and v3 syncs (:func:`enhanced_state_shardings`);
    the whole corpus on every rank for the other paths."""
    st = dataclasses.replace(st, base=shard_state(st.base, mesh), **{
        f.name: _to(getattr(st, f.name), mesh.device)
        for f in dataclasses.fields(st) if f.name != "base"})
    if path in ("v2", "v3") and mesh.size > 1:
        n = st.corpus.shape[0] // mesh.size
        st = dataclasses.replace(
            st, corpus=st.corpus[mesh.rank * n:(mesh.rank + 1) * n].clone())
    return st


def pad_vocab_for_mesh(max_vocab_size: int, n_devices: int,
                       block: int = 1) -> int:
    """Round max_vocab_size up to a multiple of n_devices * block."""
    q = n_devices * block
    return ((max_vocab_size + q - 1) // q) * q
