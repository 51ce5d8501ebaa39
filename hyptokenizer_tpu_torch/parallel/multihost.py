"""Multi-process initialisation and the global mesh.

Port of ``hyptokenizer_tpu/parallel/multihost.py`` on
``torch.distributed``: each process is one rank with one device, and
:func:`initialize_multihost` joins them in a default process group through
a TCP rendezvous at the coordinator (process 0's ``host:port``). The
backend is NCCL for the card and gloo for the CPU; ``backend="gloo"`` on
the card lets several ranks share one card (NCCL refuses two ranks on one
device), the collectives then passing through the host
(``mesh._collective``).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch.distributed as dist

from hyptokenizer_tpu_torch import _device

logger = logging.getLogger(__name__)

TIMEOUT = datetime.timedelta(minutes=10)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device=None) -> None:
    """Initialise the default process group of this process's rank.

    With an explicit ``coordinator_address`` (``host:port``), joins
    ``num_processes`` ranks as rank ``process_id``; a coordinator that
    cannot be reached raises, since a multi-process job quietly run alone
    would give another result. Without one, a ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) is used when present; else
    the call logs and the process stays alone, as the JAX function does
    off a TPU pod. ``backend`` defaults to NCCL for a CUDA ``device``
    (default: the card) and gloo for the CPU."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if _device.resolve(device).type == "cuda" \
            else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes "
                             "and process_id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            rank=int(process_id), world_size=int(num_processes),
            timeout=TIMEOUT)
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    else:
        logger.info("multi-process init skipped (no coordinator and no "
                    "torchrun environment); running as one process")
        return
    logger.info("torch.distributed initialised (%s): rank %d of %d",
                backend, dist.get_rank(), dist.get_world_size())


def global_mesh(device=None, backend: Optional[str] = None):
    """The mesh over every rank of the default group (a world of one, on
    ``backend``, when none was initialised)."""
    from hyptokenizer_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(device=device, backend=backend)
