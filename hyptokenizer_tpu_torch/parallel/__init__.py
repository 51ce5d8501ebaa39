"""Sharded training on ``torch.distributed``: the port of
``hyptokenizer_tpu/parallel/``. One rank is one process with one device (a
card under NCCL, the CPU under gloo). The corpus sync shards over the
ranks; the merge segment runs on every rank on the same replicated state
(``sharded.py`` says why), and merge histories equal one device's.
"""

from hyptokenizer_tpu_torch.parallel.mesh import (  # noqa: F401
    VOCAB_AXIS,
    Mesh,
    make_mesh,
    shard_state,
    state_shardings,
)
from hyptokenizer_tpu_torch.parallel.sharded import (  # noqa: F401
    run_merges_sharded,
)
