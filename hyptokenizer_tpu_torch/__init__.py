"""HypTokenizer in PyTorch and CUDA: the port of ``hyptokenizer_tpu``.

The JAX package beside this one is the reference. This package imports
torch, numpy and the standard library only (and the repo's ``native/``
encoder through ctypes); it never imports ``jax`` or ``hyptokenizer_tpu``.
Its tests hold each module to its JAX counterpart.

Ported: corpus-only, all-features and distance-only training, the
enhanced configurations, encoding, the geometry, the kernels' selfcheck,
the bench, the device CLI, the training CLIs with embedding pretraining,
hierarchy supervision, checkpoint and resume, the downstream models with
the evaluation CLIs, and sharded training on ``torch.distributed``:

- ``ops.lorentz``, ``ops.poincare`` — hyperbolic geometry
- ``ops.cuda.enhanced_loop``— kernels K1 and K2, the scored merge segment
                              without and with the dense channel, in CUDA
- ``ops.cuda.pairwise``     — kernel K3, the dense candidate pass, in CUDA
- ``ops.cuda.merge_loop``   — kernel K4, the distance-only loop, in CUDA
- ``tokenizer.scoring``     — hashes, corpus replay, pair table, top-k
- ``tokenizer.search``      — exact per-row best candidates (plain K3)
- ``tokenizer.state``       — the merge state, inserts, column fold and the
                              distance-only loop (plain K4)
- ``tokenizer.enhanced_state`` — sync, curvature Adam, the plain scored step
- ``tokenizer.core``/``tokenizer.enhanced`` — the tokenizer classes
- ``tokenizer.encode``      — tokenize/encode/decode, native and Python
- ``tokenizer.embed_train`` — RSGD embedding pretraining and supervision
- ``evals.selfcheck``       — kernels held to their plain versions
- ``evals.hierarchy``       — WordNet hierarchy distortion
- ``evals.comparison``      — tokenizer throughput, quality, compression
- ``evals.baselines``       — HF ``tokenizers`` and SentencePiece baselines
- ``models``                — hyperbolic losses and Recall@K, BERT MLM and
                              classification (``models.nlp``), the
                              two-tower model (``models.multimodal``) and
                              retrieval training (``models.retrieval``)
- ``parallel``              — sharded training: ranks and collectives
                              (``mesh``), the process group
                              (``multihost``), the v2/v3/v3f syncs and the
                              replicated segments (``sharded``)
- ``bench``                 — ``bench.py``'s workloads at full depth
- ``cli``                   — the training and evaluation CLIs,
                              ``test_torch`` (device smoke test and kernel
                              check)
- ``utils``                 — data helpers, ``TrainConfig``, metrics,
                              checkpoints
- ``convert``               — states to and from the JAX package's
                              layout, and the models' Flax parameters
"""

__version__ = "0.1.0"

from hyptokenizer_tpu_torch import _device  # noqa: F401  (TF32 off)
from hyptokenizer_tpu_torch.ops import lorentz, poincare  # noqa: F401
