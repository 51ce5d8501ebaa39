"""HypTokenizer in PyTorch and CUDA: the port of ``hyptokenizer_tpu``.

The JAX package beside this one is the reference. This package imports
torch, numpy and the standard library only; it never imports ``jax`` or
``hyptokenizer_tpu``. Its tests hold each module to its JAX counterpart.

Slices so far: corpus-only flagship training, and all-features training
with the dense channel:

- ``ops.lorentz``           — hyperboloid geometry used by the merge loop
- ``ops.cuda.enhanced_loop``— kernels K1 and K2, the scored merge segment
                              without and with the dense channel, in CUDA
- ``ops.cuda.pairwise``     — kernel K3, the dense candidate pass, in CUDA
- ``tokenizer.scoring``     — hashes, corpus replay, pair table, top-k
- ``tokenizer.search``      — exact per-row best candidates (plain K3)
- ``tokenizer.state``       — the merge state, inserts and column fold
- ``tokenizer.enhanced_state`` — sync, curvature Adam, the plain scored step
- ``tokenizer.enhanced``    — ``EnhancedHyperbolicTokenizer``
- ``evals.selfcheck``       — kernels held to their plain versions
- ``convert``               — states to and from the JAX package's layout
"""

__version__ = "0.1.0"

from hyptokenizer_tpu_torch import _device  # noqa: F401  (TF32 off)
from hyptokenizer_tpu_torch.ops import lorentz  # noqa: F401
