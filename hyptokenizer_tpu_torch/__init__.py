"""HypTokenizer in PyTorch and CUDA: the port of ``hyptokenizer_tpu``.

The JAX package beside this one is the reference. This package imports
torch, numpy and the standard library only; it never imports ``jax`` or
``hyptokenizer_tpu``. Its tests hold each module to its JAX counterpart.

First slice (corpus-only flagship training):

- ``ops.lorentz``           — hyperboloid geometry used by the merge loop
- ``ops.cuda.enhanced_loop``— kernel K1, the scored merge segment, in CUDA
- ``tokenizer.scoring``     — hashes, corpus replay, pair table, top-k
- ``tokenizer.state``       — the merge state (corpus-only branch)
- ``tokenizer.enhanced_state`` — sync, curvature Adam, the plain scored step
- ``tokenizer.enhanced``    — ``EnhancedHyperbolicTokenizer``
- ``convert``               — states to and from the JAX package's layout
"""

__version__ = "0.1.0"

from hyptokenizer_tpu_torch import _device  # noqa: F401  (TF32 off)
from hyptokenizer_tpu_torch.ops import lorentz  # noqa: F401
