"""Tokenizer algorithms of the port (distance-only, corpus-only and
all-features training).

- ``scoring``        — hashes, corpus replay, pair table, top-k queues
- ``search``         — exact per-row best candidates (plain K3)
- ``state``          — the merge state, inserts, column fold and the
                       distance-only loop (plain K4)
- ``enhanced_state`` — sync, curvature Adam, the scored step (plain K1, K2)
- ``core``/``enhanced`` — the host-side tokenizer classes and artifacts
- ``embed_train``    — RSGD embedding pretraining and hierarchy supervision
- ``encode``         — tokenize/encode/decode
- ``normalize``      — Unicode normalization and lossless pre-splitting
"""

from hyptokenizer_tpu_torch.tokenizer.core import (  # noqa: F401
    FastHyperbolicTokenizer,
    HyperbolicTokenizer,
)
from hyptokenizer_tpu_torch.tokenizer.encode import Encoder  # noqa: F401
from hyptokenizer_tpu_torch.tokenizer.enhanced import (  # noqa: F401
    AdaptiveCurvatureTokenizer,
    CompressionAwareTokenizer,
    EnhancedFastHyperbolicTokenizer,
    EnhancedHyperbolicTokenizer,
    FrequencyAwareHyperbolicTokenizer,
    HierarchicalHyperbolicTokenizer,
)
from hyptokenizer_tpu_torch.tokenizer.normalize import (  # noqa: F401
    WHITESPACE,
    WORDS_WITH_SPACE,
    NormalizerConfig,
)
from hyptokenizer_tpu_torch.tokenizer.state import (  # noqa: F401
    MergeConfig,
    MergeState,
    init_state,
    merge_step,
    run_merges,
)
