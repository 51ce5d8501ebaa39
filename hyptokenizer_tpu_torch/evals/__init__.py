"""Evaluation of the port: the kernels' checks against their plain
versions (``selfcheck``), WordNet hierarchy distortion (``hierarchy``),
tokenizer comparison (``comparison``) and the HF ``tokenizers`` baselines
(``baselines``)."""

from hyptokenizer_tpu_torch.evals.hierarchy import (  # noqa: F401
    compute_distortion,
    create_node_mapping,
    load_wordnet_graph,
)
from hyptokenizer_tpu_torch.evals.comparison import (  # noqa: F401
    compression_efficiency,
    linguistic_quality,
    measure_throughput,
)
