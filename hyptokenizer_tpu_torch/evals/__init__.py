"""Evaluation of the port: the kernels' checks against their plain
versions (``selfcheck``) and WordNet hierarchy distortion
(``hierarchy``)."""

from hyptokenizer_tpu_torch.evals.hierarchy import (  # noqa: F401
    compute_distortion,
    create_node_mapping,
    load_wordnet_graph,
)
