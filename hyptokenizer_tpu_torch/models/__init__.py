"""Downstream models, in PyTorch: hyperbolic losses, the two-tower
multimodal model, BERT MLM and classification (``models.nlp``) and
retrieval training (``models.retrieval``)."""

from hyptokenizer_tpu_torch.models.losses import (  # noqa: F401
    HyperbolicInfoNCE,
    hyperbolic_contrastive_loss,
    hyperbolic_triplet_loss,
    recall_at_k,
)
from hyptokenizer_tpu_torch.models.multimodal import (  # noqa: F401
    MultimodalHyperbolicModel,
    TransformerTower,
    ViTTower,
)
