"""Typed training configuration with JSON round-trip.

The port's own copy of ``hyptokenizer_tpu/utils/config.py``: one dataclass
carries the full knob surface, serialises to/from JSON (the same schema,
so a ``train_config.json`` moves between the two packages), and feeds both
the CLI layer and programmatic use.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class TrainConfig:
    """Full training-knob surface (constructor parity: enhanced_…:78-121)."""

    # Core
    embedding_dim: int = 100
    curvature: float = 1.0
    merge_threshold: float = 0.5
    max_vocab_size: int = 100_000
    target_vocab_size: Optional[int] = None
    steps: int = 10_000
    log_every: int = 1000
    seed: int = 42
    init_sigma: float = 0.01

    # Feature flags
    use_frequency_aware: bool = True
    use_hierarchical: bool = True
    use_adaptive_curvature: bool = True
    use_compression_aware: bool = True

    # Frequency weights
    alpha: float = 0.4
    beta: float = 0.4
    gamma: float = 0.2

    # Compression
    compression_weight: float = 0.7

    # Hierarchical
    phase_transition_steps: Dict[int, int] = field(
        default_factory=lambda: {2: 1000, 3: 6000})

    # Adaptive curvature
    curvature_lr: float = 0.01
    hierarchy_weight: float = 1.0
    distortion_weight: float = 0.1
    optimize_curvature_freq: int = 100

    # Embedding pretraining (net-new)
    embed_steps: int = 0
    embed_lr: float = 0.3

    # Engine
    search_block: int = 512
    corpus_max_tokens: int = 1 << 21

    def to_json(self, path: Optional[str] = None) -> str:
        payload = json.dumps(dataclasses.asdict(self), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(payload)
        return payload

    @classmethod
    def from_json(cls, source: str) -> "TrainConfig":
        """Accepts a path or a JSON string."""
        try:
            data = json.loads(source)
        except (json.JSONDecodeError, ValueError):
            with open(source) as f:
                data = json.load(f)
        if "phase_transition_steps" in data and data["phase_transition_steps"]:
            data["phase_transition_steps"] = {
                int(k): int(v)
                for k, v in data["phase_transition_steps"].items()}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def tokenizer_kwargs(self) -> Dict:
        """Kwargs for EnhancedHyperbolicTokenizer."""
        return dict(
            curvature=self.curvature,
            merge_threshold=self.merge_threshold,
            max_vocab_size=self.max_vocab_size,
            use_frequency_aware=self.use_frequency_aware,
            use_hierarchical=self.use_hierarchical,
            use_adaptive_curvature=self.use_adaptive_curvature,
            use_compression_aware=self.use_compression_aware,
            alpha=self.alpha, beta=self.beta, gamma=self.gamma,
            compression_weight=self.compression_weight,
            curvature_lr=self.curvature_lr,
            hierarchy_weight=self.hierarchy_weight,
            distortion_weight=self.distortion_weight,
            optimize_curvature_freq=self.optimize_curvature_freq,
            search_block=self.search_block,
            corpus_max_tokens=self.corpus_max_tokens,
            seed=self.seed,
        )
