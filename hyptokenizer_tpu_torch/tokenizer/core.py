"""Host-side tokenizer base class: vocabulary, merge history, encode/decode
and the on-disk artifacts.

Port of what ``EnhancedHyperbolicTokenizer`` inherits from
``hyptokenizer_tpu/tokenizer/core.py``. The artifact schema is the JAX
package's (``vocab.json``, ``merges.json``, ``config.json``,
``embeddings.npy``/``embeddings.pt``, ``training_stats.json``), byte for
byte, so artifacts move between the two packages in both directions.

``optimize_merges`` is the distance-only training loop: the startup
threshold controller once per tokenizer, then chunks of ``state.run_merges``
(kernel K4 on the card), or of ``parallel.sharded.run_merges_sharded`` on
every rank of a ``mesh``. A loaded tokenizer re-scans its dense candidates
(``search.full_pass_best`` with the loaded history and the length gate), so
that training goes on after ``load``. The distance statistics draw their
pairs from ``self.stats_sampler`` (``state.StatsSampler``, apart from any
training draws, as the JAX package keys them apart; a test injects the JAX
package's draws).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.tokenizer import search as search_lib
from hyptokenizer_tpu_torch.tokenizer import state as state_lib
from hyptokenizer_tpu_torch.tokenizer.encode import Encoder
from hyptokenizer_tpu_torch.tokenizer.normalize import NormalizerConfig
from hyptokenizer_tpu_torch.utils import metrics

logger = logging.getLogger(__name__)


class HyperbolicTokenizer:
    """Vocabulary, merge history and artifacts over a merge state."""

    def __init__(
        self,
        vocab: Sequence[str],
        embeddings,
        curvature: float = 1.0,
        merge_threshold: float = 0.1,
        lr: float = 1e-3,
        device=None,
        max_vocab_size: int = 100_000,
        use_approximate_search: bool = True,
        adaptive_threshold: bool = True,
        search_block: int = 512,
        normalizer=None,
        merge_policy: str = "fixpoint",
        mesh=None,
    ):
        # A mesh (parallel.mesh.make_mesh) runs each chunk through
        # parallel/sharded.py on every rank, on the rank's device.
        self.mesh = mesh
        if mesh is not None:
            from hyptokenizer_tpu_torch.parallel.mesh import \
                pad_vocab_for_mesh
            max_vocab_size = pad_vocab_for_mesh(int(max_vocab_size),
                                                mesh.size)
            if device is None:
                device = mesh.device
        if len(vocab) > max_vocab_size:
            raise ValueError("initial vocab larger than max_vocab_size")
        self.device = _device.resolve(device)
        self.normalizer = normalizer
        self.merge_policy = merge_policy
        self.vocab: List[str] = list(vocab)
        self.curvature = float(curvature)
        self.merge_threshold = float(merge_threshold)
        self.lr = float(lr)
        self.max_vocab_size = int(max_vocab_size)
        self.use_approximate_search = bool(use_approximate_search)
        self.merge_history: List[Tuple[str, str, str]] = []
        self.training_stats: List[Dict] = []
        self.training_summary: Optional[Dict] = None
        self._encoder: Optional[Encoder] = None
        self.stats_sampler = state_lib.StatsSampler(0, self.device)
        self.startup_stats: Optional[Dict] = None

        emb0 = (embeddings.float() if torch.is_tensor(embeddings)
                else torch.from_numpy(np.array(embeddings, np.float32)))
        if emb0.ndim != 2 or emb0.shape[0] != len(vocab):
            raise ValueError(f"embeddings shape {tuple(emb0.shape)} != "
                             "(len(vocab), d+1)")
        self.config = state_lib.MergeConfig(
            max_vocab_size=self.max_vocab_size,
            adaptive_threshold=adaptive_threshold,
            search_block=search_block,
            # A subclass may set _init_candidates=False (corpus-only
            # enhanced mode) before this runs: the dense-candidate arrays
            # are then poisoned instead of computed (state.init_state).
            init_candidates=getattr(self, "_init_candidates", True),
        )
        self.state = state_lib.init_state(
            emb0, [len(t) for t in self.vocab], curvature=self.curvature,
            threshold=self.merge_threshold, config=self.config,
            device=self.device)

    # ------------------------------------------------------------------ props
    @property
    def current_vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def token2idx(self) -> Dict[str, int]:
        return {t: i for i, t in enumerate(self.vocab)}

    @property
    def embeddings(self) -> np.ndarray:
        """Active embedding rows, host-side (V, d+1)."""
        v = int(self.state.vocab_size)
        return self.state.emb[:v].cpu().numpy()

    # --------------------------------------------------------------- training
    def _sync_merges_from_device(self) -> int:
        """Pull new merge indices off the device, extend the string vocab."""
        n_dev = int(self.state.num_merges)
        n_host = len(self.merge_history)
        if n_dev == n_host:
            return 0
        pairs = self.state.merges[n_host:n_dev].cpu().numpy()
        for a, b in pairs:
            tok_a, tok_b = self.vocab[int(a)], self.vocab[int(b)]
            merged = tok_a + tok_b
            self.vocab.append(merged)
            self.merge_history.append((tok_a, tok_b, merged))
        self._encoder = None
        return n_dev - n_host

    def distance_statistics(self, sample_size: int = 1000) -> Dict[str, float]:
        """min/max/mean/std of sampled pairwise distances, drawn through
        ``self.stats_sampler``."""
        st = self.state
        out = state_lib.distance_statistics(
            st.emb, st.vocab_size, st.curvature, self.stats_sampler,
            sample_size).tolist()
        return {"min": out[0], "max": out[1], "mean": out[2], "std": out[3]}

    def _set_threshold(self, value: float) -> None:
        self.state = dataclasses.replace(
            self.state, threshold=torch.tensor(value, dtype=torch.float32,
                                               device=self.device))
        self.merge_threshold = float(value)

    def _startup_threshold_adjust(self) -> Dict[str, float]:
        """The startup controller: degenerate geometry drops the threshold
        to 1e-5; a threshold above the sampled max is pulled down to 1.5x
        the sampled mean."""
        stats = self.distance_statistics()
        logger.info("Initial distance statistics: min=%.6f max=%.6f "
                    "mean=%.6f std=%.6f", stats["min"], stats["max"],
                    stats["mean"], stats["std"])
        thr = float(self.state.threshold)
        if stats["max"] < 1e-6:
            logger.warning("Maximum distance is near zero; setting the "
                           "merge threshold to 1e-05")
            self._set_threshold(1e-5)
        elif thr > stats["max"]:
            new = min(thr, stats["mean"] * 1.5)
            if new != thr:
                logger.info("Adjusted initial merge threshold to %.6f", new)
                self._set_threshold(new)
        return stats

    def optimize_merges(self, steps: int = 10_000, log_every: int = 1000,
                        **_compat) -> None:
        """Run the distance-only merge loop in chunks of ``log_every``
        steps, one ``training_stats`` entry per chunk, until ``steps`` or a
        stop. Extra keyword arguments are accepted for the reference's API;
        ``adaptive_threshold`` switches the adaptation."""
        if "adaptive_threshold" in _compat:
            self.config = dataclasses.replace(
                self.config,
                adaptive_threshold=bool(_compat["adaptive_threshold"]))
        # Once per tokenizer: a caller may chunk optimize_merges, and a
        # second run would undo the loop's threshold growth.
        if self.config.adaptive_threshold and \
                not getattr(self, "_threshold_adjusted", False):
            self._threshold_adjusted = True
            before = float(self.state.threshold)
            self.startup_stats = dict(
                self._startup_threshold_adjust(), threshold_before=before,
                threshold_after=float(self.state.threshold))
        done = 0
        while done < steps:
            chunk = min(log_every, steps - done)
            t0 = time.perf_counter()
            if self.mesh is not None:
                from hyptokenizer_tpu_torch.parallel.sharded import \
                    run_merges_sharded
                self.state = run_merges_sharded(self.state, self.config,
                                                chunk, self.mesh)
            else:
                self.state = state_lib.run_merges(self.state, self.config,
                                                  chunk)
            if metrics.nan_checks_enabled():
                metrics.check_finite(self.state, f"step {done + chunk}")
            self._sync_merges_from_device()
            dt = time.perf_counter() - t0
            done += chunk
            dstats = self.distance_statistics()
            stat = {
                "step": int(self.state.step),
                "vocab_size": len(self.vocab),
                "merges": len(self.merge_history),
                "threshold": float(self.state.threshold),
                "steps_per_sec": chunk / dt if dt > 0 else float("inf"),
                "min_dist": dstats["min"],
                "max_dist": dstats["max"],
                "mean_dist": dstats["mean"],
                "std_dist": dstats["std"],
            }
            self.training_stats.append(stat)
            logger.info("step %(step)d: vocab=%(vocab_size)d "
                        "merges=%(merges)d threshold=%(threshold).6f "
                        "%(steps_per_sec).1f steps/s", stat)
            if bool(self.state.stopped):
                logger.info("No more merge candidates found. Stopping.")
                break
        self.merge_threshold = float(self.state.threshold)

    # -------------------------------------------------------------- inference
    def _get_encoder(self) -> Encoder:
        if self._encoder is None:
            self._encoder = Encoder(self.vocab, self.merge_history,
                                    normalizer=self.normalizer,
                                    merge_policy=self.merge_policy)
        return self._encoder

    def tokenize(self, text: str) -> List[str]:
        return self._get_encoder().tokenize(text)

    def encode(self, text: str) -> List[int]:
        return self._get_encoder().encode(text)

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return self._get_encoder().encode_batch(texts)

    def decode(self, ids: Sequence[int]) -> str:
        return self._get_encoder().decode(ids)

    # ----------------------------------------------------------------- persist
    @property
    def writes_files(self) -> bool:
        """False on every rank but 0 of a sharded run: the ranks hold the
        same state, and rank 0 alone writes it."""
        return self.mesh is None or self.mesh.rank == 0

    def save(self, path: str) -> None:
        """Write the reference-schema artifacts (on rank 0 alone of a
        sharded run)."""
        if not self.writes_files:
            return
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w") as f:
            json.dump(self.vocab, f)
        emb = self.embeddings
        np.save(os.path.join(path, "embeddings.npy"), emb)
        torch.save(torch.from_numpy(emb.copy()),
                   os.path.join(path, "embeddings.pt"))
        with open(os.path.join(path, "merges.json"), "w") as f:
            json.dump([list(m) for m in self.merge_history], f)
        config = {
            "curvature": float(self.state.curvature),
            "merge_threshold": float(self.state.threshold),
            "embedding_dim": emb.shape[1] - 1,
            "max_vocab_size": self.max_vocab_size,
            "use_approximate_search": self.use_approximate_search,
        }
        if self.merge_policy != "fixpoint":
            config["merge_policy"] = self.merge_policy
        if self.normalizer is not None:
            config["normalizer"] = self.normalizer.to_json()
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
        with open(os.path.join(path, "training_stats.json"), "w") as f:
            json.dump(self.training_stats, f)
        if self.training_summary:
            with open(os.path.join(path, "training_summary.json"), "w") as f:
                json.dump(self.training_summary, f)

    @staticmethod
    def _parse_artifacts(path: str):
        """(vocab, emb, merges, config) of an artifact directory."""
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        npy = os.path.join(path, "embeddings.npy")
        if os.path.exists(npy):
            emb = np.load(npy)
        else:
            emb = torch.load(os.path.join(path, "embeddings.pt"),
                             map_location="cpu",
                             weights_only=True).detach().numpy()
        cpath = os.path.join(path, "config.json")
        config = {}
        if os.path.exists(cpath):
            with open(cpath) as f:
                config = json.load(f)
        with open(os.path.join(path, "merges.json")) as f:
            merges = [tuple(m) for m in json.load(f)]
        return vocab, emb, merges, config

    def _restore_loaded_state(self, vocab, emb, merges) -> None:
        """Restore the trained rows and history onto a tokenizer built from
        the initial-vocabulary prefix."""
        self.vocab = list(vocab)
        self.merge_history = list(merges)
        v = len(vocab)
        st = self.state
        st.emb[:v] = torch.from_numpy(np.array(emb[:v], np.float32)).to(
            self.device)
        st.lengths[:v] = torch.tensor([len(t) for t in vocab],
                                      dtype=torch.int32, device=self.device)
        st.vocab_size = torch.tensor(v, dtype=torch.int32, device=self.device)
        if merges:
            t2i: Dict[str, int] = {}
            for i, t in enumerate(vocab):
                t2i.setdefault(t, i)
            pairs = torch.tensor([[t2i[a], t2i[b]] for a, b, _ in merges],
                                 dtype=torch.int32, device=self.device)
            st.merges[:len(merges)] = pairs
            st.num_merges = torch.tensor(len(merges), dtype=torch.int32,
                                         device=self.device)
        # Candidates refreshed for continued training, length-gated as the
        # training folds are.
        st.best_dist, st.best_j = search_lib.full_pass_best(
            st.emb, v, st.curvature, st.merges, st.num_merges,
            block=self.config.search_block, lengths=st.lengths,
            max_token_len=self.config.max_token_len)

    @classmethod
    def load(cls, path: str, device=None) -> "HyperbolicTokenizer":
        """Load reference-schema artifacts onto ``device``."""
        vocab, emb, merges, config = cls._parse_artifacts(path)
        n_init = len(vocab) - len(merges)
        tok = cls(
            vocab=vocab[:n_init],
            embeddings=emb[:n_init],
            curvature=config.get("curvature", 1.0),
            merge_threshold=config.get("merge_threshold", 0.1),
            max_vocab_size=config.get("max_vocab_size", 100_000),
            use_approximate_search=config.get("use_approximate_search", True),
            normalizer=NormalizerConfig.from_json(config.get("normalizer")),
            merge_policy=config.get("merge_policy", "fixpoint"),
            device=device,
        )
        tok._restore_loaded_state(vocab, emb, merges)
        return tok


# The reference's "fast" class is the same loop here.
FastHyperbolicTokenizer = HyperbolicTokenizer
