"""The enhanced tokenizer family, in PyTorch.

Port of ``hyptokenizer_tpu/tokenizer/enhanced.py``:
``EnhancedHyperbolicTokenizer`` with corpus-only training (the flagship
benchmark, ``bench.py`` ``bench_enhanced``) and the dense, all-features
configuration (``bench.py`` ``bench_allfeatures``); its four configurations
``FrequencyAwareHyperbolicTokenizer``, ``HierarchicalHyperbolicTokenizer``,
``AdaptiveCurvatureTokenizer`` and ``CompressionAwareTokenizer``; and the
``EnhancedFastHyperbolicTokenizer`` alias. The constructor keeps the JAX
package's signature, except that ``device`` is honoured (default
``"cuda"``, or the mesh's device) and ``seed`` seeds the
:class:`TorchSampler` the loop draws from. With a ``mesh``
(``parallel.mesh.make_mesh``) each chunk runs through
``parallel.sharded.run_enhanced_sharded`` on every rank, every rank
drawing the same numbers; ``corpus_shards`` aligns the corpus for the
sharded syncs. ``corpus_shrink`` (off by default, as in the JAX package)
halves the corpus buffer while its live prefix fits, on one rank.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from hyptokenizer_tpu_torch.tokenizer import scoring
from hyptokenizer_tpu_torch.tokenizer.core import HyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer.normalize import NormalizerConfig
from hyptokenizer_tpu_torch.tokenizer.state import MergeConfig
from hyptokenizer_tpu_torch.utils import metrics, morphology

logger = logging.getLogger(__name__)

DEFAULT_CORPUS_TOKENS = 1 << 21


def _live_count(corpus: torch.Tensor) -> torch.Tensor:
    """Non-PAD prefix length of a (compacted) corpus buffer."""
    return torch.sum(corpus != scoring.PAD_ID)


def _token_features(tokens: Sequence[str]):
    """Host-side (hash, byte length, vowel bit) arrays for a token list."""
    n = len(tokens)
    t_hash = np.zeros((n, 2), np.int32)
    b_len = np.zeros((n,), np.int32)
    vflag = np.zeros((n,), np.bool_)
    for idx, tok in enumerate(tokens):
        t_hash[idx] = scoring.hash_string(tok)
        b_len[idx] = len(tok.encode("utf-8"))
        vflag[idx] = morphology.has_vowel(tok)
    return t_hash, b_len, vflag


class EnhancedHyperbolicTokenizer(HyperbolicTokenizer):
    """Flagship tokenizer: all scoring features behind flags.

    HNSW/cache parameters are accepted for API parity and ignored, as in the
    JAX package (candidate search is exact)."""

    MIN_CORPUS_BUFFER = 1 << 16

    def __init__(
        self,
        vocab: Sequence[str],
        embeddings,
        curvature: float = 1.0,
        merge_threshold: float = 0.5,
        lr: float = 1e-3,
        device=None,
        max_vocab_size: int = 100_000,
        use_approximate_search: bool = True,
        cache_size: int = 10_000,
        rebuild_frequency: int = 100,
        hnsw_m: int = 32,
        hnsw_ef_construction: int = 200,
        hnsw_ef_search: int = 100,
        use_frequency_aware: bool = True,
        use_hierarchical: bool = True,
        use_adaptive_curvature: bool = True,
        use_compression_aware: bool = True,
        corpus_path: Optional[str] = None,
        alpha: float = 0.4,
        beta: float = 0.4,
        gamma: float = 0.2,
        language: str = "english",
        curvature_lr: float = 0.01,
        hierarchy_weight: float = 1.0,
        distortion_weight: float = 0.1,
        optimize_curvature_freq: int = 100,
        corpus_sample: Optional[List[str]] = None,
        compression_weight: float = 0.7,
        distance_weight: float = 0.3,
        sample_size: int = 100,
        pool_k: int = 64,
        corpus_max_tokens: int = DEFAULT_CORPUS_TOKENS,
        search_block: int = 512,
        merge_batch: int = 8,
        min_pair_freq: int = 1,
        use_dense_channel: bool = True,
        max_token_len: int = 512,
        freq_table_size: int = 1 << 17,
        queue_size: int = 4096,
        seed: int = 0,
        normalizer=None,
        merge_policy: str = "fixpoint",
        corpus_shards: int = 1,
        corpus_shrink: bool = False,
        mesh=None,
    ):
        del cache_size, rebuild_frequency, hnsw_m, hnsw_ef_construction
        del hnsw_ef_search, distance_weight, sample_size, pool_k
        # Corpus-only mode never reads the dense-candidate arrays: skip the
        # O(V^2 d) pass and poison them (state.init_state). Decided before
        # super().__init__ builds the state.
        has_corpus = bool(corpus_path or corpus_sample)
        needs_corpus = has_corpus and (use_frequency_aware
                                       or use_compression_aware
                                       or use_hierarchical)
        self._init_candidates = use_dense_channel or not needs_corpus
        with metrics.span("constructor") as whole:
            with metrics.span("constructor.base") as base:
                super().__init__(
                    vocab, embeddings, curvature=curvature,
                    merge_threshold=merge_threshold, lr=lr, device=device,
                    max_vocab_size=max_vocab_size,
                    use_approximate_search=use_approximate_search,
                    search_block=search_block, normalizer=normalizer,
                    merge_policy=merge_policy, mesh=mesh)
                self.language = language
                self.corpus_shrink = corpus_shrink
                # The length cap, mirrored so that load's candidate re-scan
                # applies the gate that training applies.
                self.config = dataclasses.replace(
                    self.config, max_token_len=max_token_len)
                self.callbacks: List[Callable] = []
                self.enh_config = E.EnhancedConfig(
                    base=MergeConfig(max_vocab_size=self.max_vocab_size,
                                     search_block=search_block,
                                     max_token_len=max_token_len),
                    n_init=len(self.vocab),
                    has_corpus=has_corpus,
                    merge_batch=merge_batch,
                    min_pair_freq=min_pair_freq,
                    use_dense_channel=use_dense_channel,
                    priority_replay=(merge_policy == "priority"),
                    use_frequency=use_frequency_aware,
                    alpha=alpha, beta=beta, gamma=gamma,
                    use_compression=use_compression_aware,
                    compression_weight=compression_weight,
                    use_hierarchical=use_hierarchical,
                    use_adaptive_curvature=use_adaptive_curvature,
                    curvature_freq=optimize_curvature_freq,
                    curvature_lr=curvature_lr,
                    hierarchy_weight=hierarchy_weight,
                    distortion_weight=distortion_weight,
                    freq_table_size=freq_table_size,
                    queue_size=max(min(queue_size, freq_table_size),
                                   merge_batch, 1),
                )
                self.sampler = E.TorchSampler(seed, self.device)
                self.current_phase = 1
            with metrics.span("constructor.corpus") as corpus:
                texts: List[str] = []
                if corpus_path:
                    with open(corpus_path, encoding="utf-8") as f:
                        texts = [ln.rstrip("\n") for ln in f]
                elif corpus_sample:
                    texts = list(corpus_sample)
                self.corpus_sample = texts
                self.corpus_shards = corpus_shards
                corpus_ids = self._encode_initial_corpus(
                    texts, corpus_max_tokens, corpus_shards)
            with metrics.span("constructor.morphology") as morph:
                if use_hierarchical and texts:
                    self.morphology = morphology.analyze_corpus(texts)
                else:
                    self.morphology = morphology.MorphologyTables()
                mk, ms, wk, ws = self.morphology.hash_tables()
            with metrics.span("constructor.assemble") as assemble:
                t_hash, b_len, vflag = _token_features(self.vocab)
                t_feat = np.concatenate(
                    [t_hash, b_len[:, None],
                     vflag[:, None].astype(np.int32)], axis=1).astype(np.int32)
                fields = E.assemble_enhanced_buffers(
                    t_feat, mk, wk, ms, ws, self.max_vocab_size,
                    self.enh_config.freq_table_size,
                    self.enh_config.queue_size,
                    self.enh_config.coherence_samples, self.device)
                self.enh_state = E.EnhancedState(
                    base=self.state, corpus=corpus_ids, **fields)
                if use_hierarchical:
                    # The phase-1 threshold applies from the start.
                    self.enh_state.base.threshold = torch.tensor(
                        self.enh_config.phase_thresholds[0],
                        dtype=torch.float32, device=self.device)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        self.ctor_stats = {
            "ctor_total_s": round(whole.host_s, 3),
            "ctor_base_s": round(base.host_s, 3),
            "ctor_corpus_s": round(corpus.host_s, 3),
            "ctor_morph_s": round(morph.host_s, 3),
            "ctor_assemble_s": round(assemble.host_s, 3),
        }

    # ------------------------------------------------------------------ setup
    def _encode_initial_corpus(self, texts: List[str], corpus_max_tokens: int,
                               corpus_shards: int = 1) -> torch.Tensor:
        from hyptokenizer_tpu_torch.tokenizer import normalize as norm_lib
        from hyptokenizer_tpu_torch.utils import data
        # SEP between lines (and between pre-split segments): no pair
        # crosses a boundary the encoder would not merge across.
        pre_split = None
        if self.normalizer is not None:
            texts = [norm_lib.normalize(t, self.normalizer) for t in texts]
            pre_split = self.normalizer.pre_split
        ids = data.encode_corpus_chars(
            texts, self.vocab, corpus_max_tokens,
            unk_id=self.token2idx.get("<unk>", 3),
            sep_id=scoring.SEP_ID, pad_id=scoring.PAD_ID,
            pre_split=pre_split)
        if corpus_shards > 1:
            ids = data.shard_align_corpus(ids, corpus_shards,
                                          pad_id=scoring.PAD_ID,
                                          sep_id=scoring.SEP_ID)
        return torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(
            self.device)

    def _maybe_shrink_corpus(self) -> None:
        """Halve the corpus buffer while its live prefix fits (opt-in).

        Merges only shrink the corpus (replay and compaction leave a PAD
        tail) and every sync costs in proportion to the buffer, so slicing
        to the next power of two above the live count keeps late syncs
        proportional to the live corpus. Only the PAD tail goes: the merge
        sequence is unchanged. A shard-aligned corpus keeps its live tokens
        at each shard's prefix, so it is never sliced."""
        if not self.corpus_shrink or self.corpus_shards > 1:
            return
        if self.mesh is not None and self.mesh.size > 1:
            return  # each rank syncs its shard of the whole buffer
        corpus = self.enh_state.corpus
        buf = corpus.shape[0]
        if buf <= self.MIN_CORPUS_BUFFER:
            return
        live = int(_live_count(corpus))
        new = max(self.MIN_CORPUS_BUFFER, 1 << max(1, live).bit_length())
        if new <= buf // 2:
            self.enh_state = dataclasses.replace(self.enh_state,
                                                 corpus=corpus[:new])

    def register_callback(self, fn: Callable[[Dict], None]) -> None:
        """Per-chunk progress callback."""
        self.callbacks.append(fn)

    def _sync_merges_from_device(self) -> int:
        with metrics.span("chunk.strings"):
            self.state = self.enh_state.base
            return super()._sync_merges_from_device()

    # ---------------------------------------------------------------- training
    def optimize_merges(self, steps: int = 10_000, log_every: int = 1000,
                        target_vocab_size: Optional[int] = None,
                        corpus_sample: Optional[List[str]] = None,
                        adaptive_threshold: bool = True,
                        phase_transition_steps: Optional[Dict[int, int]] = None,
                        sync_every: Optional[int] = None,
                        **_compat) -> None:
        """Train ``steps`` merges in chunks of ``log_every``.

        ``sync_every`` caps the merges applied against one pair-count
        snapshot (default: ``log_every``)."""
        cfg = self.enh_config
        if corpus_sample:
            self.corpus_sample = corpus_sample
            if cfg.frozen_freqs or not cfg.has_corpus:
                # A loaded tokenizer handed a live corpus: re-ground. The
                # fresh char-level buffer replays the whole history at the
                # next sync.
                self.enh_state = dataclasses.replace(
                    self.enh_state,
                    corpus=self._encode_initial_corpus(
                        corpus_sample, DEFAULT_CORPUS_TOKENS,
                        self.corpus_shards),
                    corpus_synced=torch.zeros_like(
                        self.enh_state.corpus_synced))
                cfg = dataclasses.replace(cfg, has_corpus=True,
                                          frozen_freqs=False)
        if phase_transition_steps:
            cfg = dataclasses.replace(
                cfg, phase2_step=phase_transition_steps.get(2, 1000),
                phase3_step=phase_transition_steps.get(3, 6000))
        if not adaptive_threshold:
            cfg = dataclasses.replace(cfg, base=dataclasses.replace(
                cfg.base, adaptive_threshold=False))
        self.enh_config = cfg
        done = 0
        zero_chunks = 0
        train_seconds = 0.0
        first_chunk_seconds = None
        start_merges = len(self.merge_history)
        prev_merges = start_merges
        while done < steps:
            if target_vocab_size is not None and \
                    len(self.vocab) >= target_vocab_size:
                logger.info("Reached target vocab size %d", target_vocab_size)
                break
            chunk = min(log_every, steps - done)
            t0 = time.perf_counter()
            sub = min(sync_every, chunk) if sync_every else chunk
            run = 0
            syncs = 0
            while run < chunk:
                n = min(sub, chunk - run)
                if self.mesh is not None:
                    from hyptokenizer_tpu_torch.parallel.sharded import \
                        run_enhanced_sharded
                    self.enh_state, rounds = run_enhanced_sharded(
                        self.enh_state, self.enh_config, n, self.mesh,
                        self.sampler)
                else:
                    self.enh_state, rounds = E.run_enhanced(
                        self.enh_state, self.enh_config, n, self.sampler)
                syncs += rounds
                run += n
            if metrics.nan_checks_enabled():
                metrics.check_finite(self.enh_state, f"step {done + chunk}")
            new = self._sync_merges_from_device()
            if self.enh_config.needs_corpus:
                self._maybe_shrink_corpus()
            zero_chunks = zero_chunks + 1 if new == 0 else 0
            if zero_chunks >= 2:
                logger.info("No more merge candidates found. Stopping.")
                break
            dt = time.perf_counter() - t0
            if first_chunk_seconds is None:
                first_chunk_seconds = dt
            else:
                train_seconds += dt
            done += chunk
            with metrics.span("chunk.stats"):
                self.current_phase = int(self.enh_state.phase)
                dstats = self.distance_statistics()
                chunk_merges = len(self.merge_history) - prev_merges
                prev_merges = len(self.merge_history)
                stat = {
                    "step": int(self.state.step),
                    "vocab_size": len(self.vocab),
                    "merges": len(self.merge_history),
                    "threshold": float(self.state.threshold),
                    "curvature": float(self.state.curvature),
                    "phase": self.current_phase,
                    "steps_per_sec": chunk / dt if dt > 0 else float("inf"),
                    "chunk_merges": chunk_merges,
                    "chunk_seconds": dt,
                    "chunk_syncs": syncs,
                    "pair_table_unique": int(self.enh_state.pair_unique),
                    "min_dist": dstats["min"],
                    "max_dist": dstats["max"],
                    "mean_dist": dstats["mean"],
                    "std_dist": dstats["std"],
                }
            if stat["pair_table_unique"] > self.enh_config.freq_table_size:
                logger.warning(
                    "pair table overflow: %d unique corpus pairs > table "
                    "size %d — lowest-count pairs dropped from this "
                    "snapshot (raise freq_table_size)",
                    stat["pair_table_unique"],
                    self.enh_config.freq_table_size)
            self.training_stats.append(stat)
            logger.info("step %(step)d: vocab=%(vocab_size)d phase=%(phase)d "
                        "c=%(curvature).4f thr=%(threshold).5f "
                        "%(steps_per_sec).1f steps/s", stat)
            for cb in self.callbacks:
                cb(stat)
            if bool(self.state.stopped):
                logger.info("No more merge candidates found. Stopping.")
                break
        self.merge_threshold = float(self.state.threshold)
        self.curvature = float(self.state.curvature)
        corpus_bytes = sum(len(t.encode("utf-8")) for t in self.corpus_sample)
        merges = len(self.merge_history) - start_merges
        if train_seconds == 0.0 and first_chunk_seconds:
            train_seconds = first_chunk_seconds  # single-chunk run
        if train_seconds > 0:
            self.training_summary = {
                "train_seconds": train_seconds,
                "first_chunk_seconds": first_chunk_seconds,
                "merges": merges,
                "merges_per_sec": merges / train_seconds,
                "corpus_bytes": corpus_bytes,
                "corpus_bytes_per_sec_per_chip": corpus_bytes / train_seconds,
            }

    # ----------------------------------------------------------------- persist
    @property
    def pair_frequencies(self) -> Dict:
        """String-keyed pair-frequency snapshot of the device table."""
        keys = self.enh_state.pair_keys.cpu().numpy()
        counts = self.enh_state.pair_counts.cpu().numpy()
        out = {}
        for (a, b), c in zip(keys, counts):
            if a == scoring.PKEY_SENT or c == 0:
                continue
            a, b = int(a), int(b)
            if a < len(self.vocab) and b < len(self.vocab):
                out[(self.vocab[a], self.vocab[b])] = int(c)
        return out

    def save(self, path: str) -> None:
        if not self.writes_files:
            return
        super().save(path)
        cfg = self.enh_config
        enhanced_config = {
            "use_frequency_aware": cfg.use_frequency,
            "use_hierarchical": cfg.use_hierarchical,
            "use_adaptive_curvature": cfg.use_adaptive_curvature,
            "use_compression_aware": cfg.use_compression,
            "alpha": cfg.alpha, "beta": cfg.beta, "gamma": cfg.gamma,
            "compression_weight": cfg.compression_weight,
            "curvature_lr": cfg.curvature_lr,
            "hierarchy_weight": cfg.hierarchy_weight,
            "distortion_weight": cfg.distortion_weight,
            "optimize_curvature_freq": cfg.curvature_freq,
            "current_phase": self.current_phase,
            "curvature": float(self.state.curvature),
            "language": self.language,
            "merge_batch": cfg.merge_batch,
            "min_pair_freq": cfg.min_pair_freq,
            "use_dense_channel": cfg.use_dense_channel,
            "max_token_len": cfg.base.max_token_len,
            "freq_table_size": cfg.freq_table_size,
            "queue_size": cfg.queue_size,
        }
        with open(os.path.join(path, "enhanced_config.json"), "w") as f:
            json.dump(enhanced_config, f)
        if cfg.use_frequency:
            freqs = {f"{a}␟{b}": c
                     for (a, b), c in self.pair_frequencies.items()}
            with open(os.path.join(path, "frequencies.json"), "w") as f:
                json.dump(freqs, f)
            with open(os.path.join(path, "freq_hyperparams.json"), "w") as f:
                json.dump({"alpha": cfg.alpha, "beta": cfg.beta,
                           "gamma": cfg.gamma}, f)
        if cfg.use_hierarchical:
            with open(os.path.join(path, "hierarchical_data.json"), "w") as f:
                json.dump({
                    "common_morphemes": sorted(self.morphology.common_morphemes),
                    "common_words": sorted(self.morphology.common_words),
                    "current_phase": self.current_phase,
                }, f)
        if cfg.use_adaptive_curvature:
            np.save(os.path.join(path, "curvature.npy"),
                    self.state.curvature.cpu().numpy())
            np.save(os.path.join(path, "merge_pairs.npy"),
                    self.state.merges[:int(self.state.num_merges)]
                    .cpu().numpy())

    @classmethod
    def load(cls, path: str, device=None) -> "EnhancedHyperbolicTokenizer":
        """Reconstruct an enhanced tokenizer from artifacts on ``device``.

        Restores the feature flags, trained curvature, phase, morphology
        sets and pair frequencies; with no corpus to replay, restored
        frequencies stay frozen in continued training (as in the JAX
        package and the reference)."""
        vocab, emb, merges, config = cls._parse_artifacts(path)
        epath = os.path.join(path, "enhanced_config.json")
        if os.path.exists(epath):
            with open(epath) as f:
                ecfg = json.load(f)
        else:
            ecfg = {"use_frequency_aware": False, "use_hierarchical": False,
                    "use_adaptive_curvature": False,
                    "use_compression_aware": False}
        for key in ("curvature", "merge_threshold", "max_vocab_size",
                    "use_approximate_search"):
            if key not in config and key in ecfg:
                config[key] = ecfg[key]

        n_init = len(vocab) - len(merges)
        tok = cls(
            vocab=vocab[:n_init],
            embeddings=emb[:n_init],
            curvature=float(ecfg.get("curvature",
                                     config.get("curvature", 1.0))),
            merge_threshold=config.get("merge_threshold", 0.1),
            device=device,
            max_vocab_size=config.get("max_vocab_size", 100_000),
            use_approximate_search=config.get("use_approximate_search", True),
            use_frequency_aware=ecfg.get("use_frequency_aware", False),
            use_hierarchical=ecfg.get("use_hierarchical", False),
            use_adaptive_curvature=ecfg.get("use_adaptive_curvature", False),
            use_compression_aware=ecfg.get("use_compression_aware", False),
            alpha=ecfg.get("alpha", 0.4),
            beta=ecfg.get("beta", 0.4),
            gamma=ecfg.get("gamma", 0.2),
            language=ecfg.get("language", "english"),
            curvature_lr=ecfg.get("curvature_lr", 0.01),
            hierarchy_weight=ecfg.get("hierarchy_weight", 1.0),
            distortion_weight=ecfg.get("distortion_weight", 0.1),
            optimize_curvature_freq=ecfg.get("optimize_curvature_freq", 100),
            compression_weight=ecfg.get("compression_weight", 0.7),
            merge_batch=ecfg.get("merge_batch", 8),
            min_pair_freq=ecfg.get("min_pair_freq", 1),
            use_dense_channel=ecfg.get("use_dense_channel", True),
            max_token_len=ecfg.get("max_token_len", 512),
            freq_table_size=ecfg.get("freq_table_size", 1 << 17),
            queue_size=ecfg.get("queue_size", 4096),
            corpus_max_tokens=cls.MIN_CORPUS_BUFFER,  # no corpus on disk
            normalizer=NormalizerConfig.from_json(config.get("normalizer")),
            merge_policy=config.get("merge_policy", "fixpoint"),
        )
        tok._restore_loaded_state(vocab, emb, merges)
        st = dataclasses.replace(tok.enh_state, base=tok.state)
        dev = tok.device

        # Token features cover the whole loaded vocabulary.
        t_hash, b_len, vflag = _token_features(vocab)
        v = len(vocab)
        st.token_hash[:v] = torch.from_numpy(t_hash).to(dev)
        st.byte_lengths[:v] = torch.from_numpy(b_len).to(dev)
        st.has_vowel[:v] = torch.from_numpy(vflag).to(dev)

        tok.current_phase = int(ecfg.get("current_phase", 1))
        cval = None
        if ecfg.get("use_adaptive_curvature"):
            cnpy = os.path.join(path, "curvature.npy")
            cpt = os.path.join(path, "curvature.pt")
            if os.path.exists(cnpy):
                cval = float(np.load(cnpy))
            elif os.path.exists(cpt):
                cval = float(torch.load(cpt, map_location="cpu",
                                        weights_only=True).detach())
        if cval is not None:
            tok.curvature = cval
            st.base.curvature = torch.tensor(cval, dtype=torch.float32,
                                             device=dev)

        hpath = os.path.join(path, "hierarchical_data.json")
        if ecfg.get("use_hierarchical") and os.path.exists(hpath):
            with open(hpath) as f:
                hd = json.load(f)
            tok.morphology = morphology.from_common_sets(
                hd.get("common_morphemes", []), hd.get("common_words", []))
            mk, ms, wk, ws = tok.morphology.hash_tables()
            st = dataclasses.replace(
                st, morph_table=torch.from_numpy(mk).to(dev),
                morph_size=torch.tensor(ms, dtype=torch.int32, device=dev),
                word_table=torch.from_numpy(wk).to(dev),
                word_size=torch.tensor(ws, dtype=torch.int32, device=dev))
            tok.current_phase = int(hd.get("current_phase",
                                           tok.current_phase))
        st.phase = torch.tensor(tok.current_phase, dtype=torch.int32,
                                device=dev)

        fpath = os.path.join(path, "frequencies.json")
        if ecfg.get("use_frequency_aware") and os.path.exists(fpath):
            with open(fpath) as f:
                freqs = json.load(f)
            t2i: Dict[str, int] = {}
            for i, t in enumerate(vocab):
                t2i.setdefault(t, i)
            entries = []
            for key, count in freqs.items():
                # U+241F separates in this schema; "|" in the reference's.
                parts = key.split("␟" if "␟" in key else "|")
                if len(parts) != 2:
                    continue
                a, b = parts
                if a in t2i and b in t2i:
                    entries.append((t2i[a], t2i[b], int(count)))
            T = tok.enh_config.freq_table_size
            arr = np.asarray(sorted(entries)[:T], np.int32).reshape(-1, 3)
            keys = np.full((T, 2), scoring.PKEY_SENT, np.int32)
            counts = np.zeros((T,), np.int32)
            keys[:len(arr)] = arr[:, :2]
            counts[:len(arr)] = arr[:, 2]
            st = dataclasses.replace(
                st, pair_keys=torch.from_numpy(keys).to(dev),
                pair_counts=torch.from_numpy(counts).to(dev),
                max_pair_count=torch.tensor(int(counts.max(initial=0)),
                                            dtype=torch.int32, device=dev),
                pair_unique=torch.tensor(len(entries), dtype=torch.int32,
                                         device=dev),
                # Stand-in for the sync-time token total (compression).
                corpus_tokens=torch.tensor(int(counts.sum()),
                                           dtype=torch.int32, device=dev),
                corpus_synced=st.base.num_merges.clone())
            tok.enh_config = dataclasses.replace(
                tok.enh_config, has_corpus=True, frozen_freqs=True)
        tok.enh_state = st
        tok.state = st.base
        return tok


class FrequencyAwareHyperbolicTokenizer(EnhancedHyperbolicTokenizer):
    """Frequency-scored merges only."""

    def __init__(self, vocab, embeddings, alpha: float = 0.4,
                 beta: float = 0.4, gamma: float = 0.2, **kw):
        kw.setdefault("use_hierarchical", False)
        kw.setdefault("use_adaptive_curvature", False)
        kw.setdefault("use_compression_aware", False)
        super().__init__(vocab, embeddings, use_frequency_aware=True,
                         alpha=alpha, beta=beta, gamma=gamma, **kw)


class HierarchicalHyperbolicTokenizer(EnhancedHyperbolicTokenizer):
    """Merges under the 3-phase curriculum."""

    def __init__(self, vocab, embeddings, **kw):
        kw.setdefault("use_frequency_aware", False)
        kw.setdefault("use_adaptive_curvature", False)
        kw.setdefault("use_compression_aware", False)
        super().__init__(vocab, embeddings, use_hierarchical=True, **kw)

    def _is_potential_morpheme(self, token: str) -> bool:
        return self.morphology.is_potential_morpheme(token)

    def _is_valid_word(self, token: str) -> bool:
        return self.morphology.is_valid_word(token)


class AdaptiveCurvatureTokenizer(EnhancedHyperbolicTokenizer):
    """Merges with a trained curvature."""

    def __init__(self, vocab, embeddings, curvature_lr: float = 0.01,
                 hierarchy_weight: float = 1.0,
                 distortion_weight: float = 0.1,
                 optimize_curvature_freq: int = 100, **kw):
        kw.setdefault("use_frequency_aware", False)
        kw.setdefault("use_hierarchical", False)
        kw.setdefault("use_compression_aware", False)
        super().__init__(vocab, embeddings, use_adaptive_curvature=True,
                         curvature_lr=curvature_lr,
                         hierarchy_weight=hierarchy_weight,
                         distortion_weight=distortion_weight,
                         optimize_curvature_freq=optimize_curvature_freq,
                         **kw)


class CompressionAwareTokenizer(EnhancedHyperbolicTokenizer):
    """Compression-gain-scored merges."""

    def __init__(self, vocab, embeddings, compression_weight: float = 0.7,
                 **kw):
        kw.setdefault("use_frequency_aware", False)
        kw.setdefault("use_hierarchical", False)
        kw.setdefault("use_adaptive_curvature", False)
        super().__init__(vocab, embeddings, use_compression_aware=True,
                         compression_weight=compression_weight, **kw)


# The reference's name.
EnhancedFastHyperbolicTokenizer = EnhancedHyperbolicTokenizer
