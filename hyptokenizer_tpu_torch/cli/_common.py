"""Shared CLI plumbing: logging, seeding, flags, vocab/embedding setup.

Port of ``hyptokenizer_tpu/cli/_common.py`` with the same flags, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
versions of the kernels). XLA's persistent compile cache
(``enable_compile_cache``) has no counterpart: the kernels' build cache is
``hyptokenizer_tpu_torch/_build/``. ``--mesh`` and ``--multihost`` train
across ranks (``parallel/``, on ``torch.distributed``: one process per
rank), with ``--dist-backend`` to choose gloo on the card.
"""

from __future__ import annotations

import argparse
import logging
import random
from typing import List, Optional

import numpy as np
import torch


def setup_logging(verbose: bool = True) -> None:
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )


def set_seeds(seed: int = 42) -> None:
    """Python/numpy/torch global seeding (train_hyperbolic_tokenizer.py
    :36-48). The training draws come from explicit generators seeded with
    ``--seed``; this covers any other user of the global streams."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def add_common_tokenizer_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--vocab-path", type=str, default=None,
                   help="initial vocab file (one token per line); built from "
                        "the corpus when omitted")
    p.add_argument("--corpus-path", type=str, default=None,
                   help="training corpus text file")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--embedding-dim", type=int, default=50)
    p.add_argument("--curvature", type=float, default=1.0)
    p.add_argument("--merge-threshold", type=float, default=0.1)
    p.add_argument("--max-vocab-size", type=int, default=100_000)
    p.add_argument("--target-vocab-size", type=int, default=None)
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--log-every", type=int, default=1000)
    p.add_argument("--sync-every", type=int, default=None,
                   help="enhanced tokenizers: max merges applied against one "
                        "pair-count snapshot (default: log-every). Fresher "
                        "counts allocate the vocab budget better, at the "
                        "cost of more syncs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--init-sigma", type=float, default=0.01)
    p.add_argument("--embed-steps", type=int, default=0,
                   help="RSGD co-occurrence pretraining steps for the initial "
                        "embeddings (0 = random init, the reference's only "
                        "mode)")
    p.add_argument("--embed-lr", type=float, default=0.3)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="mid-training checkpoint directory")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N chunks (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint-dir; --steps then counts "
                        "the steps still to run")
    p.add_argument("--config", type=str, default=None,
                   help="TrainConfig JSON (path or inline); sets flag "
                        "defaults — explicit flags still win. Persisted as "
                        "train_config.json next to the artifacts")
    p.add_argument("--metrics-path", type=str, default=None,
                   help="append per-chunk metrics as JSONL to this path")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace of the training loop "
                        "to this directory (trace.json, Chrome trace format)")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection, and a finiteness check "
                        "of the merge state after every chunk")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; cpu runs the "
                        "plain versions of the kernels)")


def parse_with_config(p: argparse.ArgumentParser, argv=None):
    """Parse args with ``--config`` JSON providing flag DEFAULTS.

    Two-pass parse: --config is read first, its fields become parser defaults
    (only for dests the parser actually has), then the full parse runs so
    explicitly-passed flags override the config file.
    Returns (args, config_or_None).
    """
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    ns, _ = pre.parse_known_args(argv)
    cfg = None
    if ns.config:
        import dataclasses
        from hyptokenizer_tpu_torch.utils.config import TrainConfig
        cfg = TrainConfig.from_json(ns.config)
        known = {a.dest for a in p._actions}
        d = dataclasses.asdict(cfg)
        pts = d.pop("phase_transition_steps", None) or {}
        if pts:
            d["phase2_step"] = pts.get(2, 1000)
            d["phase3_step"] = pts.get(3, 6000)
        p.set_defaults(**{k: v for k, v in d.items()
                          if k in known and v is not None})
    return p.parse_args(argv), cfg


def persist_train_config(args, output_dir: str) -> None:
    """Write the effective knob surface as train_config.json."""
    import dataclasses
    import os
    from hyptokenizer_tpu_torch.utils.config import TrainConfig
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    eff = {k: v for k, v in vars(args).items() if k in known}
    if hasattr(args, "phase2_step"):
        eff["phase_transition_steps"] = {2: args.phase2_step,
                                         3: args.phase3_step}
    os.makedirs(output_dir, exist_ok=True)
    TrainConfig(**eff).to_json(os.path.join(output_dir, "train_config.json"))


def add_multihost_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--multihost", action="store_true",
                   help="initialise torch.distributed (one process per "
                        "rank) and train sharded over all ranks")
    p.add_argument("--coordinator-address", type=str, default=None,
                   help="host:port of process 0 (else torchrun's "
                        "environment, else one process)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--mesh", action="store_true",
                   help="train through the sharded path even without "
                        "--multihost (a world of one process unless one "
                        "was initialised)")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend (default: nccl on the "
                        "card, gloo on the CPU; gloo lets several ranks "
                        "share one card)")


def maybe_init_multihost(args, device=None):
    """Initialise torch.distributed per the flags; return the mesh to train
    on on ``device`` (None = the unsharded path)."""
    backend = getattr(args, "dist_backend", None)
    if getattr(args, "multihost", False):
        from hyptokenizer_tpu_torch.parallel.multihost import (
            global_mesh, initialize_multihost)
        initialize_multihost(coordinator_address=args.coordinator_address,
                             num_processes=args.num_processes,
                             process_id=args.process_id, backend=backend,
                             device=device)
        return global_mesh(device, backend=backend)
    if getattr(args, "mesh", False):
        from hyptokenizer_tpu_torch.parallel.mesh import make_mesh
        return make_mesh(device=device, backend=backend)
    return None


def training_observability(args, writes: bool = True):
    """(metrics_writer, profile_ctx, per-chunk callback) from the aux flags;
    ``writes=False`` (every rank but 0 of a sharded run) writes no file."""
    import contextlib
    from hyptokenizer_tpu_torch.utils.metrics import (
        MetricsWriter, enable_nan_checks, profile_trace)
    if getattr(args, "debug_nans", False):
        enable_nan_checks(True)
    writer = (MetricsWriter(args.metrics_path)
              if args.metrics_path and writes else None)
    ctx = profile_trace(args.profile) if args.profile and writes else (
        contextlib.nullcontext())
    cb = writer.log if writer else (lambda stat: None)
    return writer, ctx, cb


def maybe_pretrain_embeddings(args, vocab, emb, log=None):
    """RSGD co-occurrence pretraining when --embed-steps > 0, on the
    embeddings' device, with draws seeded by --seed. ``log``, when given,
    gets one record: the stage's seconds and the loss trace's first and
    last ten-step means."""
    if not args.embed_steps:
        return emb
    if not args.corpus_path:
        raise SystemExit("--embed-steps requires --corpus-path")
    import time
    from hyptokenizer_tpu_torch.tokenizer import embed_train
    from hyptokenizer_tpu_torch.utils import data
    with data.open_text(args.corpus_path) as f:
        corpus = data.encode_corpus_chars(f, vocab, max_tokens=1 << 21)
    t0 = time.perf_counter()
    emb2, losses = embed_train.train_embeddings(
        emb, torch.from_numpy(corpus), len(vocab),
        embed_train.GeneratorSampler(args.seed, emb.device),
        steps=args.embed_steps, lr=args.embed_lr)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    seconds = time.perf_counter() - t0  # the float() reads waited for it
    logging.getLogger(__name__).info(
        "embedding pretraining: loss %.4f -> %.4f", first, last)
    if log is not None:
        log({"stage": "embed_pretrain", "seconds": seconds,
             "steps": args.embed_steps, "loss_first": first,
             "loss_last": last})
    return emb2


def load_or_build_vocab(vocab_path: Optional[str], corpus_path: Optional[str],
                        min_count: int = 5) -> List[str]:
    from hyptokenizer_tpu_torch.utils import data
    if vocab_path:
        return data.load_vocab(vocab_path)
    if not corpus_path:
        raise SystemExit("need --vocab-path or --corpus-path")
    with data.open_text(corpus_path) as f:
        return data.build_initial_vocab(f, min_count=min_count)
