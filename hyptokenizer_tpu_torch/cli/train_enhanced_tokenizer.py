"""Train the enhanced (all-features) hyperbolic tokenizer.

    python -m hyptokenizer_tpu_torch.cli.train_enhanced_tokenizer \\
        --corpus-path corpus.txt --output-dir out/tok --embedding-dim 100 \\
        --max-vocab-size 50000 --steps 46000 --embed-steps 3000 \\
        --pre-split words --merge-policy priority

Port of ``hyptokenizer_tpu/cli/train_enhanced_tokenizer.py``, with its
flags and flow: embedding pretraining (``--embed-steps``), the normalizer
from ``--pre-split``, ``--resume`` and the checkpoint callback, the metrics
callback, the profile context, ``optimize_merges`` with the phase
transitions, hierarchy supervision, ``save`` and ``train_config.json``. One
process writes the artifacts (the sharded path waits for ``parallel/``).
``--device`` picks the device (default: the card). With ``--metrics-path``
the stream also gets one record per stage with its seconds: ``stage`` is
``embed_pretrain`` (with the loss trace's first and last ten-step means),
``train`` or ``hierarchy_supervision``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from hyptokenizer_tpu_torch.cli._common import (
    add_common_tokenizer_args, add_multihost_args, load_or_build_vocab,
    maybe_init_multihost, maybe_pretrain_embeddings, parse_with_config,
    persist_train_config, set_seeds, setup_logging, training_observability,
)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv``); returns the trained
    tokenizer."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_tokenizer_args(p)
    add_multihost_args(p)
    ba = argparse.BooleanOptionalAction
    p.add_argument("--use-frequency-aware", action=ba, default=True)
    p.add_argument("--use-hierarchical", action=ba, default=True)
    p.add_argument("--use-adaptive-curvature", action=ba, default=True)
    p.add_argument("--use-compression-aware", action=ba, default=True)
    p.add_argument("--alpha", type=float, default=0.4)
    p.add_argument("--beta", type=float, default=0.4)
    p.add_argument("--gamma", type=float, default=0.2)
    p.add_argument("--compression-weight", type=float, default=0.7)
    p.add_argument("--curvature-lr", type=float, default=0.01)
    p.add_argument("--hierarchy-weight", type=float, default=1.0)
    p.add_argument("--distortion-weight", type=float, default=0.1)
    p.add_argument("--optimize-curvature-freq", type=int, default=100)
    p.add_argument("--phase2-step", type=int, default=1000)
    p.add_argument("--phase3-step", type=int, default=6000)
    p.add_argument("--corpus-max-tokens", type=int, default=1 << 21)
    p.add_argument("--corpus-shards", type=int, default=8,
                   help="align corpus shard boundaries to PAD/SEP (kept for "
                        "the sharded sync; the corpus layout, and so the "
                        "merges, match the JAX package's)")
    p.add_argument("--merge-batch", type=int, default=8,
                   help="candidates consumed per scored round (1 = strict "
                        "greedy; >1 = the reference's cache-consume batching)")
    p.add_argument("--min-pair-freq", type=int, default=1,
                   help="minimum corpus occurrences for a corpus-pair "
                        "candidate")
    p.add_argument("--use-dense-channel", action=ba, default=True,
                   help="--no-use-dense-channel restricts merges to corpus "
                        "pairs (BPE-like; kernel K1 instead of K2)")
    p.add_argument("--merge-policy", choices=["fixpoint", "priority"],
                   default="fixpoint",
                   help="encode-time merge order: fixpoint = the reference's "
                        "multi-pass first-match scan; priority = classic BPE "
                        "rank order (reproduces the training trajectory)")
    p.add_argument("--freq-table-size", type=int, default=1 << 17,
                   help="pair-frequency snapshot slots (raise for large "
                        "corpora; overflow drops lowest-count pairs with a "
                        "warning)")
    p.add_argument("--queue-size", type=int, default=4096,
                   help="sparse-candidate queue length per phase")
    p.add_argument("--pre-split", choices=["none", "whitespace", "words"],
                   default="none",
                   help="lossless regex pre-split: merges never cross "
                        "segment boundaries (words = GPT-2-style leading-"
                        "space word units); applied at train AND encode time")
    p.add_argument("--hierarchy-supervision",
                   choices=["none", "wordnet", "merge-tree", "both"],
                   default="none",
                   help="after merge training, RSGD-train the saved "
                        "embeddings toward hierarchy structure so the "
                        "shipped artifact carries the signal (wordnet/both "
                        "need networkx and --graph-path)")
    p.add_argument("--graph-path", type=str, default=None,
                   help="WordNet graph pickle for --hierarchy-supervision "
                        "wordnet/both (evals/hierarchy.build_wordnet_graph)")
    p.add_argument("--hs-ranking-steps", type=int, default=27_000)
    p.add_argument("--hs-ordinal-steps", type=int, default=32_000)
    p.add_argument("--hs-lr", type=float, default=0.3)
    p.add_argument("--hs-hop-rank", type=int, default=8,
                   help="ranking warm-up hop cap")
    p.add_argument("--hs-hop-ord", type=int, default=20,
                   help="ordinal polish hop cap")
    args, _ = parse_with_config(p, argv)

    setup_logging()
    set_seeds(args.seed)
    if args.hierarchy_supervision in ("wordnet", "both") \
            and not args.graph_path:
        raise SystemExit("--hierarchy-supervision wordnet needs "
                         "--graph-path")

    from hyptokenizer_tpu_torch import _device
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    from hyptokenizer_tpu_torch.utils import data

    mesh = maybe_init_multihost(args, _device.resolve(args.device))
    dev = _device.resolve(args.device) if mesh is None else mesh.device
    # Only rank 0 of a sharded run writes files (every rank holds the same
    # state).
    writes = mesh is None or mesh.rank == 0
    # Before the pretraining, so that --debug-nans covers its autograd.
    writer, profile_ctx, metrics_cb = training_observability(args, writes)
    vocab = load_or_build_vocab(args.vocab_path, args.corpus_path)
    emb = data.initialize_embeddings(len(vocab), args.embedding_dim,
                                     args.curvature, args.init_sigma,
                                     args.seed, device=dev)
    emb = maybe_pretrain_embeddings(args, vocab, emb, log=metrics_cb)
    normalizer = None
    if args.pre_split != "none":
        from hyptokenizer_tpu_torch.tokenizer.normalize import (
            WHITESPACE, WORDS_WITH_SPACE, NormalizerConfig)
        normalizer = NormalizerConfig(pre_split={
            "whitespace": WHITESPACE, "words": WORDS_WITH_SPACE,
        }[args.pre_split])
    tok = EnhancedHyperbolicTokenizer(
        vocab, emb, device=dev, normalizer=normalizer,
        merge_policy=args.merge_policy,
        curvature=args.curvature,
        merge_threshold=args.merge_threshold,
        max_vocab_size=args.max_vocab_size,
        use_frequency_aware=args.use_frequency_aware,
        use_hierarchical=args.use_hierarchical,
        use_adaptive_curvature=args.use_adaptive_curvature,
        use_compression_aware=args.use_compression_aware,
        corpus_path=args.corpus_path,
        alpha=args.alpha, beta=args.beta, gamma=args.gamma,
        compression_weight=args.compression_weight,
        curvature_lr=args.curvature_lr,
        hierarchy_weight=args.hierarchy_weight,
        distortion_weight=args.distortion_weight,
        optimize_curvature_freq=args.optimize_curvature_freq,
        corpus_max_tokens=args.corpus_max_tokens,
        corpus_shards=args.corpus_shards,
        merge_batch=args.merge_batch,
        min_pair_freq=args.min_pair_freq,
        use_dense_channel=args.use_dense_channel,
        freq_table_size=args.freq_table_size,
        queue_size=args.queue_size,
        seed=args.seed,
        mesh=mesh,
    )
    if args.resume and args.checkpoint_dir:
        from hyptokenizer_tpu_torch.utils.checkpoint import restore_checkpoint
        restore_checkpoint(args.checkpoint_dir, tok)
    if args.checkpoint_dir and args.checkpoint_every and writes:
        from hyptokenizer_tpu_torch.utils.checkpoint import save_checkpoint
        counter = {"n": 0}

        def _ckpt_cb(stat):
            counter["n"] += 1
            if counter["n"] % args.checkpoint_every == 0:
                save_checkpoint(args.checkpoint_dir, tok)

        tok.register_callback(_ckpt_cb)
    tok.register_callback(metrics_cb)
    _sync(dev)
    t0 = time.perf_counter()
    with profile_ctx:
        tok.optimize_merges(
            steps=args.steps, log_every=args.log_every,
            sync_every=args.sync_every,
            target_vocab_size=args.target_vocab_size,
            phase_transition_steps={2: args.phase2_step, 3: args.phase3_step},
        )
    _sync(dev)
    metrics_cb({"stage": "train", "seconds": time.perf_counter() - t0,
                "merges": len(tok.merge_history)})
    if writer and tok.training_summary:
        writer.log(tok.training_summary)
    if not writes:
        return tok  # rank 0 alone supervises and writes the artifacts
    if args.hierarchy_supervision != "none":
        from hyptokenizer_tpu_torch.cli.train_graph_embeddings import \
            supervise_embeddings
        t0 = time.perf_counter()
        emb_out = supervise_embeddings(
            tok,
            graph_path=(args.graph_path
                        if args.hierarchy_supervision in ("wordnet", "both")
                        else None),
            merge_tree=args.hierarchy_supervision in ("merge-tree", "both"),
            seed=args.seed, ranking_steps=args.hs_ranking_steps,
            ordinal_steps=args.hs_ordinal_steps, lr=args.hs_lr,
            hop_rank=args.hs_hop_rank, hop_ord=args.hs_hop_ord)
        tok.state.emb[:emb_out.shape[0]] = emb_out
        tok.enh_state = dataclasses.replace(tok.enh_state, base=tok.state)
        _sync(dev)
        metrics_cb({"stage": "hierarchy_supervision",
                    "seconds": time.perf_counter() - t0,
                    "mode": args.hierarchy_supervision})
    tok.save(args.output_dir)
    persist_train_config(args, args.output_dir)
    print(f"saved enhanced tokenizer with {tok.current_vocab_size} tokens "
          f"(phase {tok.current_phase}, c={tok.curvature:.4f}) to "
          f"{args.output_dir}")
    return tok


if __name__ == "__main__":
    main()
