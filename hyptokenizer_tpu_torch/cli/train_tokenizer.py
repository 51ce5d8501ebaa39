"""Train a standard/fast (distance-only) hyperbolic tokenizer.

    python -m hyptokenizer_tpu_torch.cli.train_tokenizer \\
        --corpus-path corpus.txt --output-dir out/base --embedding-dim 100 \\
        --max-vocab-size 50000 --steps 4096

Port of ``hyptokenizer_tpu/cli/train_tokenizer.py``: ``HyperbolicTokenizer``
on ``--device`` (default: the card; kernels K3 in the constructor and K4 in
training), trained chunk by chunk (``--log-every`` steps each) with a
checkpoint every ``--checkpoint-every`` chunks, then ``save``,
``train_config.json`` and ``training_stats.json``. As in the JAX CLI no
token-length cap is passed: the distance-only loop can build long strings
(chains of a token with its own midpoints) when run deep.
"""

from __future__ import annotations

import argparse
import json
import os

from hyptokenizer_tpu_torch.cli._common import (
    add_common_tokenizer_args, add_multihost_args, load_or_build_vocab,
    maybe_init_multihost, maybe_pretrain_embeddings, parse_with_config,
    persist_train_config, set_seeds, setup_logging, training_observability,
)


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv``); returns the trained
    tokenizer."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_tokenizer_args(p)
    add_multihost_args(p)
    p.add_argument("--tokenizer-type", choices=["standard", "fast"],
                   default="fast")
    p.add_argument("--adaptive-threshold",
                   action=argparse.BooleanOptionalAction, default=True)
    args, _ = parse_with_config(p, argv)

    setup_logging()
    set_seeds(args.seed)

    from hyptokenizer_tpu_torch import _device
    from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer
    from hyptokenizer_tpu_torch.utils import data

    mesh = maybe_init_multihost(args, _device.resolve(args.device))
    dev = _device.resolve(args.device) if mesh is None else mesh.device
    writes = mesh is None or mesh.rank == 0   # rank 0 alone writes files
    writer, profile_ctx, metrics_cb = training_observability(args, writes)
    vocab = load_or_build_vocab(args.vocab_path, args.corpus_path)
    emb = data.initialize_embeddings(len(vocab), args.embedding_dim,
                                     args.curvature, args.init_sigma,
                                     args.seed, device=dev)
    emb = maybe_pretrain_embeddings(args, vocab, emb, log=metrics_cb)
    tok = HyperbolicTokenizer(
        vocab, emb, curvature=args.curvature,
        merge_threshold=args.merge_threshold,
        max_vocab_size=args.max_vocab_size,
        adaptive_threshold=args.adaptive_threshold,
        device=dev,
        mesh=mesh,
    )
    if args.resume and args.checkpoint_dir:
        from hyptokenizer_tpu_torch.utils.checkpoint import restore_checkpoint
        restore_checkpoint(args.checkpoint_dir, tok)
    steps = args.steps
    if args.target_vocab_size is not None:
        steps = min(steps, max(0, args.target_vocab_size - len(vocab)))
    done = 0
    chunk_i = 0
    with profile_ctx:
        while done < steps and not bool(tok.state.stopped):
            chunk = min(args.log_every, steps - done)
            tok.optimize_merges(steps=chunk, log_every=chunk)
            metrics_cb(tok.training_stats[-1])
            done += chunk
            chunk_i += 1
            if args.checkpoint_dir and args.checkpoint_every and \
                    writes and chunk_i % args.checkpoint_every == 0:
                from hyptokenizer_tpu_torch.utils.checkpoint import \
                    save_checkpoint
                save_checkpoint(args.checkpoint_dir, tok)
    if not writes:
        return tok
    tok.save(args.output_dir)
    persist_train_config(args, args.output_dir)
    with open(os.path.join(args.output_dir, "training_stats.json"), "w") as f:
        json.dump(tok.training_stats, f)
    print(f"saved tokenizer with {tok.current_vocab_size} tokens to "
          f"{args.output_dir}")
    return tok


if __name__ == "__main__":
    main()
