"""Train hyperbolic image-text retrieval (two-tower contrastive).

    python -m hyptokenizer_tpu_torch.cli.train_retrieval --synthetic \\
        --output-dir out/ret

Port of ``hyptokenizer_tpu/cli/train_retrieval.py`` with the same flags and
defaults, plus ``--device`` (default: the card). Real data: a captions TSV
(``image_path<TAB>caption``) and a tokenizer for captions, or COCO's
captions json and image directory; ``--synthetic`` runs the correlated toy
task. Writes ``retrieval_history.json`` and the best state as
``best_params.pt`` (``torch.save`` of a ``state_dict``, in place of the JAX
CLI's flax-msgpack ``best_params.msgpack``); ``main`` returns the output of
``models.retrieval.train_retrieval``.
"""

from __future__ import annotations

import argparse
import json
import os

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.cli._common import set_seeds, setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--captions-tsv", type=str, default=None)
    p.add_argument("--coco-annotations", type=str, default=None,
                   help="COCO captions json (e.g. captions_val2014.json)")
    p.add_argument("--coco-image-dir", type=str, default=None)
    p.add_argument("--tokenizer-dir", type=str, default=None)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--batches-per-epoch", type=int, default=20)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--projection-dim", type=int, default=64)
    p.add_argument("--tower-dim", type=int, default=128)
    p.add_argument("--tower-depth", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--temperature", type=float, default=0.07)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    setup_logging()
    _device.resolve(args.device)   # no card: raises unless --device cpu
    set_seeds(args.seed)

    import numpy as np

    from hyptokenizer_tpu_torch.models import (
        MultimodalHyperbolicModel, TransformerTower, ViTTower,
    )
    from hyptokenizer_tpu_torch.models.retrieval import (
        synthetic_batches, train_retrieval,
    )

    vocab_size = 256
    tok = None
    if args.tokenizer_dir:
        from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer
        tok = HyperbolicTokenizer.load(args.tokenizer_dir,
                                       device=args.device)
        vocab_size = tok.current_vocab_size

    model = MultimodalHyperbolicModel(
        text_encoder=TransformerTower(vocab_size=vocab_size,
                                      dim=args.tower_dim,
                                      depth=args.tower_depth, heads=4,
                                      max_len=args.seq_len),
        image_encoder=ViTTower(image_size=args.image_size, patch_size=8,
                               dim=args.tower_dim, depth=args.tower_depth,
                               heads=4),
        projection_dim=args.projection_dim, hidden_dim=args.tower_dim * 2)

    if args.coco_annotations and args.coco_image_dir and not args.captions_tsv:
        # Flatten COCO captions to the TSV path format (train_retrieval.py's
        # COCO Dataset wrapper, reference :56-114).
        with open(args.coco_annotations, encoding="utf-8") as f:
            coco = json.load(f)
        id2file = {img["id"]: img["file_name"] for img in coco["images"]}
        tsv = os.path.join(args.output_dir, "coco_captions.tsv")
        os.makedirs(args.output_dir, exist_ok=True)
        with open(tsv, "w", encoding="utf-8") as f:
            for ann in coco["annotations"]:
                fn = id2file.get(ann["image_id"])
                if fn:
                    f.write(os.path.join(args.coco_image_dir, fn) + "\t"
                            + ann["caption"].replace("\t", " ").strip() + "\n")
        args.captions_tsv = tsv

    if args.synthetic or not args.captions_tsv:
        def batches_fn():
            return synthetic_batches(args.batches_per_epoch, args.batch_size,
                                     args.image_size, args.seq_len,
                                     vocab_size, seed=args.seed)
        eval_batch = next(iter(synthetic_batches(
            1, args.batch_size, args.image_size, args.seq_len, vocab_size,
            seed=args.seed + 999)))
    else:
        from PIL import Image
        pairs = []
        with open(args.captions_tsv, encoding="utf-8") as f:
            for line in f:
                path, _, caption = line.rstrip("\n").partition("\t")
                if path and caption:
                    pairs.append((path, caption))

        def encode_caption(caption):
            ids = tok.encode(caption)[: args.seq_len]
            out = np.zeros((args.seq_len,), np.int32)
            mask = np.zeros((args.seq_len,), np.int32)
            out[: len(ids)] = ids
            mask[: len(ids)] = 1
            return out, mask

        def load_image(path):
            img = Image.open(path).convert("RGB").resize(
                (args.image_size, args.image_size))
            return np.asarray(img, np.float32) / 127.5 - 1.0

        def batches_fn():
            rng = np.random.default_rng(args.seed)
            order = rng.permutation(len(pairs))
            for s in range(0, len(order) - args.batch_size + 1,
                           args.batch_size):
                idx = order[s:s + args.batch_size]
                images = np.stack([load_image(pairs[k][0]) for k in idx])
                enc = [encode_caption(pairs[k][1]) for k in idx]
                ids = np.stack([e[0] for e in enc])
                mask = np.stack([e[1] for e in enc])
                yield images, ids, mask
        eval_batch = next(iter(batches_fn()))

    out = train_retrieval(model, batches_fn, epochs=args.epochs, lr=args.lr,
                          temperature=args.temperature, seed=args.seed,
                          eval_batch=eval_batch, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "retrieval_history.json"), "w") as f:
        json.dump(out["history"], f, indent=2)
    import torch
    torch.save(out["best"]["params"],
               os.path.join(args.output_dir, "best_params.pt"))
    print(f"best R@1: {out['best']['r1']:.3f}; artifacts in {args.output_dir}")
    return out


if __name__ == "__main__":
    main()
