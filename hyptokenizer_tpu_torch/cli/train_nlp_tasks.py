"""Train downstream NLP tasks (BERT MLM + classification) with a tokenizer.

    python -m hyptokenizer_tpu_torch.cli.train_nlp_tasks \\
        --model-path out/tok --train-text corpus.txt --val-text val.txt \\
        --train-cls train.tsv --val-cls val.tsv --output-dir out/nlp

Port of ``hyptokenizer_tpu/cli/train_nlp_tasks.py`` with the same flags and
defaults, plus ``--device`` (default: the card), where the tokenizer loads
and BERT trains (``models/nlp.py``: the port's own BERT modules, no
``transformers``). Classification data is ``label<TAB>text`` lines. Writes
``nlp_results.json``; ``main`` returns ``(results, models)``, the trained
modules by task.
"""

from __future__ import annotations

import argparse
import json
import os

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.cli._common import set_seeds, setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--method", default="hyperbolic",
                   choices=["hyperbolic", "bpe", "bytelevel", "wordpiece", "unigram",
                            "char", "sentencepiece"])
    p.add_argument("--model-path", required=True,
                   help="tokenizer dir (hyperbolic) or tokenizer.json")
    p.add_argument("--task", choices=["mlm", "classification", "both"],
                   default="both")
    p.add_argument("--train-text", type=str, default=None,
                   help="text file for MLM")
    p.add_argument("--val-text", type=str, default=None,
                   help="held-out text for MLM perplexity")
    p.add_argument("--train-cls", type=str, default=None,
                   help="label<TAB>text file for classification")
    p.add_argument("--val-cls", type=str, default=None,
                   help="held-out label<TAB>text file; reported accuracy "
                        "becomes held-out accuracy")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--max-length", type=int, default=128)
    p.add_argument("--hidden-size", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--max-lines", type=int, default=2000)
    p.add_argument("--use-hyperbolic-embeddings",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--inject-scale", choices=["raw", "matched"],
                   default="matched",
                   help="injected-embedding scaling: raw = copy values "
                        "(reference behavior; std ~12x the BERT init, the "
                        "round-3 cls regression), matched = rescale to the "
                        "0.02 init std preserving directions")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    setup_logging()
    _device.resolve(args.device)   # no card: raises unless --device cpu
    set_seeds(args.seed)

    from hyptokenizer_tpu_torch.models import nlp

    adapter = nlp.TokenizerAdapter(args.method, args.model_path,
                                   device=args.device)
    emb = adapter.get_embeddings() if args.use_hyperbolic_embeddings else None
    vocab_size = adapter.get_vocab_size()
    os.makedirs(args.output_dir, exist_ok=True)
    results = {}
    models = {}

    if args.task in ("mlm", "both"):
        if not args.train_text:
            raise SystemExit("--train-text required for MLM")
        texts = []
        with open(args.train_text, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    texts.append(line.strip())
                if len(texts) >= args.max_lines:
                    break
        encoded = adapter.batch_encode(texts, max_length=args.max_length)
        eval_encoded = None
        if args.val_text:
            val_texts = []
            with open(args.val_text, encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        val_texts.append(line.strip())
                    if len(val_texts) >= args.max_lines // 4:
                        break
            eval_encoded = adapter.batch_encode(val_texts,
                                                max_length=args.max_length)
        model = nlp.build_bert_mlm(
            vocab_size, hidden=args.hidden_size, layers=args.num_layers,
            heads=args.num_heads, seed=args.seed, embeddings=emb,
            inject_scale=args.inject_scale, device=args.device)
        models["mlm"], ppl = nlp.mlm_train(
            model, encoded, epochs=args.epochs, batch_size=args.batch_size,
            max_length=args.max_length, lr=args.lr, seed=args.seed,
            eval_encoded=eval_encoded)
        key = "mlm_val_perplexity" if eval_encoded else "mlm_perplexity"
        results[key] = ppl
        print(f"MLM perplexity ({'val' if eval_encoded else 'train'}): "
              f"{ppl:.2f}")

    if args.task in ("classification", "both") and args.train_cls:
        def read_tsv(path, cap):
            ts, ys = [], []
            with open(path, encoding="utf-8") as f:
                for line in f:
                    lab, _, text = line.rstrip("\n").partition("\t")
                    if text:
                        ys.append(int(lab))
                        ts.append(text)
                    if len(ts) >= cap:
                        break
            return ts, ys

        texts, labels = read_tsv(args.train_cls, args.max_lines)
        encoded = adapter.batch_encode(texts, max_length=args.max_length)
        eval_encoded = eval_labels = None
        n_labels = max(labels) + 1
        if args.val_cls:
            vtexts, eval_labels = read_tsv(args.val_cls, args.max_lines)
            eval_encoded = adapter.batch_encode(vtexts,
                                                max_length=args.max_length)
            n_labels = max(n_labels, max(eval_labels) + 1)
        model = nlp.build_bert_classifier(
            vocab_size, num_labels=n_labels, hidden=args.hidden_size,
            layers=args.num_layers, heads=args.num_heads, seed=args.seed,
            embeddings=emb, inject_scale=args.inject_scale,
            device=args.device)
        models["classification"], acc = nlp.classification_train(
            model, encoded, labels, epochs=args.epochs,
            batch_size=args.batch_size, max_length=args.max_length,
            lr=args.lr, seed=args.seed,
            eval_encoded=eval_encoded, eval_labels=eval_labels)
        key = ("classification_val_accuracy" if args.val_cls
               else "classification_accuracy")
        results[key] = acc
        print(f"classification accuracy ({'val' if args.val_cls else 'train'}): {acc:.3f}")

    with open(os.path.join(args.output_dir, "nlp_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results, models


if __name__ == "__main__":
    main()
