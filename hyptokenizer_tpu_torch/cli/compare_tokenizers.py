"""Compare tokenizers: throughput, linguistic quality, compression (+ plots).

    python -m hyptokenizer_tpu_torch.cli.compare_tokenizers \\
        --tokenizer hyp=out/tok --tokenizer bpe=out/base/bpe_50000.json \\
        --text-path corpus.txt --output-dir out/cmp

Port of ``hyptokenizer_tpu/cli/compare_tokenizers.py``, with ``--device``
(default: the card), where the port's tokenizers load (the load's re-scan
runs there); tokenizing runs on the host. Accepts any mix of the port's
tokenizer dirs and HF ``tokenizers`` JSON files.
"""

from __future__ import annotations

import argparse
import json
import os

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.cli._common import setup_logging


def _load_tokenize_fn(path: str, device=None):
    if os.path.isdir(path):
        from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer
        tok = HyperbolicTokenizer.load(path, device=device)
        return tok.tokenize
    from tokenizers import Tokenizer
    tok = Tokenizer.from_file(path)
    return lambda text: tok.encode(text).tokens


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tokenizer", action="append", required=True,
                   metavar="NAME=PATH",
                   help="repeatable; framework dir or HF tokenizer.json")
    p.add_argument("--text-path", type=str, required=True)
    p.add_argument("--max-lines", type=int, default=200)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--plot", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    setup_logging()
    _device.resolve(args.device)   # no card: raises unless --device cpu

    from hyptokenizer_tpu_torch.evals.comparison import compare_tokenizers

    texts = []
    with open(args.text_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if line.strip():
                texts.append(line.strip())
            if len(texts) >= args.max_lines:
                break

    toks = {}
    for spec in args.tokenizer:
        name, _, path = spec.partition("=")
        toks[name] = _load_tokenize_fn(path, args.device)

    results = compare_tokenizers(toks, texts, runs=args.runs)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "comparison.json"), "w") as f:
        json.dump(results, f, indent=2)
    for name, res in results.items():
        print(f"{name}: {res['throughput']['tokens_per_sec']:.0f} tok/s, "
              f"{res['compression']['chars_per_token']:.3f} chars/tok, "
              f"word-boundary {res['quality']['word_boundary_ratio']:.3f}")

    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            names = list(results)
            fig, axes = plt.subplots(1, 3, figsize=(15, 4))
            axes[0].bar(names, [results[n]["throughput"]["tokens_per_sec"]
                                for n in names])
            axes[0].set_title("tokens/sec")
            axes[1].bar(names, [results[n]["compression"]["chars_per_token"]
                                for n in names])
            axes[1].set_title("chars/token")
            axes[2].bar(names, [results[n]["quality"]["word_boundary_ratio"]
                                for n in names])
            axes[2].set_title("word-boundary ratio")
            for ax in axes:
                ax.tick_params(axis="x", rotation=30)
            fig.tight_layout()
            fig.savefig(os.path.join(args.output_dir, "comparison.png"),
                        dpi=120)
            print(f"wrote plot to {args.output_dir}/comparison.png")

            # Radar chart over per-metric max-normalised scores
            # (reference compare_tokenizers.py:451-556).
            import numpy as np
            metrics = [
                ("tokens/sec", lambda r: r["throughput"]["tokens_per_sec"]),
                ("chars/token", lambda r: r["compression"]["chars_per_token"]),
                ("morpheme", lambda r: r["quality"]["morpheme_ratio"]),
                ("word-boundary",
                 lambda r: r["quality"]["word_boundary_ratio"]),
                ("subword", lambda r: r["quality"]["subword_ratio"]),
            ]
            vals = np.array([[get(results[n]) for _, get in metrics]
                             for n in names], dtype=float)
            peak = np.maximum(vals.max(axis=0), 1e-12)
            scores = vals / peak
            ang = np.linspace(0, 2 * np.pi, len(metrics), endpoint=False)
            ang_c = np.concatenate([ang, ang[:1]])
            fig2, ax = plt.subplots(figsize=(6, 6),
                                    subplot_kw={"projection": "polar"})
            for n, row in zip(names, scores):
                closed = np.concatenate([row, row[:1]])
                ax.plot(ang_c, closed, label=n)
                ax.fill(ang_c, closed, alpha=0.1)
            ax.set_xticks(ang)
            ax.set_xticklabels([m for m, _ in metrics])
            ax.set_ylim(0, 1.05)
            ax.legend(loc="upper right", bbox_to_anchor=(1.3, 1.1))
            fig2.tight_layout()
            fig2.savefig(os.path.join(args.output_dir, "comparison_radar.png"),
                         dpi=120)
            print(f"wrote plot to {args.output_dir}/comparison_radar.png")
        except Exception as e:  # plotting is best-effort
            print(f"plotting skipped: {e}")
    return results


if __name__ == "__main__":
    main()
