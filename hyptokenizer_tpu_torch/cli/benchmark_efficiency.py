"""Tokenization throughput benchmark.

    python -m hyptokenizer_tpu_torch.cli.benchmark_efficiency \\
        --tokenizer-dir out/tok --text-path corpus.txt --output-path eff.json

Port of ``hyptokenizer_tpu/cli/benchmark_efficiency.py``: tokens/sec of
``tokenize`` and of ``encode`` (the native encoder when it builds) with
warmup, and the training figures of ``training_stats.json`` and
``training_summary.json``. The tokenizer loads on ``--device`` (default:
the card; the load's re-scan runs there); tokenizing and encoding run on
the host.
"""

from __future__ import annotations

import argparse
import json
import os

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.cli._common import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tokenizer-dir", type=str, required=True)
    p.add_argument("--text-path", type=str, required=True)
    p.add_argument("--max-lines", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--output-path", type=str, default=None)
    p.add_argument("--sentencepiece-model", type=str, default=None,
                   help="optional SentencePiece .model baseline to measure "
                        "alongside (reference benchmark_efficiency.py:97-123)"
                        "; skipped gracefully when the package is absent")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    setup_logging()
    _device.resolve(args.device)   # no card: raises unless --device cpu

    from hyptokenizer_tpu_torch.evals.comparison import measure_throughput
    from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer

    tok = HyperbolicTokenizer.load(args.tokenizer_dir, device=args.device)
    texts = []
    with open(args.text_path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                texts.append(line.strip())
            if len(texts) >= args.max_lines:
                break

    result = measure_throughput(tok.tokenize, texts, runs=args.runs,
                                warmup=args.warmup)
    # Encode path (native when built) measured separately.
    result_encode = measure_throughput(
        lambda t: tok.encode(t), texts, runs=args.runs, warmup=args.warmup)
    result = {"tokenize": result, "encode": result_encode}

    if args.sentencepiece_model:
        from hyptokenizer_tpu_torch.evals.baselines import (
            SentencePieceWrapper, sentencepiece_available)
        if sentencepiece_available():
            sp = SentencePieceWrapper(args.sentencepiece_model)
            result["sentencepiece"] = measure_throughput(
                sp.tokenize, texts, runs=args.runs, warmup=args.warmup)
        else:
            result["sentencepiece"] = {
                "skipped": "sentencepiece package not installed"}

    stats_path = os.path.join(args.tokenizer_dir, "training_stats.json")
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            stats = json.load(f)
        # Last per-step record (older artifacts appended a summary dict).
        stats = [s for s in stats if "step" in s]
        if stats:
            result["training"] = {
                "final_vocab": stats[-1].get("vocab_size"),
                "merge_steps_per_sec": stats[-1].get("steps_per_sec"),
            }
    summary_path = os.path.join(args.tokenizer_dir, "training_summary.json")
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            result["training_summary"] = json.load(f)
    print(json.dumps(result, indent=2))
    if args.output_path:
        with open(args.output_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
