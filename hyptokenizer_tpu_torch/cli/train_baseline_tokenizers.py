"""Train baseline tokenizers (BPE/WordPiece/Unigram/char) for comparison.

    python -m hyptokenizer_tpu_torch.cli.train_baseline_tokenizers \\
        --input-file corpus.txt --output-dir out/base --kinds bpe

Port of ``hyptokenizer_tpu/cli/train_baseline_tokenizers.py`` (host only:
the HF ``tokenizers`` library, imported when a baseline is trained).
"""

from __future__ import annotations

import argparse
import json

from hyptokenizer_tpu_torch.cli._common import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input-file", action="append", required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--vocab-size", action="append", type=int, default=None)
    p.add_argument("--kinds", type=str, default="bpe,wordpiece,unigram,char")
    args = p.parse_args(argv)
    setup_logging()

    from hyptokenizer_tpu_torch.evals.baselines import train_all_baselines

    sizes = args.vocab_size or [10_000, 20_000, 50_000]
    results = train_all_baselines(
        args.input_file, args.output_dir, vocab_sizes=sizes,
        kinds=tuple(args.kinds.split(",")))
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
