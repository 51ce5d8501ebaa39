"""Preprocess raw text (wiki dumps or plain text) and build an initial vocab.

    python -m hyptokenizer_tpu_torch.cli.preprocess_wiki \\
        --input-path data/wiki_corpus.txt.bz2 --output-dir out/data

Port of ``hyptokenizer_tpu/cli/preprocess_wiki.py`` (host only): the
``clean_text`` pipeline, BZ2-aware streaming, and a char-frequency vocab
with a min_count filter, written as ``wiki_processed.txt`` and
``vocab_initial.txt``.
"""

from __future__ import annotations

import argparse
import os

from hyptokenizer_tpu_torch.cli._common import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input-path", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--min-line-length", type=int, default=10)
    p.add_argument("--max-lines", type=int, default=None)
    p.add_argument("--min-count", type=int, default=5)
    args = p.parse_args(argv)
    setup_logging()

    from hyptokenizer_tpu_torch.utils import data

    os.makedirs(args.output_dir, exist_ok=True)
    out_text = os.path.join(args.output_dir, "wiki_processed.txt")
    n = 0
    with data.open_text(args.input_path) as fin, \
            open(out_text, "w", encoding="utf-8") as fout:
        for cleaned in data.preprocess_lines(fin, args.min_line_length):
            fout.write(cleaned + "\n")
            n += 1
            if args.max_lines and n >= args.max_lines:
                break
    print(f"wrote {n} cleaned lines to {out_text}")

    with open(out_text, encoding="utf-8") as f:
        vocab = data.build_initial_vocab(f, min_count=args.min_count)
    out_vocab = os.path.join(args.output_dir, "vocab_initial.txt")
    data.save_vocab(vocab, out_vocab)
    print(f"wrote vocabulary with {len(vocab)} tokens to {out_vocab}")


if __name__ == "__main__":
    main()
