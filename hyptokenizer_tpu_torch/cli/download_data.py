"""Download corpora (enwiki / WikiText-103 / Yahoo Answers / COCO).

    python -m hyptokenizer_tpu_torch.cli.download_data \\
        --dataset wikitext103 --output-dir data/raw

Port of ``hyptokenizer_tpu/cli/download_data.py`` (host only). Without a
network every download fails gracefully with instructions; local paths can
be supplied instead everywhere downstream.
"""

from __future__ import annotations

import argparse
import os
import urllib.request

from hyptokenizer_tpu_torch.cli._common import setup_logging

URLS = {
    "wikitext103": "https://s3.amazonaws.com/research.metamind.io/wikitext/"
                   "wikitext-103-v1.zip",
    "enwiki": "https://dumps.wikimedia.org/enwiki/latest/"
              "enwiki-latest-pages-articles-multistream-index.txt.bz2",
}


def _download(url: str, dest: str) -> bool:
    try:
        urllib.request.urlretrieve(url, dest)
        return True
    except Exception as e:
        print(f"download failed ({type(e).__name__}: {e}). "
              f"Fetch {url} manually and place it at {dest}.")
        return False


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", choices=["wikitext103", "enwiki",
                                         "yahoo_answers", "coco"],
                   required=True)
    p.add_argument("--output-dir", type=str, required=True)
    args = p.parse_args(argv)
    setup_logging()
    os.makedirs(args.output_dir, exist_ok=True)

    if args.dataset in URLS:
        dest = os.path.join(args.output_dir, os.path.basename(URLS[args.dataset]))
        if _download(URLS[args.dataset], dest):
            print(f"downloaded to {dest}")
        return
    if args.dataset == "yahoo_answers":
        try:
            from datasets import load_dataset
            ds = load_dataset("yahoo_answers_topics")
            for split in ds:
                out = os.path.join(args.output_dir, f"{split}.txt")
                with open(out, "w", encoding="utf-8") as f:
                    for ex in ds[split]:
                        f.write(ex["question_title"].replace("\n", " ") + "\n")
            print(f"exported yahoo_answers_topics to {args.output_dir}")
        except Exception as e:
            print(f"HF download failed ({e}); provide local text files.")
        return
    if args.dataset == "coco":
        print("COCO requires manual download (as in the reference, "
              "download_huggingface_data.py:83-113): fetch train2014/val2014 "
              "images + annotations from https://cocodataset.org and unpack "
              f"under {args.output_dir}.")


if __name__ == "__main__":
    main()
