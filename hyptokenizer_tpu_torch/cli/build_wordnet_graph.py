"""Build the WordNet noun-hypernym graph (pickle).

    python -m hyptokenizer_tpu_torch.cli.build_wordnet_graph \\
        --output-path wordnet_graph.pkl

Port of ``hyptokenizer_tpu/cli/build_wordnet_graph.py`` (host only).
Requires ``networkx`` and nltk's WordNet data; without the data it exits
with a message (point ``eval_hierarchy`` at a pre-built pickle instead).
"""

from __future__ import annotations

import argparse

from hyptokenizer_tpu_torch.cli._common import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output-path", type=str, required=True)
    args = p.parse_args(argv)
    setup_logging()

    from hyptokenizer_tpu_torch.evals.hierarchy import build_wordnet_graph
    try:
        g = build_wordnet_graph(args.output_path)
    except LookupError as e:
        raise SystemExit(
            "nltk wordnet data is not installed (and cannot be downloaded "
            "in a zero-egress environment). Use an existing graph pickle. "
            f"Underlying error: {e}")
    print(f"wrote graph with {g.number_of_nodes()} nodes / "
          f"{g.number_of_edges()} edges to {args.output_path}")
    return g


if __name__ == "__main__":
    main()
