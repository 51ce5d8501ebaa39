"""Evaluate hierarchy preservation: WordNet graph vs embedding distances.

    python -m hyptokenizer_tpu_torch.cli.eval_hierarchy \\
        --tokenizer-dir out/tok --graph-path wordnet_graph.pkl \\
        --output-dir out/hier

Port of ``hyptokenizer_tpu/cli/eval_hierarchy.py``: writes
``distortion_ratios.npy`` and ``distortion_stats.json``. Needs ``networkx``
and a graph pickle; the distances run on ``--device`` (default: the card).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from hyptokenizer_tpu_torch.cli._common import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tokenizer-dir", type=str, required=True)
    p.add_argument("--graph-path", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--num-pairs", type=int, default=10_000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    setup_logging()

    from hyptokenizer_tpu_torch.evals import (
        compute_distortion, create_node_mapping, load_wordnet_graph,
    )
    from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer

    tok = HyperbolicTokenizer.load(args.tokenizer_dir, device=args.device)
    graph = load_wordnet_graph(args.graph_path)
    mapping = create_node_mapping(graph, tok.vocab)
    print(f"mapped {len(mapping)}/{graph.number_of_nodes()} nodes")
    ratios, stats = compute_distortion(
        graph, tok.embeddings, mapping, num_pairs=args.num_pairs,
        curvature=float(tok.state.curvature), seed=args.seed,
        device=tok.device)

    os.makedirs(args.output_dir, exist_ok=True)
    np.save(os.path.join(args.output_dir, "distortion_ratios.npy"), ratios)
    with open(os.path.join(args.output_dir, "distortion_stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
