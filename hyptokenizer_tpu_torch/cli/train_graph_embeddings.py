"""Hierarchy-aware embedding training for a saved tokenizer.

    python -m hyptokenizer_tpu_torch.cli.train_graph_embeddings \\
        --tokenizer-dir out/tok --output-dir out/tok_hs --merge-tree

Port of ``hyptokenizer_tpu/cli/train_graph_embeddings.py``: RSGD-train the
saved embeddings on hierarchy supervision (``tokenizer/embed_train.py``),
then rerun ``cli.eval_hierarchy`` on the updated artifacts. Two sources:

* ``--graph-path``: WordNet hypernym-path pairs among vocab-mapped synsets
  within ``--max-graph-dist`` hops, weighted 1/(graph distance). Needs
  ``networkx`` and a graph pickle (``evals/hierarchy.build_wordnet_graph``);
* ``--merge-tree``: the tokenizer's own merge-tree (child, parent) edges
  with depth weighting; needs no graph.

Writes ``embeddings.npy``/``embeddings.pt`` into ``--output-dir`` beside a
copy of the other artifacts. Runs on ``--device`` (default: the card).
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from hyptokenizer_tpu_torch.cli._common import setup_logging


def graph_pairs(graph, mapping, max_dist: int):
    """(u_id, v_id) pairs for mapped nodes within max_dist hops; w = 1/d."""
    import networkx as nx

    mapped = {n: i for n, i in mapping.items()}
    pairs, weights = [], []
    for src, src_id in mapped.items():
        lengths = nx.single_source_shortest_path_length(
            graph, src, cutoff=max_dist)
        for dst, d in lengths.items():
            if d == 0:
                continue
            dst_id = mapped.get(dst)
            if dst_id is not None and dst_id > src_id:  # dedupe (u, v)/(v, u)
                pairs.append((src_id, dst_id))
                weights.append(1.0 / d)
    return (np.asarray(pairs, np.int32).reshape(-1, 2),
            np.asarray(weights, np.float32))


def _merge_tree_edges(tok):
    """The merge tree's (child, parent) pairs and weights of ``tok``."""
    from hyptokenizer_tpu_torch.tokenizer import embed_train as ET
    n_vocab = len(tok.vocab)
    t2i = tok.token2idx  # built once: the property rebuilds it per call
    return ET.merge_tree_pairs(
        [(t2i[a], t2i[b]) for a, b, _ in tok.merge_history],
        n_vocab - len(tok.merge_history), n_vocab)


def supervise_embeddings(tok, graph_path=None, merge_tree=False,
                         seed: int = 0, ranking_steps: int = 27_000,
                         ordinal_steps: int = 32_000, lr: float = 0.3,
                         batch: int = 2048, negatives: int = 10,
                         hop_rank: int = 8, hop_ord: int = 20):
    """Hierarchy supervision recipe, as one call on a live tokenizer.

    WordNet mode: ranking-NLL warm-up over <=hop_rank-hop pairs, then a
    two-stage ordinal pairwise-order polish over <=hop_ord-hop pairs (the
    second stage doubles the batch and cools the lr). Merge-tree mode:
    ranking NLL on the tokenizer's own merge tree for ``ranking_steps // 3``
    steps. Draws are seeded as the JAX package keys them (``seed`` for the
    ranking warm-up, ``seed + 1`` and ``seed + 3`` for the polish stages,
    ``seed + 2`` for the merge tree). Returns the updated (V, d+1)
    embeddings, a tensor on the tokenizer's device.
    """
    from hyptokenizer_tpu_torch.tokenizer import embed_train as ET

    dev = tok.device
    n_vocab = len(tok.vocab)
    emb = tok.state.emb[:n_vocab].clone()
    c = float(tok.state.curvature)

    if graph_path:
        from hyptokenizer_tpu_torch.evals import create_node_mapping, \
            load_wordnet_graph
        graph = load_wordnet_graph(graph_path)
        mapping = create_node_mapping(graph, tok.vocab)
        neg_pool = np.asarray(sorted(set(mapping.values())), np.int32)
        pairs_r, w_r = graph_pairs(graph, mapping, hop_rank)
        emb, _ = ET.train_embeddings_pairs(
            emb, pairs_r, w_r, neg_pool, ET.GeneratorSampler(seed, dev),
            steps=ranking_steps, batch=batch, negatives=negatives, lr=lr,
            c=c)
        pairs_o, w_o = graph_pairs(graph, mapping, hop_ord)
        targets = 1.0 / w_o
        emb, _ = ET.train_embeddings_ordinal(
            emb, pairs_o, targets, ET.GeneratorSampler(seed + 1, dev),
            steps=ordinal_steps // 2, batch=max(batch, 1), lr=lr, c=c)
        emb, _ = ET.train_embeddings_ordinal(
            emb, pairs_o, targets, ET.GeneratorSampler(seed + 3, dev),
            steps=ordinal_steps // 2, batch=max(2 * batch, 1),
            lr=2 * lr / 3, c=c)
    if merge_tree:
        pairs, w = _merge_tree_edges(tok)
        if pairs.shape[0]:
            emb, _ = ET.train_embeddings_pairs(
                emb, pairs, w, np.arange(n_vocab, dtype=np.int32),
                ET.GeneratorSampler(seed + 2, dev), steps=ranking_steps // 3,
                batch=batch, negatives=negatives, lr=lr, c=c)
    return emb


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tokenizer-dir", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--graph-path", type=str, default=None)
    p.add_argument("--merge-tree", action="store_true",
                   help="supervise on the tokenizer's own merge-tree edges")
    p.add_argument("--max-graph-dist", type=int, default=3)
    p.add_argument("--objective", choices=("ranking", "stress", "ordinal"),
                   default="ranking",
                   help="ranking: NLL vs random negatives (Nickel & Kiela); "
                        "stress: scale-free metric fit of embedding distance "
                        "to graph distance; ordinal: pairwise order "
                        "consistency (what eval_hierarchy's spearman_r "
                        "measures)")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--negatives", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    setup_logging()
    if not args.graph_path and not args.merge_tree:
        raise SystemExit("need --graph-path and/or --merge-tree")

    from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer
    from hyptokenizer_tpu_torch.tokenizer import embed_train as ET

    tok = HyperbolicTokenizer.load(args.tokenizer_dir, device=args.device)
    n_vocab = len(tok.vocab)
    emb = tok.state.emb[:n_vocab].clone()

    all_pairs, all_w = [], []
    neg_pool = None
    graph_w = None
    if args.graph_path:
        from hyptokenizer_tpu_torch.evals import create_node_mapping, \
            load_wordnet_graph
        graph = load_wordnet_graph(args.graph_path)
        mapping = create_node_mapping(graph, tok.vocab)
        pairs, graph_w = graph_pairs(graph, mapping, args.max_graph_dist)
        print(f"graph supervision: {len(mapping)} mapped nodes, "
              f"{pairs.shape[0]} pairs (<= {args.max_graph_dist} hops)")
        all_pairs.append(pairs)
        all_w.append(graph_w)
        # Contrast within the supervised submanifold: negatives from the
        # mapped ids, not the whole vocab.
        neg_pool = np.asarray(sorted(set(mapping.values())), np.int32)
    if args.merge_tree:
        pairs, w = _merge_tree_edges(tok)
        print(f"merge-tree supervision: {pairs.shape[0]} edges")
        all_pairs.append(pairs)
        all_w.append(w)
    pairs = np.concatenate(all_pairs)
    weights = np.concatenate(all_w)
    if pairs.shape[0] == 0:
        raise SystemExit("no supervision pairs found")
    if neg_pool is None:
        neg_pool = np.arange(n_vocab, dtype=np.int32)

    c = float(tok.state.curvature)
    sampler = ET.GeneratorSampler(args.seed, tok.device)
    if args.objective in ("stress", "ordinal"):
        if not args.graph_path or args.merge_tree:
            raise SystemExit(f"--objective {args.objective} needs "
                             "--graph-path alone (targets are graph "
                             "distances)")
        targets = 1.0 / graph_w  # graph_pairs weights are 1/distance
        train = (ET.train_embeddings_stress if args.objective == "stress"
                 else ET.train_embeddings_ordinal)
        emb_out, losses = train(emb, pairs, targets, sampler,
                                steps=args.steps, batch=max(args.batch, 1),
                                lr=args.lr, c=c)
    else:
        emb_out, losses = ET.train_embeddings_pairs(
            emb, pairs, weights, neg_pool, sampler, steps=args.steps,
            batch=args.batch, negatives=args.negatives, lr=args.lr, c=c)
    print(f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f} "
          f"over {args.steps} steps")

    os.makedirs(args.output_dir, exist_ok=True)
    for name in os.listdir(args.tokenizer_dir):
        src = os.path.join(args.tokenizer_dir, name)
        if os.path.isfile(src) and not name.startswith("embeddings"):
            shutil.copy2(src, os.path.join(args.output_dir, name))
    emb_np = emb_out.cpu().numpy()
    np.save(os.path.join(args.output_dir, "embeddings.npy"), emb_np)
    torch.save(torch.from_numpy(emb_np.copy()),
               os.path.join(args.output_dir, "embeddings.pt"))
    print(f"wrote updated embeddings to {args.output_dir}")


if __name__ == "__main__":
    main()
