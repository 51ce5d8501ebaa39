"""WordNet hierarchy distortion evaluation, in PyTorch.

Port of ``hyptokenizer_tpu/evals/hierarchy.py``: load the WordNet graph,
map synset names to vocabulary indices, sample connected node pairs
(``random.Random(seed)``, so the pairs are the JAX package's), and compare
hyperbolic embedding distance to graph shortest-path distance, every
distance in one batch on ``device``. Graph work stays on the host in
``networkx``, which is imported inside the functions that need it (as are
``nltk`` and ``scipy``): importing this module needs neither.
"""

from __future__ import annotations

import pickle
import random
from typing import Dict, List, Tuple

import numpy as np
import torch

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.ops import lorentz as L


def load_wordnet_graph(path: str):
    """Plain-pickle load of a graph this repo's ``build_wordnet_graph``
    wrote (unpickle only files you trust)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def create_node_mapping(graph, vocab: List[str]) -> Dict[str, int]:
    """synset name 'word.pos.id' -> vocab index (first occurrence)."""
    first_idx: Dict[str, int] = {}
    for i, tok in enumerate(vocab):
        first_idx.setdefault(tok, i)
    mapping = {}
    for node in graph.nodes():
        word = str(node).split(".")[0]
        if word in first_idx:
            mapping[node] = first_idx[word]
    return mapping


def sample_connected_pairs(graph, valid_nodes: List, num_pairs: int,
                           seed: int = 42,
                           max_attempts_factor: int = 20) -> List[Tuple]:
    """Sample connected node pairs with their shortest-path length."""
    import networkx as nx

    rng = random.Random(seed)
    pairs = []
    attempts = 0
    max_attempts = num_pairs * max_attempts_factor
    while len(pairs) < num_pairs and attempts < max_attempts:
        attempts += 1
        a, b = rng.sample(valid_nodes, 2)
        try:
            d = nx.shortest_path_length(graph, a, b)
        except nx.NetworkXNoPath:
            continue
        pairs.append((a, b, d))
    return pairs


def compute_distortion(graph, embeddings, node_mapping: Dict[str, int],
                       num_pairs: int = 10_000, curvature: float = 1.0,
                       seed: int = 42, device=None):
    """(ratios, stats) of hyperbolic distance / graph distance, the
    distances in one batch on ``device`` (default: the card)."""
    valid_nodes = list(node_mapping.keys())
    if len(valid_nodes) < 2:
        raise ValueError("fewer than 2 graph nodes map into the vocabulary")
    pairs = sample_connected_pairs(graph, valid_nodes, num_pairs, seed)
    if not pairs:
        raise ValueError("no connected pairs sampled")

    dev = _device.resolve(device)
    emb = torch.as_tensor(np.asarray(embeddings, np.float32)).to(dev)
    ii = torch.tensor([node_mapping[a] for a, _, _ in pairs],
                      dtype=torch.long, device=dev)
    jj = torch.tensor([node_mapping[b] for _, b, _ in pairs],
                      dtype=torch.long, device=dev)
    graph_d = np.asarray([d for _, _, d in pairs], np.float64)
    emb_d = L.distance(emb[ii], emb[jj], curvature).cpu().numpy()

    ratios = emb_d / graph_d
    stats = {
        "mean": float(np.mean(ratios)),
        "median": float(np.median(ratios)),
        "min": float(np.min(ratios)),
        "max": float(np.max(ratios)),
        "std": float(np.std(ratios)),
        "num_pairs": int(len(ratios)),
    }
    # The ratio is scale-degenerate (shrinking every embedding toward the
    # origin drives it to 0); the rank correlation is scale-free.
    if len(ratios) >= 3 and np.std(emb_d) > 0 and np.std(graph_d) > 0:
        from scipy import stats as sps
        stats["pearson_r"] = float(np.corrcoef(graph_d, emb_d)[0, 1])
        stats["spearman_r"] = float(sps.spearmanr(graph_d, emb_d).statistic)
    return ratios, stats


def build_wordnet_graph(output_path: str):
    """Undirected graph over noun-synset hypernym edges, pickled.

    Needs ``networkx`` and ``nltk`` with its WordNet data (``LookupError``
    when the data is absent; use a pre-built pickle instead).
    """
    import networkx as nx
    from nltk.corpus import wordnet as wn

    g = nx.Graph()
    for synset in wn.all_synsets("n"):
        for hyper in synset.hypernyms():
            g.add_edge(synset.name(), hyper.name())
    with open(output_path, "wb") as f:
        pickle.dump(g, f)
    return g
