"""The port's hierarchy evaluation and supervision (hyptokenizer_tpu_torch/
evals/hierarchy.py, cli/train_graph_embeddings.py) against the JAX
package's, on the CPU, over a synthetic ``networkx`` tree built here.

``create_node_mapping`` and ``sample_connected_pairs`` compare exactly
(both keep ``random.Random(seed)``), ``compute_distortion``'s ratios and
statistics within 1e-5 (float32 distances). ``supervise_embeddings`` in
merge-tree and in graph mode runs with the JAX package's draws (each of
its seeded samplers replays ``PRNGKey(seed + k)``) and compares within
``rtol=1e-4, atol=1e-5``, the embedding trainers' tolerance.
"""

import json
import pickle

import jax
import networkx as nx
import numpy as np
import pytest

from hyptokenizer_tpu.cli import train_graph_embeddings as JG
from hyptokenizer_tpu.evals import hierarchy as JH
from hyptokenizer_tpu_torch.cli import train_graph_embeddings as TG
from hyptokenizer_tpu_torch.evals import hierarchy as TH
from hyptokenizer_tpu_torch.tokenizer import embed_train as TET
from tests.torch_port_common import (
    one_torch_thread, ReplayDraws, ReplaySampler, make_pair)  # noqa: F401

VOCAB = ["<pad>", "<unk>"] + [f"w{i}" for i in range(40)] + ["w3", "zz"]


def tree_graph():
    """A balanced tree of synset-named nodes ('w<i>.n.01'), plus a
    disconnected pair and nodes whose word is not in the vocabulary."""
    g = nx.balanced_tree(3, 3)  # 40 nodes
    g = nx.relabel_nodes(g, {i: f"w{i}.n.01" for i in g.nodes()})
    g.add_edge("w3.n.02", "w1.n.01")
    g.add_edge("lone.n.01", "other.n.01")
    return g


def test_node_mapping_and_pairs_match_jax():
    g = tree_graph()
    m = TH.create_node_mapping(g, VOCAB)
    assert m == JH.create_node_mapping(g, VOCAB)
    assert m["w3.n.01"] == m["w3.n.02"] == VOCAB.index("w3")
    nodes = list(m)
    assert TH.sample_connected_pairs(g, nodes, 50, seed=5) == \
        JH.sample_connected_pairs(g, nodes, 50, seed=5)


def test_compute_distortion_matches_jax():
    g = tree_graph()
    m = TH.create_node_mapping(g, VOCAB)
    rng = np.random.default_rng(0)
    spatial = 0.4 * rng.standard_normal((len(VOCAB), 6)).astype(np.float32)
    emb = np.concatenate([np.sqrt(1 + (spatial ** 2).sum(1, keepdims=True)),
                          spatial], axis=1).astype(np.float32)
    tr, ts = TH.compute_distortion(g, emb, m, num_pairs=200, curvature=1.3,
                                   seed=3, device="cpu")
    jr, js = JH.compute_distortion(g, emb, m, num_pairs=200, curvature=1.3,
                                   seed=3)
    np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-5)
    assert ts.keys() == js.keys()
    for key in ts:
        assert ts[key] == pytest.approx(js[key], rel=1e-5, abs=1e-5), key
    with pytest.raises(ValueError, match="fewer than 2"):
        TH.compute_distortion(g, emb, {"w1.n.01": 1}, device="cpu")


def test_graph_pairs_match_jax():
    g = tree_graph()
    m = TH.create_node_mapping(g, VOCAB)
    for hops in (1, 3):
        tp, tw = TG.graph_pairs(g, m, hops)
        jp, jw = JG.graph_pairs(g, m, hops)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tw, jw)


def _replay_seeds(monkeypatch):
    monkeypatch.setattr(
        TET, "GeneratorSampler",
        lambda seed, device=None: ReplayDraws(jax.random.PRNGKey(seed), 3))


def test_supervise_merge_tree_matches_jax(monkeypatch):
    jt, tt = make_pair()
    tt.sampler = ReplaySampler(jt.enh_state.key)
    jt.optimize_merges(steps=24, log_every=12)
    tt.optimize_merges(steps=24, log_every=12)
    assert tt.merge_history == jt.merge_history
    _replay_seeds(monkeypatch)
    kw = dict(merge_tree=True, seed=4, ranking_steps=60, batch=64,
              negatives=4)
    je = JG.supervise_embeddings(jt, **kw)
    te = TG.supervise_embeddings(tt, **kw)
    assert te.shape == je.shape == (len(tt.vocab), 9)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-4, atol=1e-5)


def test_supervise_graph_mode_matches_jax(monkeypatch, tmp_path):
    jt, tt = make_pair()
    vocab = tt.vocab
    g = nx.Graph()
    words = [t for t in vocab if t.strip() and t.isalpha()]
    for a, b in zip(words, words[1:]):
        g.add_edge(f"{a}.n.01", f"{b}.n.01")
    path = str(tmp_path / "g.pkl")
    with open(path, "wb") as f:
        pickle.dump(g, f)
    _replay_seeds(monkeypatch)
    kw = dict(graph_path=path, seed=1, ranking_steps=20, ordinal_steps=20,
              batch=32, negatives=3, hop_rank=2, hop_ord=4)
    je = JG.supervise_embeddings(jt, **kw)
    te = TG.supervise_embeddings(tt, **kw)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-4, atol=1e-5)


def test_train_graph_embeddings_and_eval_cli(tmp_path):
    """The two CLIs end to end on the CPU: merge-tree supervision of saved
    artifacts, then the distortion evaluation against a graph."""
    from hyptokenizer_tpu_torch.cli import eval_hierarchy, \
        train_graph_embeddings
    _, tt = make_pair()
    tt.optimize_merges(steps=16, log_every=16)
    src = str(tmp_path / "tok")
    tt.save(src)
    out = str(tmp_path / "hs")
    train_graph_embeddings.main([
        "--tokenizer-dir", src, "--output-dir", out, "--merge-tree",
        "--steps", "20", "--batch", "32", "--device", "cpu"])
    new = np.load(f"{out}/embeddings.npy")
    assert new.shape == tt.embeddings.shape and np.isfinite(new).all()
    assert not np.allclose(new, tt.embeddings)
    g = nx.Graph()
    for a, b in [("a.n.01", "t.n.01"), ("t.n.01", "c.n.01"),
                 ("c.n.01", "d.n.01")]:
        g.add_edge(a, b)
    gp = str(tmp_path / "g.pkl")
    with open(gp, "wb") as f:
        pickle.dump(g, f)
    eval_hierarchy.main(["--tokenizer-dir", out, "--graph-path", gp,
                         "--output-dir", str(tmp_path / "ev"),
                         "--num-pairs", "20", "--device", "cpu"])
    with open(tmp_path / "ev" / "distortion_stats.json") as f:
        assert json.load(f)["num_pairs"] == 20
    with pytest.raises(SystemExit):
        train_graph_embeddings.main(["--tokenizer-dir", src,
                                     "--output-dir", out, "--device", "cpu"])
