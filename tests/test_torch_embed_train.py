"""The port's embedding trainers (hyptokenizer_tpu_torch/tokenizer/
embed_train.py) against the JAX package's, on the CPU.

Same initial points (the JAX package's ``random_points``, as numpy), same
inputs made with numpy from a seed, same draws (``ReplayDraws`` follows the
JAX trainers' key splits). Tolerances: embeddings and loss traces within
``rtol=1e-4, atol=1e-5`` after 40 steps (float32 autograd: the gradient is
summed in another order; the RSGD retraction compounds the difference step
by step), ``merge_tree_pairs`` exactly. The behaviour tests of
``tests/test_embed_train.py`` are ported too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.ops import lorentz as JL
from hyptokenizer_tpu.tokenizer import embed_train as JET
from hyptokenizer_tpu_torch.ops import lorentz as TL
from hyptokenizer_tpu_torch.tokenizer import embed_train as TET
from tests.torch_port_common import (
    one_torch_thread, ReplayDraws)  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
V, D, STEPS, BATCH = 32, 8, 40, 64


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    emb0 = np.array(JL.random_points(jax.random.PRNGKey(1), V, D,
                                     sigma=0.5))
    corpus = rng.integers(-2, V, size=400).astype(np.int32)
    pairs = rng.integers(0, V, size=(50, 2)).astype(np.int32)
    weights = rng.random(50).astype(np.float32)
    targets = (1 + rng.integers(0, 5, 50)).astype(np.float32)
    return emb0, corpus, pairs, weights, targets


def _close(jax_out, torch_out):
    je, jl = (np.asarray(x) for x in jax_out)
    te, tl = (x.numpy() for x in torch_out)
    assert te.shape == je.shape and tl.shape == jl.shape
    np.testing.assert_allclose(te, je, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


def test_train_embeddings_matches_jax(inputs):
    emb0, corpus, *_ = inputs
    j = JET.train_embeddings(jnp.asarray(emb0), jnp.asarray(corpus), V,
                             jax.random.PRNGKey(2), steps=STEPS,
                             batch=BATCH, negatives=5, lr=0.3)
    t = TET.train_embeddings(torch.from_numpy(emb0), torch.from_numpy(corpus),
                             V, ReplayDraws(jax.random.PRNGKey(2), 3),
                             steps=STEPS, batch=BATCH, negatives=5, lr=0.3)
    _close(j, t)


def test_train_embeddings_pairs_matches_jax(inputs):
    emb0, _, pairs, weights, _ = inputs
    pool = np.arange(3, V, dtype=np.int32)
    j = JET.train_embeddings_pairs(
        jnp.asarray(emb0), jnp.asarray(pairs), jnp.asarray(weights),
        jnp.asarray(pool), jax.random.PRNGKey(3), steps=STEPS, batch=BATCH,
        negatives=5, c=1.5)
    t = TET.train_embeddings_pairs(
        torch.from_numpy(emb0), pairs, weights, pool,
        ReplayDraws(jax.random.PRNGKey(3), 3), steps=STEPS, batch=BATCH,
        negatives=5, c=1.5)
    _close(j, t)


def test_train_embeddings_stress_matches_jax(inputs):
    emb0, _, pairs, _, targets = inputs
    j = JET.train_embeddings_stress(
        jnp.asarray(emb0), jnp.asarray(pairs), jnp.asarray(targets),
        jax.random.PRNGKey(4), steps=STEPS, batch=BATCH)
    t = TET.train_embeddings_stress(
        torch.from_numpy(emb0), pairs, targets,
        ReplayDraws(jax.random.PRNGKey(4), 2), steps=STEPS, batch=BATCH)
    _close(j, t)


def test_train_embeddings_ordinal_matches_jax(inputs):
    emb0, _, pairs, _, targets = inputs
    j = JET.train_embeddings_ordinal(
        jnp.asarray(emb0), jnp.asarray(pairs), jnp.asarray(targets),
        jax.random.PRNGKey(5), steps=STEPS, batch=BATCH, margin=0.1)
    t = TET.train_embeddings_ordinal(
        torch.from_numpy(emb0), pairs, targets,
        ReplayDraws(jax.random.PRNGKey(5), 3), steps=STEPS, batch=BATCH,
        margin=0.1)
    _close(j, t)


def test_loss_matches_jax(inputs):
    emb0, *_ = inputs
    rng = np.random.default_rng(3)
    u, v = rng.integers(0, V, 16), rng.integers(0, V, 16)
    neg = rng.integers(0, V, (16, 4))
    j = float(JET._loss(jnp.asarray(emb0), u, v, neg, 1.0))
    t = float(TET._loss(torch.from_numpy(emb0), torch.from_numpy(u),
                        torch.from_numpy(v), torch.from_numpy(neg), 1.0))
    assert t == pytest.approx(j, rel=1e-6)


@pytest.mark.parametrize("n_merges", [0, 1, 40])
def test_merge_tree_pairs_matches_jax(n_merges):
    rng = np.random.default_rng(n_merges)
    n_init = 12
    history = [(int(rng.integers(0, n_init + k)),
                int(rng.integers(0, n_init + k))) for k in range(n_merges)]
    jp, jw = JET.merge_tree_pairs(history, n_init, n_init + n_merges + 4)
    tp, tw = TET.merge_tree_pairs(history, n_init, n_init + n_merges + 4)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tw, jw)
    assert tp.dtype == jp.dtype and tw.dtype == jw.dtype


def test_clamp_gradient_splits_at_a_tie():
    """At an exact tie with the clamp ``jnp.maximum`` passes half the
    gradient; the port's distance does the same, ``clamp_min`` would pass
    all of it."""
    x = torch.tensor([1.0 + TET.GRAD_EPS], requires_grad=True)
    y = torch.maximum(x, x.new_tensor(1.0 + TET.GRAD_EPS))
    g, = torch.autograd.grad(y.sum(), x)
    jg = jax.grad(lambda a: jnp.maximum(a, 1.0 + TET.GRAD_EPS).sum())(
        jnp.asarray([np.float32(1.0 + TET.GRAD_EPS)]))
    assert float(g[0]) == float(jg[0]) == 0.5


def test_cooccurring_tokens_get_closer():
    """tests/test_embed_train.py's behaviour, on the port: tokens 0-1 and
    2-3 always adjacent, cross pairs never."""
    rng = np.random.default_rng(0)
    blocks = []
    for _ in range(500):
        blocks.extend([0, 1] if rng.random() < 0.5 else [2, 3])
        blocks.append(-2)
    corpus = torch.from_numpy(np.asarray(blocks, np.int32))
    gen = torch.Generator().manual_seed(1)
    emb0 = TL.random_points(gen, 4, 8, sigma=0.5, device="cpu")
    emb, losses = TET.train_embeddings(emb0, corpus, 4, 2, steps=300,
                                       batch=128, negatives=3, lr=0.3)
    np.testing.assert_allclose(TL.minkowski_dot(emb, emb).numpy(), 1.0,
                               atol=1e-4)
    assert float(losses[-20:].mean()) < float(losses[:20].mean())
    d = lambda a, b: float(TL.distance(emb[a], emb[b]))  # noqa: E731
    assert d(0, 1) < d(0, 2) and d(0, 1) < d(1, 3)
    assert d(2, 3) < d(0, 2) and d(2, 3) < d(1, 3)


def test_separators_and_pad_are_ignored():
    """A corpus of separators and PAD only has no valid pair: every step's
    loss is 0 and the table stays finite and unmoved."""
    gen = torch.Generator().manual_seed(2)
    emb0 = TL.random_points(gen, 6, 4, sigma=0.3, device="cpu")
    corpus = torch.tensor([-2, -1, -2, -2, -1, -1, -2, -1], dtype=torch.int32)
    emb, losses = TET.train_embeddings(emb0, corpus, 6, 0, steps=5,
                                       batch=16, negatives=2)
    assert torch.isfinite(emb).all()
    assert torch.all(losses == 0)
    np.testing.assert_allclose(emb.numpy(), emb0.numpy(), atol=1e-6)


def test_runs_are_reproducible_bit_for_bit(inputs):
    """Two runs with the same inputs and seed give the same bits: the
    gather's backward sums in a fixed order (autograd's own scatter-add on
    the CPU does not)."""
    emb0, corpus, *_ = inputs
    runs = [TET.train_embeddings(torch.from_numpy(emb0),
                                 torch.from_numpy(corpus), V, 11, steps=20,
                                 batch=256, negatives=8) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    rows = TET._scatter_rows(5, torch.tensor([3, 0, 3, 3]),
                             torch.arange(8.0).reshape(4, 2))
    torch.testing.assert_close(rows, torch.tensor(
        [[2.0, 3.0], [0, 0], [0, 0], [10.0, 13.0], [0, 0]]))
