"""The port's distance-only tokenizer == the JAX package's, and the port's
repairs of its earlier slices.

* ``HyperbolicTokenizer`` training (startup threshold controller on, the
  JAX package's distance-statistics draws injected through
  ``ReplaySampler``) gives the JAX package's merge history, thresholds and
  ``training_stats``, before and after save/load, and artifacts move both
  ways with identical encodes.
* Every gram of the port runs in full float32 whatever the process-wide
  matmul precision, and leaves that setting as it found it.
* A kernel's build is named by its source AND the headers it includes, so
  an edited header is never served a stale library.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.ops import lorentz as JL
from hyptokenizer_tpu.tokenizer import HyperbolicTokenizer as JaxBase
from hyptokenizer_tpu_torch.ops import lorentz as L
from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.tokenizer import FastHyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer as TorchBase
from hyptokenizer_tpu_torch.tokenizer import search
from hyptokenizer_tpu_torch.tokenizer import state as TS
from tests.torch_port_common import ReplaySampler

VOCAB = [chr(0x61 + k) for k in range(26)] + [chr(0x41 + k)
                                              for k in range(14)]
TEXTS = ["abcabc", "thecat", "ABBA", "zzz", ""]


def points(sigma=0.3, seed=0, n=len(VOCAB), d=7):
    return np.asarray(JL.random_points(jax.random.PRNGKey(seed), n, d,
                                       sigma=sigma))


def make_base_pair(**kw):
    """The same distance-only tokenizer in both packages; the port on the
    CPU with the JAX package's statistics draws."""
    kw = dict(dict(merge_threshold=50.0, max_vocab_size=256,
                   search_block=64), **kw)
    emb = points()
    jt = JaxBase(VOCAB, emb, **kw)
    tt = TorchBase(VOCAB, emb, device="cpu", **kw)
    tt.stats_sampler = ReplaySampler()
    return jt, tt


def assert_same_stats(js, ts):
    """Per-chunk entries: the same keys, counters equal, thresholds within
    float32 rounding (the controller's 1.5 x mean is a float32 mean summed
    in another order), and the sampled distance statistics of the same
    pairs within 1e-4 relative (a pair near the acosh clamp floor turns a
    gram's last-bit difference into ~1e-4 of distance)."""
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert set(a) == set(b)
        for k in ("step", "vocab_size", "merges"):
            assert a[k] == b[k], k
        np.testing.assert_allclose(a["threshold"], b["threshold"], rtol=1e-6)
        for k in ("min_dist", "max_dist", "mean_dist", "std_dist"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6)


def test_distance_statistics_match_jax():
    jt, tt = make_base_pair()
    for _ in range(3):      # successive draws follow the same key chain
        a, b = jt.distance_statistics(), tt.distance_statistics()
        for k in ("min", "max", "mean", "std"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)


def test_statistics_sampler_draws_on_the_state_device():
    s = TS.StatsSampler(3, "cpu")
    i, j = s.stats(1000, 7)
    assert i.dtype == j.dtype == torch.int32
    assert int(i.min()) >= 0 and int(i.max()) <= 6
    assert int(j.min()) >= 0 and int(j.max()) <= 5
    out = TS.distance_statistics(torch.from_numpy(points().copy()), 40,
                                 torch.tensor(1.0), s)
    assert out.shape == (4,) and out.dtype == torch.float32


@pytest.mark.parametrize("adaptive", [True, False])
def test_training_matches_jax(adaptive):
    """Controller (with ``adaptive``), chunks, statistics: the merge
    history, thresholds and ``training_stats`` equal the JAX package's."""
    jt, tt = make_base_pair(adaptive_threshold=adaptive)
    if adaptive:
        thr = float(jt.state.threshold)
    jt.optimize_merges(90, log_every=30)
    tt.optimize_merges(90, log_every=30)
    assert len(tt.merge_history) >= 60
    assert tt.merge_history == jt.merge_history
    assert tt.vocab == jt.vocab
    assert_same_stats(jt.training_stats, tt.training_stats)
    np.testing.assert_allclose(tt.merge_threshold, jt.merge_threshold,
                               rtol=1e-6)
    if adaptive:   # the controller pulled the threshold down
        assert tt.startup_stats["threshold_before"] == thr
        assert tt.startup_stats["threshold_after"] < thr
    # Rows made above the acosh clamp floor (~5e-4, as
    # tests/test_merge_loop_kernel.py): below it a midpoint's weights come
    # from a distance that amplifies the gram's rounding.
    n = next((k for k, x in enumerate(np.asarray(
        jt.state.merge_dists[:len(jt.merge_history)])) if x <= 1e-3),
        len(jt.merge_history))
    assert n >= 5
    v = len(VOCAB) + n
    np.testing.assert_allclose(tt.embeddings[:v], jt.embeddings[:v],
                               atol=1e-4)


def test_adaptive_threshold_compat_kwarg():
    jt, tt = make_base_pair(merge_threshold=1e-6)
    jt.optimize_merges(40, log_every=40, adaptive_threshold=False)
    tt.optimize_merges(40, log_every=40, adaptive_threshold=False)
    assert not tt.config.adaptive_threshold
    assert tt.startup_stats is None          # the controller did not run
    assert bool(tt.state.stopped) and int(tt.state.step) == 10
    assert_same_stats(jt.training_stats, tt.training_stats)


def test_save_load_both_ways_and_train_on(tmp_path):
    """Artifacts move between the packages with identical encodes, and a
    loaded tokenizer trains on exactly as the JAX package's does."""
    jt, tt = make_base_pair()
    jt.optimize_merges(60, log_every=30)
    tt.optimize_merges(60, log_every=30)
    assert tt.merge_history == jt.merge_history
    pj, pt = tmp_path / "jax", tmp_path / "port"
    jt.save(str(pj))
    tt.save(str(pt))
    back_t = TorchBase.load(str(pj), device="cpu")
    back_j = JaxBase.load(str(pt))
    assert back_t.vocab == back_j.vocab == jt.vocab
    for text in TEXTS:
        assert back_t.encode(text) == back_j.encode(text) == jt.encode(text)
        assert back_t.decode(back_t.encode(text)) == text
    # The load re-scan equals the JAX package's candidates, within the
    # merge-loop tests' tolerance (acosh amplifies a gram's rounding near
    # the clamp floor).
    bt = back_t.state.best_dist.numpy()
    bj = np.asarray(back_j.state.best_dist)
    fin = np.isfinite(bj)
    np.testing.assert_array_equal(np.isfinite(bt), fin)
    tol = 1e-4 + 4e-6 / np.maximum(bj[fin], 1e-5)
    assert np.all(np.abs(bt[fin] - bj[fin]) <= tol)
    back_t.stats_sampler = ReplaySampler()
    back_j.optimize_merges(40, log_every=20)
    back_t.optimize_merges(40, log_every=20)
    assert len(back_t.merge_history) > len(jt.merge_history)
    assert back_t.merge_history == back_j.merge_history
    assert_same_stats(back_j.training_stats, back_t.training_stats)


def test_fast_alias_and_exports():
    from hyptokenizer_tpu_torch import tokenizer as T

    assert FastHyperbolicTokenizer is TorchBase
    for name in ("MergeConfig", "MergeState", "init_state", "merge_step",
                 "run_merges", "HyperbolicTokenizer",
                 "FastHyperbolicTokenizer"):
        assert hasattr(T, name), name


@pytest.fixture
def matmul_precision():
    """Runs the test with TF32 allowed process-wide, and restores the
    full-float32 setting after it."""
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision("highest")


def test_grams_run_with_tf32_off(matmul_precision, monkeypatch):
    """After ``torch.set_float32_matmul_precision("high")`` every gram
    helper of the port runs its matmul at "highest" (TF32 off) and leaves
    the process at "high"."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32))
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    x = torch.from_numpy(points(n=50).copy())
    c = torch.tensor(1.0)
    L.pairwise_minkowski_dot(x, x)
    L.pairwise_dist(x, x[:3], c)
    search.full_pass_best(x, 50, c, torch.empty((0, 2), dtype=torch.int32),
                          0, block=16)
    search.row_best(x, 3, 50, c, torch.empty((0, 2), dtype=torch.int32), 0)
    st = TS.init_state(x, torch.ones(50, dtype=torch.int32), threshold=5.0,
                       config=TS.MergeConfig(max_vocab_size=64),
                       device="cpu")
    TS.run_merges_plain(st, TS.MergeConfig(max_vocab_size=64), 3)
    TS.insert_batch(st, torch.tensor([0, 1]), torch.tensor([2, 3]),
                    torch.tensor([0.1, 0.2]), fold=True)
    assert len(seen) >= 6
    assert all(s == ("highest", False) for s in seen), seen
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cuda.matmul.allow_tf32


def test_header_edit_renames_the_build(tmp_path, monkeypatch):
    """``_build._target`` hashes every header under csrc/ that a source
    includes: editing ``common.cuh`` changes each including source's
    library path, and editing an unrelated file does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    names = _build.sources()
    assert {"enhanced_loop", "merge_loop", "pairwise"} <= set(names)
    before = {n: _build._target(n)[1] for n in names}
    (csrc / "unrelated.txt").write_text("x")
    assert {n: _build._target(n)[1] for n in names} == before
    with open(csrc / "common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._target(n)[1] for n in names}
    for n in names:
        assert after[n] != before[n], n
        assert os.path.basename(after[n]).startswith(n + "-")
