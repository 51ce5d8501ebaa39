"""The sync's candidate scoring on the CPU: ``enhanced_state.score_candidates``
takes the plain version for CPU tensors and gives the bits that the sync's
tensor code gave before kernel S1 (``ops/cuda/sync_score.py``) took its
place on the card; the wrapper's checks; the ``sync.score_launches``
counter; and the tolerance (``evals/selfcheck.score_tolerance``) that the
card's tests hold S1 to, which passes equal results and refuses faults.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hyptokenizer_tpu_torch.evals import selfcheck
from hyptokenizer_tpu_torch.ops import lorentz as L
from hyptokenizer_tpu_torch.ops.cuda import sync_score as S1
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from hyptokenizer_tpu_torch.tokenizer import scoring
from hyptokenizer_tpu_torch.tokenizer.state import MergeConfig
from hyptokenizer_tpu_torch.utils import metrics

INF = float("inf")
SMALL = dict(n_vocab=300, d=16, table_size=1000, n_pairs=800, n_samples=50)
CONFIGS = {
    "distance_only": dict(),
    "flagship": dict(use_frequency=True, alpha=0.05, beta=0.9, gamma=0.05),
    "all_features": dict(use_frequency=True, use_compression=True,
                         compression_weight=0.7, use_hierarchical=True),
    "gated": dict(use_frequency=True, use_compression=True,
                  use_hierarchical=True, min_pair_freq=2,
                  base=MergeConfig(max_token_len=3)),
}
CORPUS = ["the cat sat on the mat", "the dog sat on the log",
          "a cat and a dog and a rat", "walking dogs walk and walk"] * 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def inputs():
    return selfcheck.score_table_inputs("cpu", **SMALL)


def scores_as_before(config, inp):
    """The sync's scoring as its tensor code read before kernel S1: the
    distances, ``_full_scores_raw``, the gate, and the phase columns
    transposed for ``top_k_desc``."""
    keys, counts = inp["keys"], inp["counts"]
    emb, lengths = inp["emb"], inp["lengths"]
    valid = keys[:, 0] != scoring.PKEY_SENT
    rows = torch.where(valid, keys[:, 0], 0).long()
    cols = torch.where(valid, keys[:, 1], 0).long()
    dists = L.distance(emb[rows], emb[cols], inp["curvature"])
    dists = torch.where(valid, dists, INF)
    score3 = E._full_scores_raw(
        config, emb, lengths, inp["threshold"], inp["curvature"],
        inp["coh_samples"], inp["max_pair_count"], inp["corpus_tokens"],
        inp["token_hash"], inp["byte_lengths"], inp["has_vowel"],
        inp["hash_powers"], inp["morph_table"], inp["morph_size"],
        inp["word_table"], inp["word_size"], rows, cols, dists, counts)
    ok = valid & (counts >= config.min_pair_freq)
    if config.base.max_token_len > 0:
        ok &= (lengths[rows] + lengths[cols] <= config.base.max_token_len)
    score3 = torch.where(ok[:, None], score3, -INF)
    if config.use_hierarchical:
        return score3.T.contiguous(), dists, rows, cols
    return score3[:, :1].T.contiguous(), dists, rows, cols


def queues_as_before(config, inp, k):
    """The sync's queues as its tensor code made them before kernel S1."""
    sv, dists, rows, cols = scores_as_before(config, inp)
    if config.use_hierarchical:
        top_vals, top_pos = scoring.top_k_desc(sv, k)
        q_valid_total = (sv.T > -INF).sum(dim=0).to(torch.int32)
    else:
        tv1, tp1 = scoring.top_k_desc(sv, k)
        top_vals = tv1.expand(3, k).contiguous()
        top_pos = tp1.expand(3, k)
        q_valid_total = (sv[0] > -INF).sum().to(torch.int32).expand(3)
    stored = top_vals > -INF
    return (torch.where(stored, rows[top_pos], -1).to(torch.int32),
            torch.where(stored, cols[top_pos], -1).to(torch.int32),
            torch.where(stored, dists[top_pos], INF), top_vals,
            q_valid_total.contiguous())


@pytest.fixture
def no_kernel(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(S1, "score", refuse)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_score_candidates_on_the_cpu_keeps_the_bits(inputs, no_kernel,
                                                    name):
    cfg = E.EnhancedConfig(**CONFIGS[name])
    scores, dists = E.score_candidates(cfg, **inputs)
    want_s, want_d, _, _ = scores_as_before(cfg, inputs)
    assert scores.shape == (3 if cfg.use_hierarchical else 1,
                            inputs["keys"].shape[0])
    assert scores.is_contiguous()
    assert torch.equal(scores, want_s)
    assert torch.equal(dists, want_d)
    assert int((scores[0] > -INF).sum()) > 0


def small_tokenizer(**kw):
    chars = sorted({ch for line in CORPUS for ch in line})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    gen = torch.Generator(device="cpu").manual_seed(0)
    emb = L.random_points(gen, len(vocab), 8, sigma=0.6, device="cpu")
    cfg = dict(corpus_sample=CORPUS, max_vocab_size=256,
               merge_threshold=5.0, corpus_max_tokens=1024,
               freq_table_size=1024, queue_size=64, use_dense_channel=False,
               use_hierarchical=False, use_compression_aware=False,
               use_adaptive_curvature=False, alpha=0.05, beta=0.9,
               gamma=0.05, merge_batch=4, merge_policy="priority")
    cfg.update(kw)
    return EnhancedHyperbolicTokenizer(vocab, emb, device="cpu", **cfg)


@pytest.mark.parametrize("kw", [
    {}, dict(use_hierarchical=True, use_compression_aware=True,
             min_pair_freq=2)])
@pytest.mark.parametrize("frozen", [False, True])
def test_sync_queues_keep_the_bits(no_kernel, kw, frozen):
    """A sync's queues equal, bit for bit, the queues that the sync's
    tensor code made before kernel S1, live and with a frozen table (the
    consumed pairs dropped after the scoring)."""
    tok = small_tokenizer(**kw)
    first = E.sync_corpus(tok.enh_state, tok.enh_config,
                          E.TorchSampler(5, torch.device("cpu")))
    tok.optimize_merges(steps=30, log_every=30)
    cfg = dataclasses.replace(tok.enh_config, frozen_freqs=frozen)
    st = tok.enh_state
    if frozen:
        # The first table, which holds the pairs merged since.
        st = dataclasses.replace(
            st, pair_keys=first.pair_keys, pair_counts=first.pair_counts,
            max_pair_count=first.max_pair_count)
    st = E.sync_corpus(st, cfg, E.TorchSampler(7, torch.device("cpu")))
    inp = selfcheck.state_score_inputs(st)
    if frozen:
        nm = int(st.base.num_merges)
        consumed = scoring.in_sorted_pair_set(
            st.pair_keys[:, 0], st.pair_keys[:, 1],
            *E._sorted_history(st.base.merges[:nm]), nm)
        assert bool(consumed.any())
        inp = dict(inp, counts=torch.where(consumed, 0, inp["counts"]))
        cfg = dataclasses.replace(cfg, min_pair_freq=max(
            cfg.min_pair_freq, 1))
    want = queues_as_before(cfg, inp, cfg.queue_size)
    got = (st.q_i, st.q_j, st.q_dist, st.q_score, st.q_valid_total)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_contiguous()
        assert torch.equal(g, w)
    assert int((st.q_score > -INF).sum()) > 0


BAD = {
    "a CPU table": ({}, "CUDA tensor"),
    "keys int64": ({"keys": "long"}, "keys: dtype"),
    "emb not contiguous": ({"emb": "t"}, "emb: not contiguous"),
    "counts too short": ({"counts": "short"}, "counts: shape"),
    "lengths of another vocabulary": ({"lengths": "short"},
                                      "lengths: shape"),
    "token_hash one lane": ({"token_hash": "lane"}, "token_hash: shape"),
    "has_vowel as int": ({"has_vowel": "int"}, "has_vowel: dtype"),
    "threshold float64": ({"threshold": "double"}, "threshold: dtype"),
    "max_count of two": ({"max_pair_count": "two"},
                         "max_count: 2 elements"),
    "samples int64": ({"coh_samples": "long"}, "samples: dtype"),
}


def spoil(t, how):
    return {"long": lambda: t.long(), "t": lambda: t.t().contiguous().t(),
            "short": lambda: t[:-1], "lane": lambda: t[:, :1].contiguous(),
            "int": lambda: t.int(), "double": lambda: t.double(),
            "two": lambda: t.reshape(1).repeat(2)}[how]()


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_refuses_bad_tensors(inputs, case):
    change, message = BAD[case]
    inp = dict(inputs, **{k: spoil(inputs[k], how)
                          for k, how in change.items()})
    names = ("keys", "counts", "emb", "lengths", "token_hash",
             "byte_lengths", "has_vowel", "hash_powers", "morph_table",
             "morph_size", "word_table", "word_size", "coh_samples",
             "curvature", "threshold", "max_pair_count", "corpus_tokens")
    S1.reset_launches()
    with pytest.raises(ValueError, match=message):
        S1.score(*(inp[n] for n in names), use_frequency=True,
                 use_compression=True, use_hierarchical=True,
                 weights=E.EnhancedConfig().weights(), min_pair_freq=1,
                 max_token_len=0)
    assert S1.launches == 0


def test_score_launches_counted_only_while_tracing():
    S1.reset_launches()
    metrics.tracing()
    S1._launched(0)
    assert S1.launches == 1
    with torch.profiler.profile():
        S1._launched(0)
        S1._launched(0)
    assert S1.launches == 3
    assert metrics.trace_snapshot()["counters"] == {
        "sync.score_launches": 2}
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        S1._launched(700)
    assert S1.launches == 3


def test_table_inputs(inputs):
    keys = inputs["keys"]
    real = keys[:, 0] != scoring.PKEY_SENT
    n = int(real.sum())
    assert n == SMALL["n_pairs"] and bool(real[:n].all())
    k64 = scoring._key64(keys[:n, 0], keys[:n, 1])
    assert bool((k64[1:] > k64[:-1]).all())
    assert bool((keys[:n, 0] == keys[:n, 1]).any())      # self pairs
    s = inputs["coh_samples"]
    assert bool(torch.isin(s, keys[:n]).any())          # samples on rows
    for name in ("morph", "word"):
        tab, size = inputs[f"{name}_table"], int(inputs[f"{name}_size"])
        assert size < tab.shape[0]
        assert bool((tab[size:] == scoring.HKEY_SENT).all())
        assert bool((tab[1:size] > tab[:size - 1]).all())
    again = selfcheck.score_table_inputs("cpu", **SMALL)
    assert all(torch.equal(inputs[k], again[k]) for k in inputs)


FAULTS = {
    "other samples": lambda inp, cfg: (
        dict(inp, coh_samples=(inp["coh_samples"] + 1) % SMALL["n_vocab"]),
        cfg),
    "threshold 1% off": lambda inp, cfg: (
        dict(inp, threshold=inp["threshold"] * 1.01), cfg),
    "coherence weight": lambda inp, cfg: (
        inp, dataclasses.replace(cfg, gamma=cfg.gamma + 0.01)),
    "one more token": lambda inp, cfg: (
        dict(inp, corpus_tokens=inp["corpus_tokens"] // 2), cfg),
    "curvature": lambda inp, cfg: (
        dict(inp, curvature=inp["curvature"] * 1.001), cfg),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_tolerance_refuses_faults(inputs, fault):
    cfg = E.EnhancedConfig(**CONFIGS["all_features"])
    want = E.score_candidates_plain(cfg, **inputs)
    tol = selfcheck.score_tolerance(cfg, inputs)
    same = selfcheck.compare_scores(want, want, tol, inputs["curvature"])
    assert same["masks_equal"] and same["score_gap_over_tol"] == 0.0
    inp, bad_cfg = FAULTS[fault](inputs, cfg)
    got = E.score_candidates_plain(bad_cfg, **inp)
    cmp = selfcheck.compare_scores(got, want, tol, inputs["curvature"])
    assert max(cmp["score_gap_over_tol"], cmp["dist_gap_over_tol"]) > 1.0


def test_tolerance_refuses_a_changed_mask(inputs):
    cfg = E.EnhancedConfig(**CONFIGS["gated"])
    want = E.score_candidates_plain(cfg, **inputs)
    tol = selfcheck.score_tolerance(cfg, inputs)
    bad = dataclasses.replace(cfg, min_pair_freq=3)
    got = E.score_candidates_plain(bad, **inputs)
    assert not selfcheck.compare_scores(got, want, tol,
                                        inputs["curvature"])["masks_equal"]


def test_compare_queues_allows_near_ties_only(inputs):
    cfg = E.EnhancedConfig(**CONFIGS["flagship"])
    scores, _ = E.score_candidates_plain(cfg, **inputs)
    _, tol = selfcheck.score_tolerance(cfg, inputs)
    vals, pos = scoring.top_k_desc(scores, 64)
    keys = inputs["keys"]
    q = (keys[pos, 0], keys[pos, 1], vals)
    assert selfcheck.compare_queues(q, q, keys, tol) == {
        "ok": True, "differ": 0, "gap_over_tol": 0.0}
    # Entries 3 and 4 swapped with their scores: allowed only when the
    # gap of their scores lies within the two rows' tolerances.
    swap = torch.arange(64)
    swap[3], swap[4] = 4, 3
    q_sw = (q[0][:, swap], q[1][:, swap], vals[:, swap])
    gap = float(vals[0, 3] - vals[0, 4])
    allow = float(tol[pos[0, 3]] + tol[pos[0, 4]])
    cmp = selfcheck.compare_queues(q_sw, q, keys, tol)
    assert cmp["differ"] == 2
    assert cmp["ok"] == (gap <= allow)
    # A near-tie: the plain side ranks A just above B, the other side B
    # just above A, both within the rows' tolerances.
    want = vals.clone()
    want[0, 3] = vals[0, 4] + allow / 4
    got = vals.clone()
    got[0, 3] = vals[0, 4] + allow / 2
    got[0, 4] = vals[0, 4] + allow / 4
    cmp = selfcheck.compare_queues((q_sw[0], q_sw[1], got),
                                   (q[0], q[1], want), keys, tol)
    assert cmp["ok"] and cmp["differ"] == 2
    far = vals.clone()
    far[0, 3] += 1e-2
    assert not selfcheck.compare_queues(q_sw[:2] + (far,), q, keys,
                                        tol)["ok"]


def test_selfcheck_entry_on_the_cpu():
    out = {}
    selfcheck._check_sync_score(out, device="cpu")
    assert out["sync_score_selfcheck"] == "pass"
    assert out["sync_score_selfcheck_rows"] == \
        selfcheck.SCORE_TABLE_SMALL["table_size"]
    assert out["sync_score_selfcheck_score_gap"] == 0.0
    assert ("sync_score_selfcheck", "_check_sync_score") in \
        selfcheck.SELFCHECKS


def test_nan_free_and_finite_where_valid(inputs):
    cfg = E.EnhancedConfig(**CONFIGS["all_features"])
    scores, dists = E.score_candidates(cfg, **inputs)
    real = inputs["keys"][:, 0] != scoring.PKEY_SENT
    assert not bool(torch.isnan(scores).any() or torch.isnan(dists).any())
    assert bool(torch.isfinite(dists[real]).all())
    assert bool(torch.isinf(dists[~real]).all())
    assert bool((scores[:, ~real] == -np.inf).all())
