"""Port scoring primitives (hyptokenizer_tpu_torch/tokenizer/scoring.py) ==
the JAX package's, EXACTLY: hashes, key packing, corpus replay in both
policies, the pair table, top-k with ties, lookups."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.tokenizer import scoring as JS
from hyptokenizer_tpu_torch.tokenizer import scoring as TS

SEP = int(JS.SEP_ID)
PAD = int(JS.PAD_ID)


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_constants():
    for name in ("PAD_ID", "SEP_ID", "HASH_P1", "HASH_P2", "HASH_B1",
                 "HASH_B2", "MAX_HASH_LEN", "HKEY_SENT", "PKEY_SENT",
                 "PACK_MAX_ID"):
        assert int(getattr(TS, name)) == int(getattr(JS, name)), name


def test_hash_powers_and_strings():
    eq(TS.hash_powers(device="cpu"), JS.hash_powers())
    for s in ["", "a", "the", " the", "é", "naïve café", "x" * 300]:
        assert TS.hash_string(s) == JS.hash_string(s)


def test_compose_and_pack_hash():
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 32749, (500, 2)).astype(np.int32)
    hj = rng.integers(0, 32719, (500, 2)).astype(np.int32)
    bl = rng.integers(0, 5000, (500,)).astype(np.int32)  # past the cap too
    tp = TS.hash_powers(device="cpu")
    got = TS.compose_hash(torch.from_numpy(hi), torch.from_numpy(hj),
                          torch.from_numpy(bl), tp)
    want = JS.compose_hash(jnp.asarray(hi), jnp.asarray(hj), jnp.asarray(bl),
                           JS.hash_powers())
    eq(got, want)
    eq(TS.pack_hash(got[:, 0], got[:, 1]), JS.pack_hash(want[:, 0],
                                                         want[:, 1]))
    # The composition is the hash of the concatenated string.
    a, b = "hyper", "bolic"
    ha = torch.tensor([TS.hash_string(a)], dtype=torch.int32)
    hb = torch.tensor([TS.hash_string(b)], dtype=torch.int32)
    ab = TS.compose_hash(ha, hb, torch.tensor([len(b)], dtype=torch.int32),
                         tp)
    assert tuple(ab[0].tolist()) == TS.hash_string(a + b)


def test_pack_lex_order_and_roundtrip():
    rng = np.random.default_rng(1)
    hi = rng.integers(0, 65535, 2000).astype(np.int32)
    lo = rng.integers(0, 65535, 2000).astype(np.int32)
    hi[:5] = TS.PKEY_SENT
    lo[:5] = TS.PKEY_SENT
    k = TS.pack_lex(torch.from_numpy(hi), torch.from_numpy(lo))
    eq(k, JS.pack_lex(jnp.asarray(hi), jnp.asarray(lo)))
    h2, l2 = TS.unpack_lex(k)
    eq(h2, hi)
    eq(l2, lo)
    order = np.lexsort((lo[5:], hi[5:]))
    assert np.all(np.diff(k.numpy()[5:][order].astype(np.int64)) >= 0)


def make_corpus(seed, n_init=7, n=600):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_init, n - 40).astype(np.int32)
    ids[rng.random(ids.shape[0]) < 0.08] = SEP
    return np.concatenate([ids, np.full((40,), PAD, np.int32)])


def rules_by_simulation(corpus, n_init, n_rules, seed, chain=True):
    """Merge rules picked from adjacent pairs of a rank-replayed corpus (so
    later rules reuse tokens made by earlier ones), plus one rule that never
    matches."""
    rng = np.random.default_rng(seed)
    toks = [t for t in corpus.tolist() if t != PAD]
    rules = []
    for k in range(n_rules):
        pairs = [(a, b) for a, b in zip(toks, toks[1:]) if a >= 0 and b >= 0
                 and (chain or (a < n_init and b < n_init))]
        if not pairs:
            break
        a, b = pairs[rng.integers(len(pairs))]
        rules.append((a, b))
        new, out, i = n_init + k, [], 0
        while i < len(toks):
            if i + 1 < len(toks) and toks[i] == a and toks[i + 1] == b:
                out.append(new)
                i += 2
            else:
                out.append(toks[i])
                i += 1
        toks = out
    rules.append((n_init - 1, n_init - 1 + 1000))  # never matches
    merges = np.full((256, 2), -1, np.int32)
    merges[:len(rules)] = np.asarray(rules, np.int32)
    return merges, len(rules)


@pytest.mark.parametrize("policy", ["rank", "fixpoint"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_matches_jax(policy, seed):
    n_init = 7
    corpus = make_corpus(seed, n_init)
    merges, n_rules = rules_by_simulation(corpus, n_init, 40, seed)
    jf = JS.batch_rank_replay if policy == "rank" else JS.batch_fixpoint_replay
    tf = TS.batch_rank_replay if policy == "rank" else TS.batch_fixpoint_replay
    jc = jnp.asarray(corpus)
    tc = torch.from_numpy(corpus)
    tm = torch.from_numpy(merges)
    # Two windows, as two chunk syncs replay them: the second window's
    # rules chain onto tokens made by the first and by itself.
    for start, count in [(0, 17), (17, n_rules - 17)]:
        jc = jf(jc, jnp.asarray(merges), start, count, n_init)
        tc = tf(tc, tm, start, count, n_init)
        eq(tc, jc)
    assert int((tc >= n_init).sum()) > 0  # the rules did apply


def test_replay_no_chain_single_pass():
    corpus = make_corpus(5)
    merges, n_rules = rules_by_simulation(corpus, 7, 12, 5, chain=False)
    eq(TS.batch_rank_replay(torch.from_numpy(corpus), torch.from_numpy(merges),
                            0, n_rules, 7),
       JS.batch_rank_replay(jnp.asarray(corpus), jnp.asarray(merges), 0,
                            n_rules, 7))


@pytest.mark.parametrize("table_size", [8, 64, 1024])
def test_build_pair_table(table_size):
    """Exact keys, counts, unclipped unique count and max, with and without
    overflow of the table."""
    corpus = make_corpus(3, n_init=9)
    t = TS.build_pair_table(torch.from_numpy(corpus), table_size)
    j = JS.build_pair_table(jnp.asarray(corpus), table_size, max_id=256)
    for a, b in zip(t, j):
        eq(a, b)
    assert int(t[2]) > 8  # the smallest table overflows


def test_top_k_desc_ties():
    """Values from a small set (many ties, -inf included), k above and
    below the row length: values AND indices equal."""
    rng = np.random.default_rng(7)
    vals = rng.choice(np.array([-np.inf, 0.0, 0.25, 0.5, 1.0, 3.0],
                               np.float32), size=(3, 300))
    for k in (1, 17, 128, 300, 400):
        tv, ti = TS.top_k_desc(torch.from_numpy(vals), k)
        jv, ji = JS.top_k_desc(jnp.asarray(vals), k)
        eq(tv, jv)
        eq(ti, ji)


def test_top_k_desc_distinct_scores():
    rng = np.random.default_rng(8)
    vals = rng.standard_normal((1, 5000)).astype(np.float32)
    tv, ti = TS.top_k_desc(torch.from_numpy(vals), 256)
    jv, ji = JS.top_k_desc(jnp.asarray(vals), 256)
    eq(tv, jv)
    eq(ti, ji)


def test_lookup_and_membership():
    corpus = make_corpus(4)
    keys, counts, _, _ = TS.build_pair_table(torch.from_numpy(corpus), 64)
    jkeys, jcounts, _, _ = JS.build_pair_table(jnp.asarray(corpus), 64)
    rng = np.random.default_rng(2)
    qh = rng.integers(0, 8, 300).astype(np.int32)
    ql = rng.integers(0, 8, 300).astype(np.int32)
    eq(TS.lookup_pair_counts(torch.from_numpy(qh), torch.from_numpy(ql),
                             keys, counts),
       JS.lookup_pair_counts(jnp.asarray(qh), jnp.asarray(ql), jkeys,
                             jcounts))
    n = int((keys[:, 0] != TS.PKEY_SENT).sum())
    eq(TS.in_sorted_pair_set(torch.from_numpy(qh), torch.from_numpy(ql),
                             keys[:, 0], keys[:, 1], n),
       JS.in_sorted_pair_set(jnp.asarray(qh), jnp.asarray(ql), jkeys[:, 0],
                             jkeys[:, 1], n))
    table = np.sort(rng.choice(10_000, 200, replace=False)).astype(np.int32)
    table = np.concatenate([table, np.full((56,), TS.HKEY_SENT, np.int32)])
    q = rng.integers(0, 10_000, 5000).astype(np.int32)
    eq(TS.in_sorted_set(torch.from_numpy(q), torch.from_numpy(table), 200),
       JS.in_sorted_set(jnp.asarray(q), jnp.asarray(table), 200))


def test_compact_and_count():
    corpus = np.array([3, PAD, 4, SEP, PAD, PAD, 5, 6, PAD], np.int32)
    eq(TS.compact_corpus(torch.from_numpy(corpus)),
       JS.compact_corpus(jnp.asarray(corpus)))
    assert int(TS.corpus_token_count(torch.from_numpy(corpus))) == int(
        JS.corpus_token_count(jnp.asarray(corpus)))


# The replay's selection, held to sequential oracles: the recurrence that
# the card's kernel (ops/cuda/csrc/replay_select.cu) implements, and the
# rank-order greedy matching that its rounds add up to.

SELECT_LENGTHS = [0, 1, 2, 33, 4097]
SELECT_DENSITIES = [0.0, 0.1, 0.5, 0.9, 1.0]


def select_mask(n, density, seed):
    return np.random.default_rng(seed).random(n) < density


def take_oracle(cand):
    take, prev = [], False
    for c in cand:
        prev = bool(c) and not prev
        take.append(prev)
    return np.array(take, bool)


def round_oracle(alive, pri):
    """One matching round, entry by entry."""
    n = len(alive)
    big = 2**31 - 1
    p = [int(pri[i]) if alive[i] else big for i in range(n)]
    cand = [bool(alive[i]) and p[i] <= (p[i - 1] if i else big)
            and p[i] <= (p[i + 1] if i + 1 < n else big) for i in range(n)]
    take = take_oracle(cand)
    near = [take[i] or (i > 0 and take[i - 1]) or (i + 1 < n and take[i + 1])
            for i in range(n)]
    return take, np.array([bool(alive[i]) and not near[i] for i in range(n)],
                          bool)


def greedy_matching(m, pri):
    """Matches taken in (rank, position) order, each unless a neighbour
    was taken before it: each rule applied fully, left to right, in rank
    order. The rounds equal it where neighbouring matches differ in rank.
    Equal neighbouring ranks are one rule (x, x) over a run of x, and
    there the rounds, like the JAX package's, may start the run's parity
    late: on "a b a a a" with ranks (a, b) < (b, a) < (a, a), round one
    takes (a, b) and the last (a, a), where rank order takes the first."""
    n = len(m)
    sel = np.zeros(n, bool)
    for i in sorted(np.flatnonzero(m), key=lambda i: (int(pri[i]), i)):
        if not (i > 0 and sel[i - 1]) and not (i + 1 < n and sel[i + 1]):
            sel[i] = True
    return sel


@pytest.mark.parametrize("density", SELECT_DENSITIES)
@pytest.mark.parametrize("n", SELECT_LENGTHS)
def test_parity_take_matches_recurrence(n, density):
    m = select_mask(n, density, seed=n)
    got = TS._parity_take(torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), take_oracle(m))


@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("density", SELECT_DENSITIES)
@pytest.mark.parametrize("n", SELECT_LENGTHS)
def test_matching_rounds_match_oracles(n, density, runs):
    rng = np.random.default_rng(1000 + n)
    # The pairs of n + 1 tokens from 4 symbols, a share ``density`` of the
    # 16 pairs being rules of distinct ranks, as the replay sees a window's
    # matches. ``runs`` keeps runs of one token ("aaaa", neighbours of
    # equal rank), held to the rounds' oracle alone; without them the
    # rounds add up to the rank-order greedy matching too.
    if runs:
        toks = rng.integers(0, 4, n + 1)
    else:
        toks = np.cumsum(rng.integers(1, 4, n + 1)) % 4
    rank = rng.permutation(16).reshape(4, 4)
    is_rule = rng.random((4, 4)) < density
    m = is_rule[toks[:-1], toks[1:]]
    pri = np.where(m, rank[toks[:-1], toks[1:]], -1).astype(np.int32)
    tp = torch.from_numpy(pri)
    alive = torch.from_numpy(m)
    sel = torch.zeros_like(alive)
    want_sel = np.zeros(n, bool)
    while bool(alive.any()):
        take, want_alive = round_oracle(alive.numpy(), pri)
        want_sel |= take
        alive, live = TS.matching_round_plain(alive, tp, sel)
        np.testing.assert_array_equal(sel.numpy(), want_sel)
        np.testing.assert_array_equal(alive.numpy(), want_alive)
        assert bool(live) == bool(want_alive.any())
    if not runs:
        np.testing.assert_array_equal(want_sel, greedy_matching(m, pri))
    np.testing.assert_array_equal(
        TS._select_matching(torch.from_numpy(m), tp).numpy(), want_sel)
