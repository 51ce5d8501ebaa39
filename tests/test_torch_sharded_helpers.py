"""The port's helpers of the sharded syncs == the JAX package's: the hash
partition (``pair_dest``, on keys whose mixing product overflows int32),
the hashed pair-table lookup (also against the lexicographic lookup on
the same pairs, for D in {2, 4, 8}), the table combine, the pair search,
the single-rule replay, the rule match, the scans, the tie-broken top-k,
the raw scoring formula, and the plain scored step (K2's plain version)
reading a hash-partitioned table.

Tolerances: integers exact; scores 1e-5 (float32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.tokenizer import enhanced_state as JE
from hyptokenizer_tpu.tokenizer import scoring as JS
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as TE
from hyptokenizer_tpu_torch.tokenizer import scoring as TS
from tests.test_torch_enhanced_state import assert_states_match
from tests.torch_port_common import (  # noqa: F401
    ReplaySampler, history, make_pair, one_torch_thread)


def eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def test_pair_dest_matches_jax_on_overflowing_keys():
    rng = np.random.default_rng(0)
    pk = rng.integers(-2**31, 2**31 - 1, 4000, dtype=np.int64)
    pk[:6] = [-2**31, -1, 0, 1, 2**31 - 2, 2**31 - 1]
    pk = pk.astype(np.int32)
    # The mix's product leaves int32 for nearly every key.
    mixed = (pk.astype(np.int64) ^ (pk.astype(np.int64) >> 15)) * -1640531527
    assert np.mean((mixed < -2**31) | (mixed >= 2**31)) > 0.9
    for n in (1, 2, 3, 4, 8):
        got = TS.pair_dest(torch.from_numpy(pk), n)
        assert got.dtype == torch.int32
        eq(got, JS.pair_dest(jnp.asarray(pk), n))


def hashed_layout(keys, counts, d):
    """A lex table's pairs in the v3 layout for ``d`` owners (each owner's
    slice sorted by packed key, at most T/d rows), with the port's
    ``pair_dest``; returns (keys, counts, {pair: count} kept)."""
    t = keys.shape[0]
    td = t // d
    pk = TS.pack_lex(torch.from_numpy(keys[:, 0]),
                     torch.from_numpy(keys[:, 1]))
    dest = TS.pair_dest(pk, d).numpy()
    out_k = np.full((t, 2), TS.PKEY_SENT, np.int32)
    out_c = np.zeros((t,), np.int32)
    fill = np.zeros(d, np.int64)
    kept = {}
    for r in np.argsort(pk.numpy(), kind="stable"):
        if keys[r, 0] == TS.PKEY_SENT or fill[dest[r]] >= td:
            continue
        at = dest[r] * td + fill[dest[r]]
        out_k[at] = keys[r]
        out_c[at] = counts[r]
        fill[dest[r]] += 1
        kept[(int(keys[r, 0]), int(keys[r, 1]))] = int(counts[r])
    return out_k, out_c, kept


@pytest.mark.parametrize("d", [2, 4, 8])
def test_lookup_hashed_matches_jax_and_lex(d):
    rng = np.random.default_rng(d)
    t = 32 * d
    pairs = sorted({(int(a), int(b)) for a, b in zip(
        rng.integers(0, 60, 150), rng.integers(0, 60, 150))})[:t]
    keys = np.full((t, 2), TS.PKEY_SENT, np.int32)
    counts = np.zeros((t,), np.int32)
    keys[:len(pairs)] = pairs
    counts[:len(pairs)] = rng.integers(1, 99, len(pairs))
    hk, hc, kept = hashed_layout(keys, counts, d)
    q = np.asarray([[a, b] for a in range(0, 64, 3)
                    for b in range(0, 64, 5)] + list(pairs), np.int32)
    got = TS.lookup_pair_counts_hashed(
        torch.from_numpy(q[:, 0]), torch.from_numpy(q[:, 1]),
        torch.from_numpy(hk), torch.from_numpy(hc), d)
    eq(got, JS.lookup_pair_counts_hashed(
        jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]), jnp.asarray(hk),
        jnp.asarray(hc), d))
    eq(got, [kept.get((int(a), int(b)), 0) for a, b in q])
    # The lexicographic lookup on the same (kept) pairs reads the same.
    lk = np.full((t, 2), TS.PKEY_SENT, np.int32)
    lc = np.zeros((t,), np.int32)
    for r, (pair, c) in enumerate(sorted(kept.items())):
        lk[r] = pair
        lc[r] = c
    eq(got, TS.lookup_pair_counts(torch.from_numpy(q[:, 0]),
                                  torch.from_numpy(q[:, 1]),
                                  torch.from_numpy(lk), torch.from_numpy(lc)))


def _corpus(n, v, rng):
    c = rng.integers(0, v, n).astype(np.int32)
    c[rng.random(n) < 0.1] = TS.SEP_ID
    c[-n // 8:] = TS.PAD_ID
    return c


@pytest.mark.parametrize("table_size", [512, 24])   # fits; overflows
def test_merge_pair_tables_matches_jax(table_size):
    rng = np.random.default_rng(3)
    shards = [_corpus(300, 12, rng) for _ in range(4)]
    tk, tc, tn = [], [], []
    for c in shards:
        k, cnt, nu, _ = TS.build_pair_table(torch.from_numpy(c), table_size)
        tk.append(k)
        tc.append(cnt)
        tn.append(nu)
    got = TS.merge_pair_tables(torch.cat(tk), torch.cat(tc),
                               torch.stack(tn), table_size)
    want = JS.merge_pair_tables(
        jnp.asarray(torch.cat(tk).numpy()), jnp.asarray(torch.cat(tc).numpy()),
        jnp.asarray(torch.stack(tn).numpy()), table_size, max_id=64)
    for g, w in zip(got, want):
        eq(g, w)
    if table_size == 512:   # no shard overflowed: the whole corpus's table
        whole = TS.build_pair_table(torch.from_numpy(np.concatenate(shards)),
                                    table_size)
        for g, w in zip(got[:2], whole[:2]):
            eq(g, w)


def test_searchsorted_pairs_matches_jax():
    rng = np.random.default_rng(4)
    k, _, _, _ = TS.build_pair_table(torch.from_numpy(_corpus(400, 9, rng)),
                                     128)
    q = rng.integers(0, 10, (200, 2)).astype(np.int32)
    got = TS.searchsorted_pairs(k[:, 0], k[:, 1], torch.from_numpy(q[:, 0]),
                                torch.from_numpy(q[:, 1]))
    eq(got, JS.searchsorted_pairs(jnp.asarray(k[:, 0].numpy()),
                                  jnp.asarray(k[:, 1].numpy()),
                                  jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1])))


def test_apply_and_replay_merges_match_jax():
    rng = np.random.default_rng(5)
    c = _corpus(600, 5, rng)
    c[:6] = [1, 2, 1, 2, 1, 2]          # a run of matches
    eq(TS.apply_merge_to_corpus(torch.from_numpy(c), 1, 2, 40),
       JS.apply_merge_to_corpus(jnp.asarray(c), 1, 2, 40))
    pairs = np.asarray([[1, 2], [40, 3], [0, 0], [41, 1], [4, 2]], np.int32)
    got = TS.replay_merges_on_corpus(torch.from_numpy(c),
                                     torch.from_numpy(pairs), 40, 5)
    eq(got, JS.replay_merges_on_corpus(jnp.asarray(c), jnp.asarray(pairs),
                                       40, 5))
    assert int((got >= 40).sum()) > 0


def test_match_rules_matches_jax():
    rng = np.random.default_rng(6)
    merges = np.full((64, 2), -1, np.int32)
    pick = rng.permutation(400)[:30]          # 30 distinct pairs
    merges[:30] = np.stack([pick // 20, pick % 20], axis=1)
    c = _corpus(500, 20, rng)
    hi, lo, valid = TS._adjacent_pair_keys(torch.from_numpy(c))
    for start, count in ((0, 30), (5, 10), (29, 1)):
        got = TS.match_rules(hi, lo, torch.from_numpy(merges), start, count,
                             20)
        want = np.asarray(JS.match_rules(
            jnp.asarray(hi.numpy()), jnp.asarray(lo.numpy()),
            jnp.asarray(merges), start, count, 20))
        # Pair keys of real adjacencies; the JAX tiles leave sentinel keys
        # (PAD/SEP) undefined, and its callers never read them.
        eq(got[valid], want[valid.numpy()])
        assert bool(torch.all(got[~valid] == -1))
        if start == 0:
            assert int((got >= 20).sum()) > 0


@pytest.mark.parametrize("n", [100, 20_000])   # JAX: one level; two levels
def test_blocked_scans_match_jax(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-50, 50, n).astype(np.int32)
    for name in ("blocked_cumsum", "blocked_cummax",
                 "blocked_cummin_reverse"):
        got = getattr(TS, name)(torch.from_numpy(x))
        assert got.dtype == torch.int32
        eq(got, getattr(JS, name)(jnp.asarray(x)))
    x2 = rng.integers(0, 3, (3, n)).astype(np.int32)
    eq(TS.blocked_cumsum_rows(torch.from_numpy(x2)),
       JS.blocked_cumsum_rows(jnp.asarray(x2)))


def test_top_k_tiebreak_matches_jax():
    rng = np.random.default_rng(7)
    vals = rng.choice([0.5, 0.25, -np.inf, 0.75], (3, 300)).astype(np.float32)
    tb = np.stack([rng.permutation(300) for _ in range(3)]).astype(np.int32)
    tb[:, :5] = TS.PKEY_SENT    # duplicated sentinels with -inf scores
    vals[:, :5] = -np.inf
    for k in (16, 290, 400):
        gv, gi = TS.top_k_desc(torch.from_numpy(vals), k,
                               tiebreak=torch.from_numpy(tb))
        wv, wi = JS.top_k_desc(jnp.asarray(vals), k, tiebreak=jnp.asarray(tb))
        eq(gv, wv)
        real = np.isfinite(np.asarray(wv))
        eq(gi.numpy()[real], np.asarray(wi)[real])


def synced_pair(**overrides):
    jt, tt = make_pair(**overrides)
    jst = JE.sync_corpus(jt.enh_state, jt.enh_config)
    tst = TE.sync_corpus(tt.enh_state, tt.enh_config,
                         ReplaySampler(jt.enh_state.key))
    return jt, tt, jst, tst


def test_full_scores_raw_matches_jax():
    """The one formula both syncs score with, on explicit arrays: every
    feature on, candidate pairs, counts and samples drawn with numpy."""
    jt, tt = make_pair(use_hierarchical=True, use_compression_aware=True)
    tst, jst = tt.enh_state, jt.enh_state
    rng = np.random.default_rng(8)
    v = int(tst.base.vocab_size)
    n = 300
    rows = torch.from_numpy(rng.integers(0, v, n))
    cols = torch.from_numpy(rng.integers(0, v, n))
    dists = torch.from_numpy(rng.random(n).astype(np.float32) * 3)
    freqs = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))
    samples = torch.from_numpy(rng.integers(0, v, 50).astype(np.int32))
    max_count = torch.tensor(57, dtype=torch.int32)
    tokens = torch.tensor(900, dtype=torch.int32)
    b = tst.base
    got = TE._full_scores_raw(
        tt.enh_config, b.emb, b.lengths, b.threshold, b.curvature,
        samples, max_count, tokens,
        tst.token_hash, tst.byte_lengths, tst.has_vowel, tst.hash_powers,
        tst.morph_table, tst.morph_size, tst.word_table, tst.word_size,
        rows, cols, dists, freqs)
    jb = jst.base

    def j(x):
        return jnp.asarray(x.numpy())

    want = jax.jit(JE._full_scores_raw, static_argnums=0)(
        jt.enh_config, jb.emb, jb.lengths, jb.threshold, jb.curvature,
        j(samples), j(max_count), j(tokens),
        jst.token_hash, jst.byte_lengths, jst.has_vowel, jst.hash_powers,
        jst.morph_table, jst.morph_size, jst.word_table, jst.word_size,
        j(rows), j(cols), j(dists), j(freqs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert got.shape == (n, 3)


def test_coherence_blocks_keep_each_rows_bits():
    """A candidate's score has the same bits alone in a block and among
    others (the single-device and the sharded syncs score different row
    counts)."""
    from tests.torch_port_common import SMALL, small_vocab_and_emb
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    vocab, emb = small_vocab_and_emb()
    tst = EnhancedHyperbolicTokenizer(vocab, emb, device="cpu",
                                      **SMALL).enh_state
    tst.coh_samples.copy_(torch.arange(tst.coh_samples.shape[0]) % 20)
    b = tst.base
    n = TE.COHERENCE_BLOCK + 37
    g = torch.Generator().manual_seed(1)
    rows = torch.randint(0, int(b.vocab_size), (n,), generator=g)
    cols = torch.randint(0, int(b.vocab_size), (n,), generator=g)
    full = TE._coherence(b.emb, rows, cols, b.lengths, b.curvature,
                         b.threshold, tst.coh_samples)
    part = TE._coherence(b.emb, rows[5:300], cols[5:300], b.lengths,
                         b.curvature, b.threshold, tst.coh_samples)
    eq(full[5:300], part)


def test_enhanced_step_hashed_matches_jax():
    """The plain scored steps (K2's plain version) with the dense channel
    reading a table laid out for 4 owners, looped as a segment (24 merges,
    both phase switches), against the JAX loop reading the same table; and
    the same merges as the lexicographic table holding the same pairs."""
    from hyptokenizer_tpu.parallel.sharded import _enhanced_loop_jit
    from tests.test_torch_dense import PHASES, ALL_FEATURES
    kw = dict(ALL_FEATURES, use_adaptive_curvature=False)
    jt, tt, jst, tst = synced_pair(**kw)
    jcfg = jt.enh_config.replace(**PHASES, pair_table_hashed=4)
    tcfg = dataclasses.replace(tt.enh_config, **PHASES)
    hk, hc, kept = hashed_layout(tst.pair_keys.numpy(),
                                 tst.pair_counts.numpy(), 4)
    assert len(kept) == int((tst.pair_counts > 0).sum())   # none dropped
    lex = TE.clone_state(tst)
    th = dataclasses.replace(TE.clone_state(tst),
                             pair_keys=torch.from_numpy(hk),
                             pair_counts=torch.from_numpy(hc))
    jh = _enhanced_loop_jit(jax.tree.map(jnp.array, jst.replace(
        pair_keys=jnp.asarray(hk), pair_counts=jnp.asarray(hc))), jcfg, 24)

    def segment(st, cfg):
        return TE.run_segment_plain(st, cfg, 24, 24 + 1024,
                                    TE.NO_CURVATURE_STOP, None, 24 + 1024)

    th = segment(th, dataclasses.replace(tcfg, pair_table_hashed=4))
    lex = segment(lex, tcfg)
    assert int(th.base.num_merges) == 24 and int(th.phase) == 3
    eq(history(th), history(lex))
    # The dense channel chains a token with its own midpoints, halving the
    # distance each time; below the acosh clamp floor every candidate ties
    # at 0 and either package may pick any (tests/test_torch_cli.py's
    # rule): the histories agree up to there.
    floor = np.flatnonzero(np.asarray(jh.base.merge_dists[:24]) <= 1e-3)
    k = int(floor[0]) if floor.size else 24
    assert k >= 8
    eq(history(th)[:k], history(jh)[:k])


@pytest.mark.parametrize("d", [2, 4])
def test_hash_partition_table_is_the_v3_layout(d):
    """``sharded.hash_partition_table`` (the layout the smoke and the card
    tests give K2) == the layout built pair by pair above."""
    from hyptokenizer_tpu_torch.parallel.sharded import hash_partition_table
    rng = np.random.default_rng(10 + d)
    c = _corpus(2000, 30, rng)
    keys, counts, _, _ = TS.build_pair_table(torch.from_numpy(c), 64 * d)
    hk, hc = hash_partition_table(keys, counts, d)
    wk, wc, kept = hashed_layout(keys.numpy(), counts.numpy(), d)
    eq(hk, wk)
    eq(hc, wc)
    assert len(kept) > 20
