"""Corpus and scoring primitives of the enhanced merge loop, in PyTorch.

Port of ``hyptokenizer_tpu/tokenizer/scoring.py`` (see its docstring for
the design: an int32 id corpus replayed at chunk boundaries, a sorted
pair-count table, token strings represented on the device by composable
rolling hashes). The JAX package builds its scans from blocked pieces and
its sorts from packed keys to keep XLA compile times down; here
``torch.sort``, ``torch.cumsum``, ``torch.unique_consecutive`` and
``torch.searchsorted`` give identical results (ties included). Not so the
replay: its run-parity take (a 1-D ``torch.cummax`` scans in one thread
block, milliseconds a call over a 2.9M-slot corpus) and its passes and
rounds, which the host would test by reading the device. On the card a
window's whole replay is the kernel ``ops/cuda/replay_pass.py`` (R2), one
launch with no host read; the pass loop :func:`_replay` is its plain
version, taken for CPU tensors, and runs the same on any device. The
single-rule replay's take (:func:`apply_merge_to_corpus`) is the kernel
``ops/cuda/replay_select.py`` (R1) on the card, whose plain versions are
:func:`parity_take_plain` and :func:`matching_round_plain`.

Every function keeps its inputs' device. Hashes and ids are int32, as in
the JAX package; pair keys are widened to int64 only inside a function.
"""

from __future__ import annotations

import numpy as np
import torch

from hyptokenizer_tpu_torch.ops.cuda import replay_pass, replay_select
from hyptokenizer_tpu_torch.utils import metrics

PAD_ID = -1   # corpus hole / tail
SEP_ID = -2   # line or segment separator: breaks adjacency, survives compaction

# Two 15-bit-prime rolling hashes packed into one int32 key (every modular
# product stays below 2^30; the packed key below 2^31 - 1).
HASH_P1 = 32749
HASH_P2 = 32719
HASH_B1 = 257
HASH_B2 = 263
MAX_HASH_LEN = 4096
HKEY_SENT = 2**31 - 1   # sorted hash-table pad

PKEY_SENT = 2**31 - 1   # pair-table sentinel, in both lanes
PACK_MAX_ID = 65535     # ids <= 65534 pack into one order-preserving int32
_I32_MIN = -2**31
_KEY_SENT64 = (PKEY_SENT << 32) | PKEY_SENT  # int64 image of a sentinel row


def hash_powers(max_len: int = MAX_HASH_LEN, device=None) -> torch.Tensor:
    """Power tables ``B^k mod p`` for both primes, shape (2, max_len) int32."""
    def powers(b, p):
        out = np.empty((max_len,), np.int32)
        acc = 1
        for k in range(max_len):
            out[k] = acc
            acc = (acc * b) % p
        return out

    return torch.from_numpy(np.stack([powers(HASH_B1, HASH_P1),
                                      powers(HASH_B2, HASH_P2)])).to(device)


def hash_string(s: str):
    """Host-side hash of a string (equals the device-side composition)."""
    h1 = 0
    h2 = 0
    for ch in s.encode("utf-8"):
        h1 = (h1 * HASH_B1 + ch) % HASH_P1
        h2 = (h2 * HASH_B2 + ch) % HASH_P2
    return h1, h2


def pack_hash(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Pack the two residues into one int32 lookup key (< 2^31 - 1)."""
    return (h1 * 65536 + h2).to(torch.int32)


def compose_hash(h_i: torch.Tensor, h_j: torch.Tensor,
                 byte_len_j: torch.Tensor, powers: torch.Tensor
                 ) -> torch.Tensor:
    """hash(a+b) from hash(a), hash(b) and len_bytes(b). Shapes (..., 2)."""
    idx = torch.clamp_max(byte_len_j, MAX_HASH_LEN - 1).long()
    c1 = (h_i[..., 0] * powers[0, idx] + h_j[..., 0]) % HASH_P1
    c2 = (h_i[..., 1] * powers[1, idx] + h_j[..., 1]) % HASH_P2
    return torch.stack([c1, c2], dim=-1).to(torch.int32)


def in_sorted_set(keys: torch.Tensor, table: torch.Tensor,
                  table_size) -> torch.Tensor:
    """Membership of int32 keys in a sorted int32 table (HKEY_SENT padded)."""
    pos = torch.searchsorted(table, keys.contiguous())
    pos = torch.clamp_max(pos, table.shape[0] - 1)
    return (table[pos] == keys) & (pos < table_size)


# ------------------------------------------------------------------ pair keys

def pack_lex(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int32 key whose int32 order is the lexicographic (hi, lo) order.

    ``hi*65536 + lo`` as an unsigned bit pattern with its sign bit flipped,
    which is ``u - 2^31``. Sentinel rows map to PKEY_SENT. Requires ids in
    [0, 65534] for real rows."""
    u = hi.long() * 65536 + lo.long()
    k = (u - 2**31).to(torch.int32)
    return torch.where(hi == PKEY_SENT, torch.full_like(k, PKEY_SENT), k)


def unpack_lex(k: torch.Tensor):
    """Inverse of :func:`pack_lex` (sentinel-preserving)."""
    u = k.long() + 2**31
    hi = (u >> 16).to(torch.int32)
    lo = (u & 0xFFFF).to(torch.int32)
    sent = k == PKEY_SENT
    fill = torch.full_like(hi, PKEY_SENT)
    return torch.where(sent, fill, hi), torch.where(sent, fill, lo)


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key with the lexicographic order of the (hi, lo) int32 lanes."""
    return (hi.long() << 32) | lo.long()


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` moved one place right (``x[i-1]`` at ``i``), ``fill`` at 0."""
    return torch.cat([torch.full_like(x[:1], fill), x[:-1]])


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` moved one place left (``x[i+1]`` at ``i``), ``fill`` at the end."""
    return torch.cat([x[1:], torch.full_like(x[:1], fill)])


def _adjacent_pair_keys(c: torch.Tensor):
    """(hi, lo, valid) for each adjacent corpus pair; sentinel where either
    side is PAD/SEP."""
    nxt = _shift_left(c, PAD_ID)
    valid = (c >= 0) & (nxt >= 0)
    sent = torch.full_like(c, PKEY_SENT)
    return torch.where(valid, c, sent), torch.where(valid, nxt, sent), valid


def lookup_pair_counts(q_hi: torch.Tensor, q_lo: torch.Tensor,
                       table_keys: torch.Tensor,
                       table_counts: torch.Tensor) -> torch.Tensor:
    """Counts for (hi, lo) pair keys in a sorted (T, 2) table (0 if absent)."""
    tk = _key64(table_keys[:, 0], table_keys[:, 1])
    q = _key64(q_hi.to(torch.int32), q_lo.to(torch.int32))
    pos = torch.clamp_max(torch.searchsorted(tk, q), tk.shape[0] - 1)
    return torch.where(tk[pos] == q, table_counts[pos],
                       torch.zeros_like(table_counts[pos]))


def in_sorted_pair_set(q_hi, q_lo, t_hi, t_lo, table_size) -> torch.Tensor:
    """Membership of (hi, lo) keys in a lex-sorted two-lane table whose first
    ``table_size`` rows are real."""
    in_tbl = torch.arange(t_hi.shape[0], device=t_hi.device) < table_size
    tk = torch.where(in_tbl, _key64(t_hi, t_lo),
                     torch.full_like(t_hi, _KEY_SENT64, dtype=torch.int64))
    q = _key64(q_hi.to(torch.int32), q_lo.to(torch.int32))
    pos = torch.clamp_max(torch.searchsorted(tk, q), tk.shape[0] - 1)
    return (tk[pos] == q) & (q != _KEY_SENT64)


# --------------------------------------------------------------- corpus ops

def compact_corpus(corpus: torch.Tensor) -> torch.Tensor:
    """Move non-PAD entries to the front, in order; PAD-fill the tail."""
    out = torch.full_like(corpus, PAD_ID)
    live = corpus[corpus != PAD_ID]
    out[:live.shape[0]] = live
    return out


def corpus_token_count(corpus: torch.Tensor) -> torch.Tensor:
    return torch.sum(corpus >= 0).to(torch.int32)


def _match_rules(hi, lo, valid, merges, start: int, count: int, n_init: int):
    """Merged-token id for each pair key under rules [start, start+count),
    or -1. A key matched by several rules takes the largest id, as the JAX
    package's max-reduction does (a pair is never merged twice, so it does
    not arise in training)."""
    rules = merges[start:start + count]
    rid = n_init + start + torch.arange(count, device=merges.device,
                                        dtype=torch.int32)
    ok = rules[:, 0] >= 0
    rk = _key64(rules[ok, 0], rules[ok, 1])
    rid = rid[ok]
    order = torch.argsort(rk, stable=True)
    rk = rk[order]
    rid = rid[order]
    if rk.shape[0] == 0:
        return torch.full_like(hi, -1)
    q = _key64(hi, lo)
    pos = torch.searchsorted(rk, q, right=True) - 1
    posc = torch.clamp_min(pos, 0)
    hit = valid & (pos >= 0) & (rk[posc] == q)
    return torch.where(hit, rid[posc], torch.full_like(hi, -1))


def parity_take_plain(m: torch.Tensor) -> torch.Tensor:
    """Within each run of consecutive True in ``m``, every other entry from
    the run head (greedy left-to-right non-overlapping application). The
    plain version of ``replay_select.parity_take``."""
    idx = torch.arange(m.shape[0], device=m.device, dtype=torch.int32)
    run_start = m & ~_shift_right(m, False)
    start_idx = torch.where(run_start, idx, torch.full_like(idx, -1))
    last_start = torch.cummax(start_idx, dim=0).values
    return m & (((idx - last_start) % 2) == 0)


def _parity_take(m: torch.Tensor) -> torch.Tensor:
    if m.device.type == "cpu":
        return parity_take_plain(m)
    return replay_select.parity_take(m)


def _replay(corpus, merges, start: int, count: int, n_init: int, select):
    """Passes of match -> select -> substitute -> compact, to fixpoint.

    One pass is complete unless some rule in the window has an operand made
    inside the window (a within-chunk chain), as in the JAX package. The
    plain version of kernel R2 (:func:`replay_window`)."""
    if count <= 0:
        return corpus
    window = merges[start:start + count]
    can_chain = bool(torch.any(window.max(dim=1).values >= n_init + start))
    c = corpus
    passes = 0
    while True:
        passes += 1
        hi, lo, valid = _adjacent_pair_keys(c)
        mid = _match_rules(hi, lo, valid, merges, start, count, n_init)
        m = mid >= 0
        applied = select(m, mid)
        out = torch.where(applied, mid, c)
        out = torch.where(_shift_right(applied, False),
                          torch.full_like(out, PAD_ID), out)
        c = compact_corpus(out)
        if not can_chain or not bool(torch.any(applied)):
            metrics.count("replay.passes", passes)
            return c


def replay_window(corpus: torch.Tensor, merges: torch.Tensor, start, end,
                  n_init: int, rank: bool) -> torch.Tensor:
    """Merges [start, end) replayed on a corpus on the card, in one launch
    of kernel R2 (``ops/cuda/replay_pass.py``): the rank replay
    (``rank``) or the fixpoint replay. ``start`` and ``end`` are ints or
    one-element int32 tensors on the card, read there. While a profiler
    records, the kernel's passes and matching rounds are read back and
    counted as the plain loop counts them; otherwise nothing is read."""
    out, stats = replay_pass.replay(corpus, merges, start, end, n_init,
                                    rank=rank)
    if metrics.tracing():
        passes, rounds = stats.tolist()
        if passes:
            metrics.count("replay.passes", passes)
            metrics.count("replay.match_rounds", rounds)
    return out


def batch_fixpoint_replay(corpus: torch.Tensor, merges: torch.Tensor,
                          start: int, count: int, n_init: int
                          ) -> torch.Tensor:
    """Apply merges [start, start+count) as one rule table to fixpoint, the
    leftmost match winning (the reference's ``tokenize()`` semantics)."""
    if corpus.device.type != "cpu" and count > 0:
        return replay_window(corpus, merges, start, start + count, n_init,
                             rank=False)
    return _replay(corpus, merges, start, count, n_init, _select_leftmost)


def _select_leftmost(m: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """Greedy left-to-right matching: one round."""
    metrics.count("replay.match_rounds")
    return parity_take_plain(m)


def matching_round_plain(alive: torch.Tensor, pri: torch.Tensor,
                         sel: torch.Tensor) -> tuple:
    """One round of :func:`_select_matching`: the alive local minima of
    ``pri`` (neighbours of equal rank by run parity from the left) join
    ``sel``, in place. Returns the entries still alive, neither taken nor
    beside a taken one, and whether any is (a 0-d tensor). The plain
    version of ``replay_select.matching_round``."""
    big = 2**31 - 1
    p = torch.where(alive, pri, torch.full_like(pri, big))
    cand = alive & (p <= _shift_right(p, big)) & (p <= _shift_left(p, big))
    take = parity_take_plain(cand)
    sel |= take
    near = take | _shift_right(take, False) | _shift_left(take, False)
    alive = alive & ~near
    return alive, torch.any(alive)


def _select_matching(m: torch.Tensor, pri: torch.Tensor) -> torch.Tensor:
    """Maximal matching by (rank, position): rounds of local minima."""
    alive = m
    sel = torch.zeros_like(m)
    rounds = 0
    live = torch.any(alive)
    while bool(live):
        rounds += 1
        alive, live = matching_round_plain(alive, pri, sel)
    metrics.count("replay.match_rounds", rounds)
    return sel


def batch_rank_replay(corpus: torch.Tensor, merges: torch.Tensor,
                      start: int, count: int, n_init: int) -> torch.Tensor:
    """Apply merges [start, start+count) in rank order (classic BPE), which
    equals the priority-mode encoder (``encode.tokenize_priority_py``)."""
    if corpus.device.type != "cpu" and count > 0:
        return replay_window(corpus, merges, start, start + count, n_init,
                             rank=True)
    return _replay(corpus, merges, start, count, n_init, _select_matching)


# ------------------------------------------------------- pair count snapshot

def build_pair_table(corpus: torch.Tensor, table_size: int):
    """Sorted (pair key, count) snapshot of adjacent-pair frequencies.

    Returns ``(keys (T, 2) int32, counts (T,) int32, n_unique, max_count)``
    with the lexicographically first ``table_size`` pairs; unused slots hold
    (PKEY_SENT, PKEY_SENT) and 0. ``n_unique`` counts every unique pair
    before the clip, so ``n_unique > table_size`` says pairs were dropped.
    """
    hi, lo, _ = _adjacent_pair_keys(corpus)
    sk = torch.sort(_key64(hi, lo)).values
    uniq, cnt = torch.unique_consecutive(sk, return_counts=True)
    real = uniq != _KEY_SENT64
    uniq = uniq[real]
    cnt = cnt[real]
    n_unique = uniq.shape[0]
    keep = min(n_unique, table_size)
    dev = corpus.device
    keys = torch.full((table_size, 2), PKEY_SENT, dtype=torch.int32,
                      device=dev)
    counts = torch.zeros((table_size,), dtype=torch.int32, device=dev)
    keys[:keep, 0] = (uniq[:keep] >> 32).to(torch.int32)
    keys[:keep, 1] = (uniq[:keep] & 0xFFFFFFFF).to(torch.int32)
    counts[:keep] = cnt[:keep].to(torch.int32)
    return (keys, counts,
            torch.tensor(n_unique, dtype=torch.int32, device=dev),
            counts.max())


def _f32_sortable(x: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> int32 map (int32 order == float order; -0.0 just
    below +0.0), as the JAX package's top-k ranks scores."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b >= 0, b, (~b) ^ _I32_MIN)


def top_k_desc(vals: torch.Tensor, k: int, tiebreak=None):
    """Exact per-row top-k of a (P, T) float32 array: (values, indices),
    values descending, ties to the lowest index; rows shorter than ``k`` are
    padded with -inf and index T-1.

    ``tiebreak``: an optional (P, T) int32, unique per row among the real
    entries: equal values then go to the smallest tiebreak (equal
    tiebreaks to the lowest index). The sharded syncs pass the packed pair
    key, which is the single-device table's position order, so that a
    partitioned selection keeps the single-device order."""
    p, t = vals.shape
    kk = min(k, t)
    # ~s reverses the order of the sortable image; a stable ascending sort
    # then keeps equal values in index (or tiebreak) order.
    key = ~_f32_sortable(vals)
    if tiebreak is not None:
        key = (key.long() << 32) | (tiebreak.long() + 2**31)
    order = torch.sort(key, dim=1, stable=True).indices
    idx = order[:, :kk]
    out = torch.gather(vals, 1, idx)
    if kk < k:
        out = torch.cat([out, torch.full((p, k - kk), -torch.inf,
                                         dtype=vals.dtype,
                                         device=vals.device)], dim=1)
        idx = torch.cat([idx, torch.full((p, k - kk), t - 1,
                                         dtype=idx.dtype,
                                         device=idx.device)], dim=1)
    return out, idx


# ------------------------------------------------- hash-partitioned tables

def pair_dest(pk: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Owner bucket of packed pair keys (a Fibonacci mix): the v3 sharded
    sync's key partition and the hashed table lookup, which must agree.

    The JAX package mixes in int32 and relies on its wraparound; here the
    product is taken in int64 and masked to its low 32 bits, which is the
    same bits without a signed overflow (``(h & 0x7FFFFFFF) % n``)."""
    k = pk.long()
    s = k >> 15                       # arithmetic, as the int32 shift
    h = ((k ^ s) * 2654435769) & 0xFFFFFFFF
    return ((h & 0x7FFFFFFF) % n_buckets).to(torch.int32)


def lookup_pair_counts_hashed(q_hi: torch.Tensor, q_lo: torch.Tensor,
                              table_keys: torch.Tensor,
                              table_counts: torch.Tensor,
                              n_buckets: int) -> torch.Tensor:
    """Counts for (hi, lo) pairs in a hash-partitioned table (0 if absent).

    The layout of the v3 sharded sync's table: ``n_buckets`` owner slices
    of T/n_buckets rows each, each sorted by packed key with PKEY_SENT
    padding. A query searches only its owner's slice (:func:`pair_dest`).
    Requires ids <= PACK_MAX_ID - 1 (the v3 gate enforces it)."""
    t = table_keys.shape[0]
    td = t // n_buckets
    pkt = pack_lex(table_keys[:, 0], table_keys[:, 1]).reshape(n_buckets,
                                                                td)
    q = pack_lex(q_hi.to(torch.int32), q_lo.to(torch.int32))
    dest = pair_dest(q, n_buckets).long()
    seg = pkt[dest]                                   # (n, td)
    pos = torch.searchsorted(seg, q.reshape(-1, 1)).reshape(-1)
    pos = torch.clamp_max(pos, td - 1)
    at = dest * td + pos
    hit = pkt.reshape(-1)[at] == q
    return torch.where(hit, table_counts[at], torch.zeros_like(
        table_counts[at]))


def searchsorted_pairs(t_hi: torch.Tensor, t_lo: torch.Tensor,
                       q_hi: torch.Tensor, q_lo: torch.Tensor
                       ) -> torch.Tensor:
    """Lexicographic ``searchsorted`` (side='left') of (hi, lo) queries in a
    lex-sorted two-lane table, as int32 positions."""
    return torch.searchsorted(_key64(t_hi, t_lo),
                              _key64(q_hi.to(torch.int32),
                                     q_lo.to(torch.int32))).to(torch.int32)


def merge_pair_tables(keys: torch.Tensor, counts: torch.Tensor,
                      n_uniques: torch.Tensor, table_size: int):
    """Combine per-shard pair tables into one sorted table.

    ``keys`` (S*T, 2) is the row-concatenation of S shard tables,
    ``counts`` (S*T,), ``n_uniques`` (S,) their unclipped unique counts.
    Returns :func:`build_pair_table`'s ``(keys, counts, n_unique,
    max_count)`` for the concatenated corpus: the lex-first
    ``table_size`` keys with their summed counts; ``n_unique`` is raised
    past ``table_size`` when any shard overflowed (see the JAX package's
    docstring for why the kept counts stay exact)."""
    k64 = _key64(keys[:, 0], keys[:, 1])
    sk, order = torch.sort(k64, stable=True)
    sc = counts[order].long()
    uniq, inv = torch.unique_consecutive(sk, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.int64,
                       device=keys.device).index_add_(0, inv, sc)
    real = uniq != _KEY_SENT64
    uniq = uniq[real]
    sums = sums[real]
    n_unique = uniq.shape[0]
    keep = min(n_unique, table_size)
    dev = keys.device
    out_k = torch.full((table_size, 2), PKEY_SENT, dtype=torch.int32,
                       device=dev)
    out_c = torch.zeros((table_size,), dtype=torch.int32, device=dev)
    out_k[:keep, 0] = (uniq[:keep] >> 32).to(torch.int32)
    out_k[:keep, 1] = (uniq[:keep] & 0xFFFFFFFF).to(torch.int32)
    out_c[:keep] = sums[:keep].to(torch.int32)
    nu = torch.tensor(n_unique, dtype=torch.int32, device=dev)
    if bool(torch.any(n_uniques > table_size)):
        nu = torch.clamp_min(nu, table_size + 1)
    return out_k, out_c, nu, out_c.max()


# ----------------------------------------------- single-rule replay, scans

def apply_merge_to_corpus(corpus: torch.Tensor, i, j, new_id
                          ) -> torch.Tensor:
    """Replace left-to-right non-overlapping adjacent (i, j) by ``new_id``
    (within a run of matches every other one, from the run head), leaving
    PAD at the consumed positions; :func:`compact_corpus` removes them."""
    nxt = _shift_left(corpus, PAD_ID)
    m = (corpus == i) & (nxt == j)
    applied = _parity_take(m)
    out = torch.where(applied, torch.as_tensor(new_id, dtype=corpus.dtype,
                                               device=corpus.device), corpus)
    return torch.where(_shift_right(applied, False),
                       torch.full_like(out, PAD_ID), out)


def replay_merges_on_corpus(corpus: torch.Tensor, pairs: torch.Tensor,
                            n_init: int, count: int) -> torch.Tensor:
    """Apply ``count`` merges one at a time (merge k makes id
    ``n_init + k``), compacting between them so that later merges see the
    pairs earlier ones made. O(count * N): the chunked replays above are
    the fast form."""
    c = corpus
    for k in range(int(count)):
        c = compact_corpus(apply_merge_to_corpus(
            c, pairs[k, 0], pairs[k, 1], int(n_init) + k))
    return c


def match_rules(key_hi: torch.Tensor, key_lo: torch.Tensor,
                merges: torch.Tensor, start: int, count: int,
                n_init: int) -> torch.Tensor:
    """Merged-token id for each (hi, lo) pair key under merges
    [start, start+count) (merge k makes id ``n_init + k``), or -1. The JAX
    package tiles a broadcast compare for the TPU; a sorted search gives
    the same ids."""
    valid = key_hi != PKEY_SENT
    return _match_rules(key_hi, key_lo, valid, merges, int(start),
                        int(count), n_init)


# The JAX package builds its scans from two-level blocks to keep XLA
# compile times down on the TPU; PyTorch's scans give the same int32
# results, and the names stay so that a reader finds the counterparts.
# They are not the same work: a 1-D ``torch.cummax`` runs in one thread
# block, and the replay, which the JAX package builds on
# ``blocked_cummax``, takes its run parity on the card inside the kernels
# ``ops/cuda/replay_pass.py`` and ``ops/cuda/replay_select.py`` instead.

def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum, in ``x``'s dtype."""
    return torch.cumsum(x, dim=0).to(x.dtype)


def blocked_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cummax."""
    return torch.cummax(x, dim=0).values


def blocked_cummin_reverse(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix cummin."""
    return torch.flip(torch.cummin(torch.flip(x, (0,)), dim=0).values, (0,))


def blocked_cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row inclusive cumsum of a (P, T) array, in ``x``'s dtype."""
    return torch.cumsum(x, dim=1).to(x.dtype)
