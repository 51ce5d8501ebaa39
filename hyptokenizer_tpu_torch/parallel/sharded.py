"""Sharded training: a sharded corpus sync and a replicated merge segment.

Port of ``hyptokenizer_tpu/parallel/sharded.py`` on ``torch.distributed``.
The JAX package shards the embeddings and every row array and lets XLA put
an argmin or all-gather collective into every merge step. A step of the
port's kernels costs a few microseconds (K1 4.7 µs, K4 5.3 µs on an
NVIDIA H100, PERF.md), less than one collective, so the port places the
state otherwise (``parallel/mesh.py``):

- sharded: the corpus (each rank replays and counts pairs on its N/D
  slice, aligned by ``utils/data.shard_align_corpus``), the pair-table
  build and combine, and in v3 and v3f the scoring and the top-K over the
  keys each rank owns;
- replicated: the embeddings, the row arrays, the merge table, the
  scalars, the queues after their K-sized merge, and the merge segment:
  every rank runs K1/K2 (or K4) on the same inputs and gets the same
  outputs.

Merge histories are those of one device, bit for bit: the syncs score with
the single-device scoring (``enhanced_state.score_candidates``: kernel S1
on the card, the plain formula on the CPU) on the same values and break
every tie by the packed pair key, which is the single-device table's
position order. Every rank draws the same numbers
from a sampler seeded alike (the coherence samples included): no draw
depends on the rank. After every chunk the ranks compare their merge
counts and a checksum of their histories, and raise on any difference.

The sync paths (:func:`select_sync_path`, the JAX package's gate):

- ``"v3"``: the hash-partitioned sync (:func:`sync_v3`): each rank sends
  its pair counts to their owners (``scoring.pair_dest``), sums the keys
  it owns, scores them, keeps its top-K; the K-sized lists are merged on
  every rank, and the owned table slices are gathered, so that every rank
  holds the whole table in hash-partition order, which K2 then reads with
  ``pair_table_hashed = D``;
- ``"v3f"``: the frozen table of a loaded tokenizer, re-scored in T/D
  row slices (:func:`sync_frozen`);
- ``"v2"``: per-rank replay and pair count, a gather of the D tables and
  their combine (:func:`sync_v2`), then the single-device scoring;
- ``"replicated"``: every rank syncs the whole corpus
  (``enhanced_state.sync_corpus``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from hyptokenizer_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_reduce, all_to_all, shard_enhanced_state,
    shard_state,
)
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from hyptokenizer_tpu_torch.tokenizer import scoring
from hyptokenizer_tpu_torch.tokenizer import state as state_lib

INF = float("inf")
SENT = scoring.PKEY_SENT


def _replay(st, config, corpus):
    replay = (scoring.batch_rank_replay if config.priority_replay
              else scoring.batch_fixpoint_replay)
    start = int(st.corpus_synced)
    return replay(corpus, st.base.merges, start,
                  int(st.base.num_merges) - start, config.n_init)


def sync_v2(st, config, sampler, mesh: Mesh):
    """Per-rank replay and pair count, a gather of the D tables, their
    combine (``scoring.merge_pair_tables``) and the single-device scoring
    tail (``enhanced_state._sync_finish``). ``st.corpus`` is the rank's
    slice."""
    c = _replay(st, config, st.corpus)
    t = config.freq_table_size
    keys, counts, nu, _ = scoring.build_pair_table(c, t)
    gk = all_gather(mesh, keys).reshape(-1, 2)
    gc = all_gather(mesh, counts).reshape(-1)
    gnu = all_gather(mesh, nu.reshape(1)).reshape(-1)
    keys, counts, n_unique, max_count = scoring.merge_pair_tables(
        gk, gc, gnu, t)
    tokens = all_reduce(mesh, scoring.corpus_token_count(c))
    return E._sync_finish(st, config, sampler, c, keys, counts, n_unique,
                          max_count, corpus_tokens=tokens)


def _local_topk(config, scores, pk, dists):
    """This rank's top-K per phase row of its (PR, n) ``scores``,
    tie-broken by packed key: (values (PR, K), packed keys (PR, K),
    distances (PR, K))."""
    k = config.queue_size
    tb = pk[None, :].expand_as(scores)
    tv, tp = scoring.top_k_desc(scores, k, tiebreak=tb)
    found = tv > -INF
    sel_pk = torch.where(found, pk[tp], SENT)
    sel_d = torch.where(found, dists[tp], INF)
    return tv, sel_pk, sel_d


def merge_topk_lists(mesh: Mesh, config, tv, pk, dm):
    """Gather the D per-rank (PR, K) candidate lists and merge them on
    every rank by (score descending, packed key): the single-device
    queues. Returns (q_i, q_j, q_dist, q_score), each (3, K) (a
    one-phase list is repeated to the 3 phase rows)."""
    k = config.queue_size
    tvf, pkf, dmf = (all_gather(mesh, x).transpose(0, 1).reshape(
        x.shape[0], -1) for x in (tv, pk, dm))
    ftv, ftp = scoring.top_k_desc(tvf.contiguous(), k,
                                  tiebreak=pkf.contiguous())
    fpk = torch.gather(pkf, 1, ftp)
    fd = torch.gather(dmf, 1, ftp)
    stored = ftv > -INF
    hi, lo = scoring.unpack_lex(torch.where(stored, fpk, SENT))
    q_i = torch.where(stored, hi, -1).to(torch.int32)
    q_j = torch.where(stored, lo, -1).to(torch.int32)
    q_dist = torch.where(stored, fd, INF)
    if ftv.shape[0] == 1:
        q_i, q_j, q_dist, ftv = (x.expand(3, k).contiguous()
                                 for x in (q_i, q_j, q_dist, ftv))
    return q_i, q_j, q_dist, ftv


def sync_v3(st, config, sampler, mesh: Mesh):
    """The hash-partitioned sync (``_sharded_sync_v3_fn`` of the JAX
    package, step by step). ``st.corpus`` is the rank's slice; the table
    it leaves is the D owned slices of T/D rows in rank order, each sorted
    by packed key."""
    d = mesh.size
    t = config.freq_table_size
    td = t // d
    # The per-(source, owner) send cap and the owned keys scored: twice
    # the expected T/D under a uniform hash, in rows of 128.
    b = own_cap = max(128, -(-2 * td // 128) * 128)
    base = st.base
    dev = base.emb.device
    samples = sampler.coherence(config.coherence_samples,
                                max(int(base.vocab_size), 1)
                                ).to(torch.int32).to(dev)

    # 1. per-rank replay and pair count.
    c = _replay(st, config, st.corpus)
    keys, counts, nu, _ = scoring.build_pair_table(c, t)
    pk = scoring.pack_lex(keys[:, 0], keys[:, 1])
    valid = pk != SENT

    # 2. hash partition: each valid key to its owner's block, in table
    # order, at most b per owner; then the exchange.
    dest = torch.where(valid, scoring.pair_dest(pk, d), 0).long()
    onehot = torch.nn.functional.one_hot(dest, d) & valid[:, None]
    rank_in = (torch.cumsum(onehot, dim=0) - 1).gather(
        1, dest[:, None])[:, 0]
    send_overflow = bool(torch.any(valid & (rank_in >= b)))
    slot = torch.where(valid & (rank_in < b), dest * b + rank_in, d * b)
    sk = torch.full((d * b + 1,), SENT, dtype=torch.int32, device=dev)
    sc = torch.zeros((d * b + 1,), dtype=torch.int32, device=dev)
    sk[slot] = torch.where(valid, pk, SENT)
    sc[slot] = torch.where(valid, counts, 0)
    sk[d * b] = SENT
    sc[d * b] = 0
    rk = all_to_all(mesh, sk[:d * b])
    rc = all_to_all(mesh, sc[:d * b])

    # 3a. the owned combine: the first own_cap owned uniques in key order
    # (the packed-key order is the lexicographic order of the lanes).
    okeys, oc_u, n_own, own_max = scoring.merge_pair_tables(
        torch.stack(scoring.unpack_lex(rk), dim=-1), rc,
        torch.zeros((1,), dtype=torch.int32, device=dev), own_cap)
    ok_u = scoring.pack_lex(okeys[:, 0], okeys[:, 1])
    n_own = int(n_own)

    # 3b. global statistics (exact: the owned key sets are disjoint).
    overflow = int(send_overflow or n_own > own_cap or int(nu) > t
                   or n_own > td)
    mx = all_reduce(mesh, torch.stack([
        torch.tensor(overflow, dtype=torch.int32, device=dev),
        own_max]), "max")
    sums = all_reduce(mesh, torch.stack([
        torch.tensor(n_own, dtype=torch.int32, device=dev),
        scoring.corpus_token_count(c)]))
    n_unique = sums[0]
    if int(mx[0]) > 0:
        n_unique = torch.clamp_min(n_unique, t + 1)
    max_count, corpus_tokens = mx[1], sums[1]

    # 3c. score the owned keys (the embeddings are on every rank).
    scores, dists = E._score_table(st, config, okeys, oc_u, samples,
                                   max_count, corpus_tokens)
    qv = all_reduce(mesh, E.valid_totals(scores))

    # 3d. local top-K, then the K-sized merge on every rank.
    q_i, q_j, q_dist, q_score = merge_topk_lists(
        mesh, config, *_local_topk(config, scores, ok_u, dists))

    # The table: every rank's first T/D owned uniques, gathered. Complete
    # only when no rank owns more than T/D (else `overflow` raised
    # n_unique past T, and the host warns, as the JAX package's does).
    tk = all_gather(mesh, okeys[:td]).reshape(-1, 2)
    tc = all_gather(mesh, oc_u[:td]).reshape(-1)
    return dataclasses.replace(
        st, coh_samples=samples, corpus=c,
        corpus_synced=base.num_merges.clone(), corpus_tokens=corpus_tokens,
        pair_keys=tk, pair_counts=tc, max_pair_count=max_count, pair_unique=n_unique,
        q_i=q_i, q_j=q_j, q_dist=q_dist, q_score=q_score,
        q_valid_total=qv.contiguous(),
        needs_resync=torch.zeros_like(st.needs_resync))


def hash_partition_table(keys, counts, d: int):
    """A lexicographic pair table (T, 2) / (T,) laid out as the v3 sync
    leaves it for ``d`` ranks: owner ``scoring.pair_dest`` slices of T/d
    rows in rank order, each sorted by packed key, SENT padded, at most
    T/d pairs an owner (the v3 sync's cap). For a table that holds every
    pair of its corpus, the v3 sync's own table."""
    t = keys.shape[0]
    td = t // d
    pk = scoring.pack_lex(keys[:, 0], keys[:, 1])
    valid = pk != SENT
    dest = torch.where(valid, scoring.pair_dest(pk, d), d).long()
    order = torch.argsort(dest * 2**32 + (pk.long() + 2**31), stable=True)
    dest_s = dest[order]
    first = torch.searchsorted(dest_s, dest_s, side="left")
    rank = torch.arange(t, device=keys.device) - first
    keep = (dest_s < d) & (rank < td)
    slot = torch.where(keep, dest_s * td + rank, t)
    out_k = torch.full((t + 1, 2), SENT, dtype=torch.int32,
                       device=keys.device)
    out_c = torch.zeros((t + 1,), dtype=torch.int32, device=keys.device)
    out_k[slot] = keys[order]
    out_c[slot] = counts[order]
    return out_k[:t].contiguous(), out_c[:t].contiguous()


def sync_frozen(st, config, sampler, mesh: Mesh):
    """The frozen-table sync of a loaded tokenizer (``v3f``): each rank
    re-scores its T/D row slice of the restored lex table, drops the
    pairs already merged, keeps its top-K; the lists are merged on every
    rank. Table, counts and corpus stay as they are."""
    d = mesh.size
    t = st.pair_keys.shape[0]
    td = t // d
    base = st.base
    dev = base.emb.device
    samples = sampler.coherence(config.coherence_samples,
                                max(int(base.vocab_size), 1)
                                ).to(torch.int32).to(dev)
    sl = slice(mesh.rank * td, (mesh.rank + 1) * td)
    keys = st.pair_keys[sl]
    khi, klo = keys[:, 0], keys[:, 1]
    scores, dists = E._score_table(st, config, keys, st.pair_counts[sl],
                                   samples, st.max_pair_count,
                                   st.corpus_tokens)
    nm = int(base.num_merges)
    consumed = scoring.in_sorted_pair_set(
        khi, klo, *E._sorted_history(base.merges[:nm]), nm)
    scores = torch.where(consumed[None, :], -INF, scores)
    qv = all_reduce(mesh, E.valid_totals(scores))
    pk = scoring.pack_lex(khi, klo)
    q_i, q_j, q_dist, q_score = merge_topk_lists(
        mesh, config, *_local_topk(config, scores, pk, dists))
    return dataclasses.replace(
        st, coh_samples=samples, corpus_synced=base.num_merges.clone(),
        q_i=q_i, q_j=q_j, q_dist=q_dist, q_score=q_score,
        q_valid_total=qv.contiguous(),
        needs_resync=torch.zeros_like(st.needs_resync))


def _corpus_shard_aligned(st, n_dev: int) -> bool:
    """True when every corpus shard boundary lands on PAD/SEP, so that
    per-shard pair counts are exact (``utils/data.shard_align_corpus``)."""
    n = st.corpus.shape[0]
    if n_dev <= 1:
        return True
    if n % n_dev != 0:
        return False
    idx = torch.tensor([k * (n // n_dev) - 1 for k in range(1, n_dev)],
                       device=st.corpus.device)
    return bool(torch.all(st.corpus[idx] < 0))


def select_sync_path(st, config, mesh: Mesh) -> str:
    """Which sync a sharded chunk uses: ``"v3"`` (a live, aligned corpus,
    ids that pack, T divisible by D), ``"v3f"`` (a frozen table, the same
    gate), ``"v2"`` (a live aligned corpus that v3 refuses), or
    ``"replicated"`` (an unaligned corpus, no corpus feature, or a frozen
    table v3f refuses: v2 would rebuild, and zero, the restored table
    from the dummy corpus)."""
    aligned = config.needs_corpus and _corpus_shard_aligned(st, mesh.size)
    if not aligned:
        return "replicated"
    eligible = (config.base.max_vocab_size <= scoring.PACK_MAX_ID
                and config.freq_table_size % mesh.size == 0)
    if config.frozen_freqs:
        return "v3f" if eligible else "replicated"
    return "v3" if eligible else "v2"


_SYNCS = {"v2": sync_v2, "v3": sync_v3, "v3f": sync_frozen}


def history_checksum(base) -> torch.Tensor:
    """(num_merges, a checksum of merges[:num_merges]) as an int64 (2,)
    tensor on the state's device: position-weighted pair codes modulo the
    prime 2^31 - 1, summed in int64 (no product or sum overflows)."""
    p = 2**31 - 1
    n = base.num_merges.long()
    m = base.merges.long()
    live = torch.arange(m.shape[0], device=m.device) < n
    w = (torch.arange(1, m.shape[0] + 1, device=m.device) * 48271) % p
    code = (m[:, 0] * 65599 + m[:, 1] + 7) % p
    h = torch.where(live, (code * w) % p, 0).sum()
    return torch.stack([n, h])


def check_replicas(mesh: Mesh, base) -> None:
    """Raise unless every rank holds the same merge count and history
    (two int64 a rank): a replica that drifted must never pass."""
    if mesh.size == 1:
        return
    got = all_gather(mesh, history_checksum(base)).cpu()
    if not bool(torch.all(got == got[0])):
        raise RuntimeError(
            "sharded training: the ranks' merge histories differ "
            f"(num_merges, checksum by rank: {got.tolist()})")


def run_enhanced_sharded(st, config, n_steps: int, mesh: Mesh, sampler):
    """One chunk of the enhanced loop across the ranks:
    ``enhanced_state.run_enhanced`` (the same sync -> segment -> resync
    pacing of ``enhanced_state.run_chunk``) with the path's sync; the
    segments run K1/K2 on the card, their plain version on the CPU. Every
    rank passes its own copy of the same state and a sampler seeded alike;
    returns the state, whole on every rank (the corpus gathered), and the
    number of syncs."""
    if st.base.emb.shape[0] % mesh.size != 0:
        raise ValueError("max_vocab_size not divisible by mesh size")
    path = select_sync_path(st, config, mesh)
    loop_config = config
    if path == "v3" and config.use_dense_channel:
        loop_config = dataclasses.replace(config,
                                          pair_table_hashed=mesh.size)
    sync = (functools.partial(_SYNCS[path], mesh=mesh) if path in _SYNCS
            else None)
    st = shard_enhanced_state(st, mesh, path)
    st, rounds = E.run_enhanced(st, loop_config, n_steps, sampler, sync)
    if path in ("v2", "v3") and mesh.size > 1:
        st = dataclasses.replace(st, corpus=all_gather(mesh, st.corpus)
                                 .reshape(-1))
    check_replicas(mesh, st.base)
    return st, rounds


def run_merges_sharded(state, config, n_steps: int, mesh: Mesh):
    """``n_steps`` steps of the distance-only loop on every rank (K4 on
    the card, one launch), the state replicated; the ranks' histories are
    compared after the chunk."""
    if state.emb.shape[0] % mesh.size != 0:
        raise ValueError(
            f"max_vocab_size {state.emb.shape[0]} not divisible by mesh size "
            f"{mesh.size}; use parallel.mesh.pad_vocab_for_mesh")
    state = shard_state(state, mesh)
    out = state_lib.run_merges(state, config, n_steps)
    check_replicas(mesh, out)
    return out


def run_embed_train_sharded(emb0, corpus, vocab_size, sampler, mesh: Mesh,
                            **kw):
    """RSGD embedding pretraining across the ranks: every rank draws the
    whole batch (a sampler seeded alike), takes its slice of it, and the
    table gradient and the loss are summed by ``all_reduce``; the table is
    replicated. At a world of one, ``embed_train.train_embeddings`` bit
    for bit."""
    from hyptokenizer_tpu_torch.tokenizer import embed_train

    def reduce(loss, g):
        return all_reduce(mesh, loss), all_reduce(mesh, g)

    emb0 = torch.as_tensor(emb0).to(mesh.device)
    return embed_train.train_embeddings(
        emb0, torch.as_tensor(corpus), vocab_size, sampler,
        part=(mesh.rank, mesh.size, reduce), **kw)
