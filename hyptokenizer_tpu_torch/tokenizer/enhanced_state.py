"""The enhanced (feature-scored) merge loop, in PyTorch.

Port of ``hyptokenizer_tpu/tokenizer/enhanced_state.py`` (see that
module's docstring for the two-channel design). Sparse candidates come from
per-phase, score-sorted queues of corpus pairs that ``sync_corpus``
rebuilds at chunk boundaries; each step consumes the first ``merge_batch``
valid entries of the current phase's queue. The dense (geometric) channel
adds one candidate per step, the argmin of the per-row best distances
``best_dist``/``best_j``, fully scored; its merges fold the new columns
back into those arrays (``state.insert_batch``).

``enhanced_step`` is the plain version of kernels K1 (corpus-only) and K2
(dense channel), ``ops/cuda/enhanced_loop.py``: the CPU path loops it, the
card launches the kernel, and ``chip_smoke.py`` holds the two against each
other.

The chunk loop lives here too: :func:`run_enhanced` runs
:func:`run_chunk` (one sync, then segments between curvature steps), whose
:func:`run_segment` launches K1/K2 on the card or loops the plain step on
the CPU.

Random numbers. The JAX package draws from its state's PRNG key at every
sync (coherence samples) and at every curvature event (negatives and
distortion pairs). Here those draws come from a *sampler* passed in by the
caller: :class:`TorchSampler` draws from a seeded ``torch.Generator``; the
tests pass one that replays the JAX key chain, so both packages see the
same numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from hyptokenizer_tpu_torch.ops import lorentz as L
from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop
from hyptokenizer_tpu_torch.tokenizer import scoring
from hyptokenizer_tpu_torch.tokenizer.state import (
    THRESHOLD_CAP, MergeConfig, MergeState, StatsSampler, insert_batch,
)
from hyptokenizer_tpu_torch.utils import metrics

INF = float("inf")
GRAD_EPS = 1e-6  # acosh clamp for differentiable paths (ops/lorentz.py)


@dataclasses.dataclass(frozen=True)
class EnhancedConfig:
    """Static configuration of the scored loop (the JAX package's fields)."""

    base: MergeConfig = dataclasses.field(default_factory=MergeConfig)
    n_init: int = 0
    has_corpus: bool = False
    merge_batch: int = 8
    min_pair_freq: int = 1
    use_dense_channel: bool = True
    priority_replay: bool = False

    use_frequency: bool = False
    alpha: float = 0.4
    beta: float = 0.4
    gamma: float = 0.2
    coherence_samples: int = 50

    use_compression: bool = False
    compression_weight: float = 0.3

    use_hierarchical: bool = False
    morphology_weight: float = 0.3
    phase2_step: int = 1000
    phase3_step: int = 6000
    phase_thresholds: tuple = (0.05, 0.1, 0.2)

    use_adaptive_curvature: bool = False
    curvature_freq: int = 100
    curvature_lr: float = 0.01
    hierarchy_weight: float = 1.0
    distortion_weight: float = 0.5
    curvature_min: float = 0.1
    curvature_max: float = 10.0
    hier_pairs: int = 100
    hier_negatives: int = 10
    distortion_samples: int = 500

    frozen_freqs: bool = False
    # The pair table's layout as the loop reads it: 0/1 one lex-sorted
    # table (build_pair_table); D > 1 the v3 sharded sync's D owner slices
    # of T/D rows, each sorted (scoring.lookup_pair_counts_hashed). Only
    # the dense channel's per-step count lookup reads it; the sharded
    # chunk (parallel/sharded.py) sets it on the configuration it hands the
    # loop after a v3 sync.
    pair_table_hashed: int = 0
    freq_table_size: int = 1 << 17
    queue_size: int = 4096

    @property
    def needs_corpus(self) -> bool:
        return self.has_corpus and (self.use_frequency or self.use_compression
                                    or self.use_hierarchical)

    @property
    def uses_dense(self) -> bool:
        """Whether the loop runs the dense channel (kernel K2, else K1)."""
        return self.use_dense_channel or not self.needs_corpus

    def weights(self):
        """Cascaded feature weights (alpha, beta, gamma, comp_w, morph_w)."""
        if self.use_frequency:
            alpha, beta, gamma = self.alpha, self.beta, self.gamma
        else:
            alpha, beta, gamma = 0.7, 0.0, 0.0
        comp_w = 0.0
        if self.use_compression:
            comp_w = self.compression_weight
            alpha *= (1 - comp_w)
            beta *= (1 - comp_w)
            gamma *= (1 - comp_w)
        morph_w = 0.0
        if self.use_hierarchical:
            morph_w = self.morphology_weight
            alpha *= (1 - morph_w)
            beta *= (1 - morph_w)
            gamma *= (1 - morph_w)
            comp_w *= (1 - morph_w)
        return alpha, beta, gamma, comp_w, morph_w


@dataclasses.dataclass
class EnhancedState:
    """Merge state + corpus statistics + feature state.

    The JAX package's ``key`` field has no counterpart: draws come from the
    sampler the caller passes (module docstring)."""

    base: MergeState
    phase: torch.Tensor            # i32: 1/2/3 hierarchical phase
    corpus: torch.Tensor           # (N,) i32, PAD=-1 tail, SEP=-2 separators
    corpus_synced: torch.Tensor    # i32 — merges already replayed
    corpus_tokens: torch.Tensor    # i32 — live tokens at last sync
    pair_keys: torch.Tensor        # (T, 2) i32 lex-sorted
    pair_counts: torch.Tensor      # (T,) i32
    max_pair_count: torch.Tensor   # i32
    pair_unique: torch.Tensor      # i32 — unique pairs before clipping
    q_i: torch.Tensor              # (3, K) i32 left id (-1 empty)
    q_j: torch.Tensor              # (3, K) i32 right id
    q_dist: torch.Tensor           # (3, K) f32 distance at sync curvature
    q_score: torch.Tensor          # (3, K) f32; -inf = empty/consumed
    q_valid_total: torch.Tensor    # (3,) i32 valid candidates in full table
    needs_resync: torch.Tensor     # bool
    coh_samples: torch.Tensor      # (S,) i32 per-chunk coherence samples
    token_hash: torch.Tensor       # (max_V, 2) i32
    byte_lengths: torch.Tensor     # (max_V,) i32
    has_vowel: torch.Tensor        # (max_V,) bool
    hash_powers: torch.Tensor      # (2, MAX_HASH_LEN) i32
    morph_table: torch.Tensor      # (Mm,) i32 sorted, HKEY_SENT padded
    morph_size: torch.Tensor       # i32
    word_table: torch.Tensor       # (Mw,) i32 sorted
    word_size: torch.Tensor        # i32
    curv_m: torch.Tensor           # f32 Adam first moment
    curv_v: torch.Tensor           # f32 Adam second moment
    curv_t: torch.Tensor           # i32 Adam step
    curv_last: torch.Tensor        # i32 — num_merges at last update


def clone_state(st: EnhancedState) -> EnhancedState:
    """A deep copy (merge steps update buffers in place)."""
    return dataclasses.replace(
        st, base=dataclasses.replace(
            st.base, **{f.name: getattr(st.base, f.name).clone()
                        for f in dataclasses.fields(MergeState)}),
        **{f.name: getattr(st, f.name).clone()
           for f in dataclasses.fields(EnhancedState) if f.name != "base"})


class TorchSampler(StatsSampler):
    """The default source of the loop's random draws: a seeded
    ``torch.Generator`` on the training device (the generator of
    :class:`state.StatsSampler`)."""

    def coherence(self, n: int, high: int) -> torch.Tensor:
        """(n,) token ids in [0, high) for one sync's coherence samples."""
        return self._randint((n,), high)

    def curvature(self, hp: int, hn: int, ds: int, high: int):
        """Negatives (hp, hn) and distortion pairs (ds,), (ds,) for one
        curvature event, ids in [0, high)."""
        return (self._randint((hp, hn), high), self._randint((ds,), high),
                self._randint((ds,), high))


def assemble_enhanced_buffers(t_feat, morph_tab, word_tab, morph_size: int,
                              word_size: int, max_v: int, table_size: int,
                              queue_size: int, coh_samples: int,
                              device) -> dict:
    """Every EnhancedState field except ``base`` and ``corpus``.

    ``t_feat`` is (n0, 4) int32: [hash1, hash2, byte_len, has_vowel] per
    initial token; the morphology tables are sorted int32 hash arrays."""
    dev = torch.device(device)
    t_feat = torch.as_tensor(t_feat, dtype=torch.int32).to(dev)
    n0 = t_feat.shape[0]

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    token_hash = torch.zeros((max_v, 2), dtype=torch.int32, device=dev)
    token_hash[:n0] = t_feat[:, :2]
    byte_lengths = torch.zeros((max_v,), dtype=torch.int32, device=dev)
    byte_lengths[:n0] = t_feat[:, 2]
    has_vowel = torch.zeros((max_v,), dtype=torch.bool, device=dev)
    has_vowel[:n0] = t_feat[:, 3].bool()
    return dict(
        phase=i32(1), corpus_synced=i32(0), corpus_tokens=i32(0),
        pair_keys=torch.full((table_size, 2), scoring.PKEY_SENT,
                             dtype=torch.int32, device=dev),
        pair_counts=torch.zeros((table_size,), dtype=torch.int32, device=dev),
        max_pair_count=i32(0), pair_unique=i32(0),
        q_i=torch.full((3, queue_size), -1, dtype=torch.int32, device=dev),
        q_j=torch.full((3, queue_size), -1, dtype=torch.int32, device=dev),
        q_dist=torch.full((3, queue_size), INF, device=dev),
        q_score=torch.full((3, queue_size), -INF, device=dev),
        q_valid_total=torch.zeros((3,), dtype=torch.int32, device=dev),
        needs_resync=torch.tensor(False, device=dev),
        coh_samples=torch.zeros((coh_samples,), dtype=torch.int32,
                                device=dev),
        token_hash=token_hash, byte_lengths=byte_lengths,
        has_vowel=has_vowel,
        hash_powers=scoring.hash_powers(device=dev),
        morph_table=torch.as_tensor(morph_tab, dtype=torch.int32).to(dev),
        morph_size=i32(morph_size),
        word_table=torch.as_tensor(word_tab, dtype=torch.int32).to(dev),
        word_size=i32(word_size),
        curv_m=f32(0.0), curv_v=f32(0.0), curv_t=i32(0), curv_last=i32(0),
    )


# ----------------------------------------------------------------- features

COHERENCE_BLOCK = 4096  # rows per gram of the plain coherence (below)


def _coherence(emb, rows, cols, lengths, c, threshold, samples_idx):
    """Sigmoid semantic coherence of the simulated merges (rows, cols).

    Past one block, the midpoint-to-sample grams are taken
    ``COHERENCE_BLOCK`` rows at a time, the last block padded: every gram
    then has the same shape whatever the number of candidates, so on the
    plain path a candidate's score has the same bits in the single-device
    sync (T rows) and in a sharded one (each rank's owned keys), and the
    two keep the same order of near-equal scores. (Kernel S1, which scores
    the syncs' tables on the card, gives a row the same bits wherever it
    lies in the table, and needs no padding.)"""
    w_j = (lengths[cols].float()
           / torch.clamp_min(lengths[rows] + lengths[cols], 1).float())
    mid = L.geodesic_point(emb[rows], emb[cols], w_j)
    s = samples_idx.long()
    n = mid.shape[0]
    if n <= 1:
        dmat = L.pairwise_dist(mid, emb[s], c, eps=GRAD_EPS)
    else:
        nb = -(-n // COHERENCE_BLOCK)
        pad = torch.cat([mid, mid[:1].expand(nb * COHERENCE_BLOCK - n, -1)])
        samp = emb[s]
        dmat = torch.cat([L.pairwise_dist(blk, samp, c, eps=GRAD_EPS)
                          for blk in pad.split(COHERENCE_BLOCK)])[:n]
    not_self = (s[None, :] != rows[:, None]) & (s[None, :] != cols[:, None])
    cnt = torch.clamp_min(not_self.sum(dim=1), 1)
    avg = torch.where(not_self, dmat, torch.zeros_like(dmat)).sum(dim=1) / cnt
    return 1.0 / (1.0 + torch.exp(avg - threshold))


def _morph_scores_raw(lengths, token_hash, byte_lengths, has_vowel,
                      hash_powers, morph_table, morph_size, word_table,
                      word_size, rows, cols):
    """(n, 3) morphology score per phase for candidate pairs."""
    len_i = lengths[rows]
    len_j = lengths[cols]
    p1 = torch.where((len_i <= 2) & (len_j <= 2), 0.8, 0.2)
    merged = scoring.compose_hash(token_hash[rows], token_hash[cols],
                                  byte_lengths[cols], hash_powers)
    mkey = scoring.pack_hash(merged[..., 0], merged[..., 1])
    is_morph = scoring.in_sorted_set(mkey, morph_table, morph_size)
    merged_vowel = has_vowel[rows] | has_vowel[cols]
    is_word = (scoring.in_sorted_set(mkey, word_table, word_size)
               | ((len_i + len_j >= 3) & merged_vowel))
    p2 = torch.where(is_morph, 0.9, 0.3)
    p3 = torch.where(is_word, 1.0, 0.4)
    return torch.stack([p1, p2, p3], dim=-1).float()


def _full_scores_raw(config: EnhancedConfig, emb, lengths, threshold,
                     curvature, coh_samples, max_pair_count, corpus_tokens,
                     token_hash, byte_lengths, has_vowel, hash_powers,
                     morph_table, morph_size, word_table, word_size,
                     rows, cols, dists, freqs):
    """(n, 3) combined score per phase with the reference's weight cascade:
    the single-device sync, the sharded syncs (``parallel/sharded.py``, on
    each rank's keys) and the dense candidate score with this one formula.
    Coherence uses the sync's sample set ``coh_samples``; compression the
    sync-time token total ``corpus_tokens``."""
    alpha, beta, gamma, comp_w, morph_w = config.weights()
    n = rows.shape[0]
    dev = dists.device
    dist_score = 1.0 / (1.0 + dists)
    frequency_score = torch.zeros((n,), device=dev)
    semantic = torch.zeros((n,), device=dev)
    compression = torch.zeros((n,), device=dev)
    if config.use_frequency:
        denom = torch.log1p(torch.clamp_min(max_pair_count, 1).float())
        frequency_score = (torch.log1p(freqs.float())
                           / torch.clamp_min(denom, 1e-9))
        semantic = _coherence(emb, rows, cols, lengths, curvature, threshold,
                              coh_samples)
    if config.use_compression:
        total = torch.clamp_min(corpus_tokens, 1).float()
        ratio = total / torch.clamp_min(total - freqs.float(), 1.0)
        compression = torch.clamp(ratio - 1.0, 0.0, 1.0)
    score = (alpha * dist_score + beta * frequency_score + gamma * semantic
             + comp_w * compression)[:, None] * torch.ones((1, 3), device=dev)
    if config.use_hierarchical:
        score = score + morph_w * _morph_scores_raw(
            lengths, token_hash, byte_lengths, has_vowel, hash_powers,
            morph_table, morph_size, word_table, word_size, rows, cols)
    return score


def score_candidates(config: EnhancedConfig, emb, lengths, threshold,
                     curvature, coh_samples, max_pair_count, corpus_tokens,
                     token_hash, byte_lengths, has_vowel, hash_powers,
                     morph_table, morph_size, word_table, word_size, keys,
                     counts):
    """Scores and distances of every row of a pair table ``keys`` (T, 2) /
    ``counts`` (T,), the syncs' candidates (single-device and sharded):
    ``(scores (P, T), dists (T,))``, P = 3 with the curriculum and 1
    without (its three phase columns are equal). A row is a candidate when
    it is no sentinel, its count reaches ``min_pair_freq`` and, with
    ``max_token_len`` > 0, its merged token is not too long; any other row
    scores -inf, and a sentinel row has distance inf.

    Kernel S1 (``ops/cuda/sync_score.py``) for CUDA tensors, one launch;
    :func:`score_candidates_plain` for CPU tensors."""
    if keys.device.type != "cuda":
        return score_candidates_plain(
            config, emb, lengths, threshold, curvature, coh_samples,
            max_pair_count, corpus_tokens, token_hash, byte_lengths,
            has_vowel, hash_powers, morph_table, morph_size, word_table,
            word_size, keys, counts)
    from hyptokenizer_tpu_torch.ops.cuda import sync_score
    return sync_score.score(
        keys, counts, emb, lengths, token_hash, byte_lengths, has_vowel,
        hash_powers, morph_table, morph_size, word_table, word_size,
        coh_samples, curvature, threshold, max_pair_count, corpus_tokens,
        use_frequency=config.use_frequency,
        use_compression=config.use_compression,
        use_hierarchical=config.use_hierarchical, weights=config.weights(),
        min_pair_freq=config.min_pair_freq,
        max_token_len=config.base.max_token_len)


def score_candidates_plain(config: EnhancedConfig, emb, lengths, threshold,
                           curvature, coh_samples, max_pair_count,
                           corpus_tokens, token_hash, byte_lengths,
                           has_vowel, hash_powers, morph_table, morph_size,
                           word_table, word_size, keys, counts):
    """:func:`score_candidates` in PyTorch ops (:func:`_full_scores_raw`
    and the candidate gate), on any device: the plain version of kernel
    S1."""
    # Self-pairs (a, a) are real corpus candidates ('aa' from doubled
    # letters); only the sentinel rows are excluded.
    valid = keys[:, 0] != scoring.PKEY_SENT
    rows = torch.where(valid, keys[:, 0], 0).long()
    cols = torch.where(valid, keys[:, 1], 0).long()
    dists = L.distance(emb[rows], emb[cols], curvature)
    dists = torch.where(valid, dists, INF)
    score3 = _full_scores_raw(
        config, emb, lengths, threshold, curvature, coh_samples,
        max_pair_count, corpus_tokens, token_hash, byte_lengths, has_vowel,
        hash_powers, morph_table, morph_size, word_table, word_size, rows,
        cols, dists, counts)
    ok = valid & (counts >= config.min_pair_freq)
    if config.base.max_token_len > 0:
        ok &= (lengths[rows] + lengths[cols] <= config.base.max_token_len)
    score3 = torch.where(ok[:, None], score3, -INF)
    phases = score3 if config.use_hierarchical else score3[:, :1]
    return phases.T.contiguous(), dists


def _score_table(st: EnhancedState, config: EnhancedConfig, keys, counts,
                 samples, max_count, corpus_tokens):
    """:func:`score_candidates` with ``st``'s rows, features and tables."""
    base = st.base
    return score_candidates(
        config, base.emb, base.lengths, base.threshold, base.curvature,
        samples, max_count, corpus_tokens, st.token_hash, st.byte_lengths,
        st.has_vowel, st.hash_powers, st.morph_table, st.morph_size,
        st.word_table, st.word_size, keys, counts)


def valid_totals(scores: torch.Tensor) -> torch.Tensor:
    """The three phases' counts of candidates (scores above -inf) of a
    (P, T) score array, int32 (3,); one phase row stands for all three."""
    qv = (scores > -INF).sum(dim=1).to(torch.int32)
    return qv.expand(3).contiguous() if qv.shape[0] == 1 else qv


# --------------------------------------------------------------- curvature

def _curvature_losses(st: EnhancedState, config: EnhancedConfig, draws,
                      c: torch.Tensor) -> torch.Tensor:
    """Hierarchy-preservation + distortion loss at curvature ``c``."""
    negs, ii, jj = (d.long() for d in draws)
    base = st.base
    emb = base.emb
    nm = base.num_merges
    hp = config.hier_pairs
    idx = torch.arange(hp, device=emb.device)
    take = torch.clamp_min(nm - hp, 0) + idx
    take = torch.minimum(take, torch.clamp_min(nm - 1, 0)).long()
    valid_pair = idx < torch.clamp_max(nm, hp)
    pi = base.merges[take, 0].long()
    pj = base.merges[take, 1].long()
    xi = emb[pi]
    xj = emb[pj]
    pair_d = L.distance(xi, xj, c, eps=GRAD_EPS)
    neg_emb = emb[negs]
    d_i = L.distance(xi[:, None, :], neg_emb, c, eps=GRAD_EPS)
    d_j = L.distance(xj[:, None, :], neg_emb, c, eps=GRAD_EPS)
    not_self = (negs != pi[:, None]) & (negs != pj[:, None])
    margin = 0.1
    zero = torch.zeros((), device=emb.device)
    h_i = torch.where(not_self, torch.relu(pair_d[:, None] - d_i + margin),
                      zero)
    h_j = torch.where(not_self, torch.relu(pair_d[:, None] - d_j + margin),
                      zero)
    cnt = torch.clamp_min(not_self.sum(dim=1), 1)
    per_pair = (h_i.sum(dim=1) + h_j.sum(dim=1)) / cnt
    n_eff = torch.clamp_min(valid_pair.sum(), 1)
    hier_loss = torch.where(valid_pair, per_pair, zero).sum() / (2 * n_eff)

    dd = L.distance(emb[ii], emb[jj], c, eps=GRAD_EPS)
    keep = ii != jj
    cnt = torch.clamp_min(keep.sum(), 1)
    mean_d = torch.where(keep, dd, zero).sum() / cnt
    var_d = torch.where(keep, (dd - mean_d) ** 2, zero).sum() / cnt
    distortion = torch.exp(-10.0 * mean_d) + 0.1 * var_d
    return (config.hierarchy_weight * hier_loss
            + config.distortion_weight * distortion)


def _maybe_update_curvature(st: EnhancedState, config: EnhancedConfig,
                            sampler) -> EnhancedState:
    """Adam step on curvature every ``curvature_freq`` merges.

    Draws happen only inside a fired update, so the draw sequence is a
    function of merge counts alone: the kernel halts at curvature events and
    this runs between segments, reproducing the step-by-step order.
    """
    if config.curvature_freq <= 0:
        return st
    base = st.base
    nm = int(base.num_merges)
    freq = config.curvature_freq
    if nm // freq <= int(st.curv_last) // freq:
        return st
    with metrics.span("curvature_adam"):
        draws = sampler.curvature(config.hier_pairs, config.hier_negatives,
                                  config.distortion_samples,
                                  max(int(base.vocab_size), 1))
        with torch.enable_grad():
            c = base.curvature.detach().clone().requires_grad_(True)
            g = torch.autograd.grad(
                _curvature_losses(st, config, draws, c), c)[0]
        t = st.curv_t + 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        m = b1 * st.curv_m + (1 - b1) * g
        v = b2 * st.curv_v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** t.float())
        vhat = v / (1 - b2 ** t.float())
        c_new = base.curvature - config.curvature_lr * mhat / (
            torch.sqrt(vhat) + eps)
        c_new = torch.clamp(c_new, config.curvature_min,
                            config.curvature_max)
        # Distances scale by 1/sqrt(c): cached candidate distances are
        # rescaled, not recomputed (exact under the distance-scale curvature
        # model).
        scale = torch.sqrt(base.curvature / c_new)
        best_dist = torch.where(torch.isfinite(base.best_dist),
                                base.best_dist * scale, base.best_dist)
        return dataclasses.replace(
            st, base=dataclasses.replace(base, curvature=c_new,
                                         best_dist=best_dist),
            q_dist=st.q_dist * scale, curv_m=m, curv_v=v, curv_t=t,
            curv_last=torch.full_like(st.curv_last, nm))


# -------------------------------------------------------------------- step

def _dense_candidate(st: EnhancedState, config: EnhancedConfig, pidx: int):
    """The dense channel's representative: the global argmin of
    ``best_dist`` (lowest index on ties), fully scored at phase ``pidx``.

    Returns (di, dj, dd, valid, score) as 0-d tensors."""
    base = st.base
    di = torch.argmin(base.best_dist)
    dd = base.best_dist[di]
    dj = base.best_j[di].long()
    if config.pair_table_hashed > 1:
        freq = scoring.lookup_pair_counts_hashed(
            di[None], dj[None], st.pair_keys, st.pair_counts,
            config.pair_table_hashed)
    else:
        freq = scoring.lookup_pair_counts(di[None], dj[None], st.pair_keys,
                                          st.pair_counts)
    score = _full_scores_raw(
        config, base.emb, base.lengths, base.threshold, base.curvature,
        st.coh_samples, st.max_pair_count, st.corpus_tokens, st.token_hash,
        st.byte_lengths, st.has_vowel, st.hash_powers, st.morph_table,
        st.morph_size, st.word_table, st.word_size, di[None], dj[None],
        dd[None], freq)[0, pidx]
    valid = torch.isfinite(dd) & (dd < base.threshold)
    if config.base.max_token_len > 0:
        # Backstop for the structural fold gate (a state re-scanned on load
        # can carry overlong pairs).
        valid &= (base.lengths[di] + base.lengths[dj]
                  <= config.base.max_token_len)
    return di, dj, dd, valid, score


def enhanced_step(st: EnhancedState, config: EnhancedConfig,
                  sampler) -> EnhancedState:
    """One scored step: merge up to ``merge_batch`` candidates.

    Selection: the first ``merge_batch`` valid entries of the current
    phase's score-sorted queue (corpus configurations) and, with the dense
    channel, the fully scored distance argmin inserted at its rank among
    them (dense first on ties). The plain version of kernels K1 (corpus
    only) and K2 (dense channel). Buffers update in place; the returned
    state carries the new scalars.
    """
    base = st.base
    dev = base.emb.device
    if config.use_hierarchical:
        # Phase = f(merge count), with the phase threshold applied on entry.
        thr_tab = torch.tensor(config.phase_thresholds, dtype=torch.float32,
                               device=dev)
        nm = base.num_merges
        phase = (1 + (nm >= config.phase2_step).int()
                 + (nm >= config.phase3_step).int())
        threshold = torch.where(phase != st.phase,
                                thr_tab[torch.clamp(phase - 1, 0, 2).long()],
                                base.threshold)
        st = dataclasses.replace(
            st, base=dataclasses.replace(base, threshold=threshold),
            phase=phase)
    if config.use_adaptive_curvature:
        st = _maybe_update_curvature(st, config, sampler)
    base = st.base

    pidx = int(torch.clamp(st.phase - 1, 0, 2))
    nb = max(1, config.merge_batch)
    dense_valid = False
    if config.uses_dense:
        di, dj, dd, dense_valid, dense_score = _dense_candidate(st, config,
                                                                pidx)
        dense_valid = bool(dense_valid)

    need_rs = False
    pos = torch.zeros((0,), dtype=torch.long, device=dev)
    if config.needs_corpus:
        # Consume-on-read from the current phase's score-sorted queue: its
        # first nb valid entries are the top-nb candidates of the table.
        k = config.queue_size
        qs = st.q_score[pidx]
        qd = st.q_dist[pidx]
        live = qs > -INF
        valid = live & (qd < base.threshold)
        if config.use_dense_channel and dense_valid:
            # A queue entry equal to the dense pair makes the same token:
            # keep the dense copy only.
            valid &= ~((st.q_i[pidx] == di) & (st.q_j[pidx] == dj))
        n_valid = int(valid.sum())
        consumed_any = bool(base.num_merges > st.corpus_synced)
        # A truncated queue that can no longer fill a batch may hide better
        # candidates in the full table; in corpus-only mode a fully consumed
        # queue can only be refilled by a sync (the merges made new corpus
        # pairs).
        need_rs = int(st.q_valid_total[pidx]) > k and consumed_any and \
            n_valid < nb
        if not config.use_dense_channel:
            need_rs = need_rs or (int(live.sum()) == 0 and consumed_any)
        pos = torch.nonzero(valid).flatten()[:nb]

    prev_merges = base.num_merges
    if need_rs:
        st = dataclasses.replace(st, needs_resync=torch.ones_like(
            st.needs_resync))
    else:
        ii = st.q_i[pidx, pos].long() if config.needs_corpus else pos
        jj = st.q_j[pidx, pos].long() if config.needs_corpus else pos
        dd_b = (st.q_dist[pidx, pos] if config.needs_corpus
                else torch.zeros((0,), device=dev))
        if dense_valid:
            # Insertion rank among the score-sorted queue picks.
            p = int((st.q_score[pidx, pos] > dense_score).sum()) \
                if config.needs_corpus else 0
            ii = torch.cat([ii[:p], di[None], ii[p:]])
            jj = torch.cat([jj[:p], dj[None], jj[p:]])
            dd_b = torch.cat([dd_b[:p], dd[None], dd_b[p:]])
        n_apply = min(ii.shape[0],
                      config.base.max_vocab_size - int(base.vocab_size))
        if dense_valid and p < n_apply and metrics.tracing():
            metrics.count("merge.dense")
        if n_apply > 0:
            ii, jj, dd_b = ii[:n_apply], jj[:n_apply], dd_b[:n_apply]
            slot = base.vocab_size.long() + torch.arange(n_apply, device=dev)
            st.token_hash[slot] = scoring.compose_hash(
                st.token_hash[ii], st.token_hash[jj], st.byte_lengths[jj],
                st.hash_powers)
            st.byte_lengths[slot] = st.byte_lengths[ii] + st.byte_lengths[jj]
            st.has_vowel[slot] = st.has_vowel[ii] | st.has_vowel[jj]
            if config.needs_corpus:
                # Consume every applied ordered pair in ALL phase queues.
                hit = ((st.q_i[..., None] == ii.int())
                       & (st.q_j[..., None] == jj.int())).any(-1)
                st.q_score[hit] = -INF
            base = insert_batch(base, ii, jj, dd_b, fold=config.uses_dense,
                                max_token_len=config.base.max_token_len)
        else:
            empty = base.empty_rounds + 1
            if config.base.adaptive_threshold:
                grow = empty >= config.base.empty_growth_after
                if metrics.tracing() and bool(grow):
                    metrics.count("threshold.empty_growth")
                threshold = torch.clamp_max(torch.where(
                    grow, base.threshold * config.base.empty_growth,
                    base.threshold), THRESHOLD_CAP)
                base = dataclasses.replace(
                    base, threshold=threshold,
                    empty_rounds=torch.where(grow, torch.zeros_like(empty),
                                             empty))
            else:
                base = dataclasses.replace(
                    base, empty_rounds=empty,
                    stopped=empty >= config.base.empty_stop_after)

    step = base.step + (0 if need_rs else 1)
    threshold = base.threshold
    every = config.base.threshold_growth_every
    if config.base.adaptive_threshold and every > 0:
        grow = (base.num_merges // every) > (prev_merges // every)
        threshold = torch.clamp_max(torch.where(
            grow, threshold * config.base.threshold_growth, threshold),
            THRESHOLD_CAP)
    full = base.vocab_size >= config.base.max_vocab_size
    return dataclasses.replace(st, base=dataclasses.replace(
        base, step=step, threshold=threshold, stopped=base.stopped | full))


# ------------------------------------------------------------------- sync

def sync_corpus(st: EnhancedState, config: EnhancedConfig,
                sampler) -> EnhancedState:
    """Replay un-synced merges onto the corpus, rebuild the pair table and
    the candidate queues (spans ``sync.replay``, ``sync.pair_table`` and
    ``sync.queues``)."""
    if not config.needs_corpus:
        return st
    if config.frozen_freqs:
        # No corpus to replay: keep the restored counts, rescore the queues
        # against the current embeddings and curvature.
        with metrics.span("sync.queues"):
            return _sync_finish(st, config, sampler, st.corpus, st.pair_keys,
                                st.pair_counts, st.pair_unique,
                                st.max_pair_count)
    base = st.base
    replay = (scoring.batch_rank_replay if config.priority_replay
              else scoring.batch_fixpoint_replay)
    with metrics.span("sync.replay"):
        start = int(st.corpus_synced)
        corpus = replay(st.corpus, base.merges, start,
                        int(base.num_merges) - start, config.n_init)
    with metrics.span("sync.pair_table"):
        keys, counts, n_unique, max_count = scoring.build_pair_table(
            corpus, config.freq_table_size)
    with metrics.span("sync.queues"):
        return _sync_finish(st, config, sampler, corpus, keys, counts,
                            n_unique, max_count)


def _sync_finish(st: EnhancedState, config: EnhancedConfig, sampler,
                 corpus, keys, counts, n_unique, max_count,
                 corpus_tokens=None) -> EnhancedState:
    """Scores and candidate queues from a fresh pair table.

    ``corpus_tokens``: the live token total, when ``corpus`` is one rank's
    shard of it (the v2 sharded sync); by default counted in ``corpus``."""
    base = st.base
    samples = sampler.coherence(config.coherence_samples,
                                max(int(base.vocab_size), 1))
    if corpus_tokens is None:
        corpus_tokens = (st.corpus_tokens if config.frozen_freqs
                         else scoring.corpus_token_count(corpus))
    st = dataclasses.replace(
        st, coh_samples=samples.to(torch.int32), corpus=corpus,
        corpus_synced=base.num_merges.clone(), corpus_tokens=corpus_tokens,
        pair_keys=keys, pair_counts=counts, max_pair_count=max_count,
        pair_unique=n_unique)

    scores, dists = _score_table(st, config, keys, counts, st.coh_samples,
                                 max_count, corpus_tokens)
    if config.frozen_freqs:
        # Restored counts can carry historical pairs; a live corpus cannot
        # (replay removes every adjacency of a merged pair).
        nm = int(base.num_merges)
        consumed = scoring.in_sorted_pair_set(
            keys[:, 0], keys[:, 1], *_sorted_history(base.merges[:nm]), nm)
        scores = torch.where(consumed[None, :], -INF, scores)

    k = config.queue_size
    top_vals, top_pos = scoring.top_k_desc(scores, k)
    if not config.use_hierarchical:
        # Without the curriculum the three phase queues are one.
        top_vals = top_vals.expand(3, k).contiguous()
        top_pos = top_pos.expand(3, k)
    stored = top_vals > -INF
    # A stored entry is a candidate, so its key is no sentinel.
    top_keys = keys[top_pos]
    return dataclasses.replace(
        st,
        q_i=torch.where(stored, top_keys[..., 0], -1),
        q_j=torch.where(stored, top_keys[..., 1], -1),
        q_dist=torch.where(stored, dists[top_pos], INF),
        q_score=top_vals, q_valid_total=valid_totals(scores),
        needs_resync=torch.zeros_like(st.needs_resync))


def _sorted_history(pairs: torch.Tensor):
    """Merge-history pairs as lex-sorted (hi, lo) lanes."""
    order = torch.argsort((pairs[:, 0].long() << 32) | pairs[:, 1].long())
    return pairs[order, 0], pairs[order, 1]


# ------------------------------------------------------------------ chunk

NO_CURVATURE_STOP = 1 << 30


def _segment_end(sc: dict, m_budget: int, s_budget: int,
                 curv_stop: int) -> str:
    """Why a segment ended, from the scalars after it: the first halt
    condition that holds, else ``cap`` (it ran all its steps)."""
    for reason, hit in (("stopped", sc["stopped"]),
                        ("resync", sc["needs_resync"]),
                        ("merges", sc["num_merges"] >= m_budget),
                        ("steps", sc["step"] >= s_budget),
                        ("curvature", sc["num_merges"] >= curv_stop)):
        if hit:
            return reason
    return "cap"


def _halted(sc: dict, m_budget: int, s_budget: int, curv_stop: int) -> bool:
    return _segment_end(sc, m_budget, s_budget, curv_stop) != "cap"


def run_segment_plain(st: EnhancedState, config: EnhancedConfig,
                      m_budget: int, s_budget: int, curv_stop: int, sampler,
                      n_steps: int):
    """The plain version of the segment kernel: :func:`enhanced_step`
    looped until a halt condition holds or ``n_steps`` steps ran. The
    sampler is never drawn from inside a segment (it halts at curvature
    events)."""
    for _ in range(n_steps):
        if _halted(state_scalars(st), m_budget, s_budget, curv_stop):
            break
        st = enhanced_step(st, config, sampler)
    return st


def run_segment(st: EnhancedState, config: EnhancedConfig, m_budget: int,
                s_budget: int, curv_stop: int, sampler, n_steps: int,
                plain: bool = False, counts=None):
    """A segment on the state's own device: kernel K1 or K2 on the card
    (``enhanced_loop.run_segment_cuda``), their plain version on the CPU,
    or everywhere when ``plain`` is asked for (the oracle of
    ``evals/selfcheck.py``). ``counts``: the kernel's; the plain version
    counts its own."""
    if plain or st.base.emb.device.type == "cpu":
        return run_segment_plain(st, config, m_budget, s_budget, curv_stop,
                                 sampler, n_steps)
    return enhanced_loop.run_segment_cuda(st, config, m_budget, s_budget,
                                          curv_stop, n_steps, counts=counts)


def run_chunk(st: EnhancedState, config: EnhancedConfig, n_steps: int,
              sampler, plain: bool = False,
              sync=None) -> tuple[EnhancedState, dict]:
    """One sync, then segments until ``n_steps`` merges, a resync, a stop or
    the step budget (``n_steps + 1024`` steps), with the curvature Adam
    step between segments when one is due (the JAX package's
    ``ops/pallas/enhanced_loop._run_chunk_fused``). Returns the state and
    the scalars last read (:func:`state_scalars`: once after the sync, once
    after each segment). ``plain`` runs the plain version on any device;
    ``sync`` replaces :func:`sync_corpus` (the sharded syncs of
    ``parallel/sharded.py``, same arguments). Raises if a segment leaves
    the step counter unchanged without halting, so that neither a kernel
    nor a curvature step that fails to advance loops forever. Spans:
    ``sync`` (the sync and the read that waits for it), ``segment.wait``
    (the read after each segment); counters ``segment.end.<reason>``
    (:func:`_segment_end`) and, while tracing, K2's ``merge.dense`` and
    ``threshold.empty_growth`` (the plain version counts its own)."""
    with metrics.span("sync"):
        st = (sync or sync_corpus)(st, config, sampler)
        sc = state_scalars(st)
    m_budget = sc["num_merges"] + n_steps
    s_budget = sc["step"] + n_steps + 1024
    freq = config.curvature_freq if config.use_adaptive_curvature else 0
    while not _halted(sc, m_budget, s_budget, NO_CURVATURE_STOP):
        curv_stop = NO_CURVATURE_STOP
        if freq > 0:
            if sc["num_merges"] // freq > sc["curv_last"] // freq:
                st = _maybe_update_curvature(st, config, sampler)
                sc["curv_last"] = int(st.curv_last)
            curv_stop = (sc["curv_last"] // freq + 1) * freq
        tracing = metrics.tracing()
        counts = None
        if tracing and config.uses_dense and not plain and \
                st.base.emb.device.type == "cuda":
            counts = torch.zeros((2,), dtype=torch.int32,
                                 device=st.base.emb.device)
        st = run_segment(st, config, m_budget, s_budget, curv_stop, sampler,
                         enhanced_loop.SEGMENT_STEPS, plain, counts)
        with metrics.span("segment.wait"):
            now = state_scalars(st)
        if tracing:
            metrics.count("segment.end." + _segment_end(
                now, m_budget, s_budget, curv_stop))
            if counts is not None:
                dense_merges, growths = counts.tolist()
                metrics.count("merge.dense", dense_merges)
                metrics.count("threshold.empty_growth", growths)
        if now["step"] == sc["step"] and not (now["stopped"]
                                              or now["needs_resync"]):
            raise RuntimeError(
                f"merge segment made no progress at step {now['step']} "
                f"(merges {now['num_merges']}): the kernel did not advance")
        sc = now
    return st, sc


def run_enhanced(st: EnhancedState, config: EnhancedConfig, n_steps: int,
                 sampler, sync=None) -> tuple[EnhancedState, int]:
    """One chunk: merge up to ``n_steps`` tokens, re-syncing the corpus
    statistics as often as the candidate queues demand.

    Returns the state and the number of syncs the chunk took. Each sync is
    followed by kernel segments on the card, or by the plain step loop for a
    state on the CPU (:func:`run_chunk`). ``sync`` replaces
    :func:`sync_corpus` (the sharded syncs, ``parallel/sharded.py``).
    Counters: ``sync.opening`` for the first sync, ``sync.resync.<reason>``
    for each resync (:func:`_resync_reason`), and ``sync.phase<n>`` for
    each sync by the phase of its merge count (:func:`_phase_index`).
    """
    if config.uses_dense and bool(st.base.best_dist[0] == -INF):
        raise ValueError(
            "dense candidate channel requested but best_dist is poisoned: "
            "this state was built for corpus-only training, which never "
            "maintains the dense-candidate arrays. Keep "
            "use_dense_channel=False with a corpus.")
    remaining = n_steps
    before = int(st.base.num_merges)
    rounds = 0
    while True:
        if metrics.tracing():
            metrics.count(_resync_reason(st, config, before) if rounds
                          else "sync.opening")
            metrics.count(f"sync.phase{_phase_index(config, before) + 1}")
        st, sc = run_chunk(st, config, remaining, sampler, sync=sync)
        rounds += 1
        remaining -= sc["num_merges"] - before
        before = sc["num_merges"]
        if remaining <= 0 or sc["stopped"]:
            break
        if not sc["needs_resync"]:
            break  # candidate drought / step cap: the caller decides
    return st, rounds


def _resync_reason(st: EnhancedState, config: EnhancedConfig,
                   num_merges: int) -> str:
    """The counter of a resync at ``num_merges`` merges: ``truncated`` when
    the current phase's queue held the top ``queue_size`` of more valid
    pairs, else ``spent``. One read of the device and no kernel: the phase
    is the merge count's, as ``enhanced_step`` sets it."""
    pidx = _phase_index(config, num_merges)
    truncated = int(st.q_valid_total[pidx]) > config.queue_size
    return f"sync.resync.{'truncated' if truncated else 'spent'}"


def _phase_index(config: EnhancedConfig, num_merges: int) -> int:
    """The phase (0-2) of a step at ``num_merges`` merges, as
    ``enhanced_step`` sets it; 0 without the curriculum."""
    if not config.use_hierarchical:
        return 0
    return (int(num_merges >= config.phase2_step)
            + int(num_merges >= config.phase3_step))


def state_scalars(st: EnhancedState) -> dict:
    """The loop-control scalars, read to the host in one transfer."""
    names = ("vocab_size", "num_merges", "step", "stopped")
    vals = torch.stack([getattr(st.base, n).to(torch.int64) for n in names]
                       + [st.needs_resync.to(torch.int64),
                          st.curv_last.to(torch.int64)]).tolist()
    return dict(zip(names + ("needs_resync", "curv_last"), vals))

