"""The plain reference of corpus-scored merge training, in PyTorch.

It states what a corpus-only training of the hyperbolic tokenizer owes
(HypTokenizer's ``EnhancedHyperbolicTokenizer`` with its dense channel off,
as this repository's README and ``bench.py`` run it):

* a *sync* replays the merges made since the last one onto the
  character-id corpus in rank order (classic BPE: the lowest-ranked rule
  first, overlapping equal pairs from the left), counts the adjacent pairs
  (the lexicographically first ``freq_table_size`` of them), scores each as
  ``alpha / (1 + d) + beta * log1p(f) / log1p(f_max) + gamma * coherence``
  at the curvature in force, and queues the ``queue_size`` best, ties to
  the lexicographically first pair;
* merges are taken from the head of the queue, each pair once, until the
  next sync; a merged token's point is the geodesic point of its parents at
  ``len_j / (len_i + len_j)``, re-projected onto the sheet of the
  curvature in force; its string is its parents' strings joined;
* every ``curvature_freq`` merges one Adam step moves the curvature on a
  hierarchy and distortion loss over the last 100 merges and random ids;
* when each sync and each curvature step falls is :func:`schedule`'s, from
  the recipe and the lengths of the queues alone.

:func:`judge` follows a training the program made: it reads the draws from
the benchmark's sampler log (the benchmark hands the program its draws),
holds the log's syncs and curvature steps to :func:`schedule`, recomputes
every queue, point and curvature step itself from the inputs and the
program's merge history, and measures how far the program's outputs lie
from what it owes. :func:`train` runs the same mathematics and schedule as
a trainer of its own, in any dtype; in bfloat16 it is the control that the
comparison must fail.

Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import geometry as G

PAD_ID = -1
BIG = 2 ** 62
GAP_UNOWED = 1e9   # a merge that no queue offered, or a schedule not owed
COHERENCE_BLOCK = 4096


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The corpus-only recipe's numbers (a configuration file's keys)."""

    alpha: float
    beta: float
    gamma: float
    merge_batch: int
    queue_size: int
    freq_table_size: int
    min_pair_freq: int
    max_token_len: int
    merge_threshold: float
    threshold_growth_every: int
    threshold_growth: float
    curvature_freq: int
    curvature_lr: float
    hierarchy_weight: float
    distortion_weight: float
    hier_pairs: int
    hier_negatives: int
    distortion_samples: int
    coherence_samples: int
    log_every: int
    steps: int
    target_vocab_size: int
    max_vocab_size: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Recipe":
        return cls(**{f.name: cfg[f.name] for f in dataclasses.fields(cls)})


# ------------------------------------------------------------------ corpus

def _shift_left(x, fill):
    return torch.cat([x[1:], x.new_full((1,), fill)])


def _shift_right(x, fill):
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def _compact(c: torch.Tensor) -> torch.Tensor:
    live = c[c != PAD_ID]
    out = torch.full_like(c, PAD_ID)
    out[:live.shape[0]] = live
    return out


def replay(corpus: torch.Tensor, pairs: torch.Tensor, first_id: int
           ) -> torch.Tensor:
    """Apply the rules ``pairs`` (ranked in order; rule k makes id
    ``first_id + k``) to the corpus in rank order: each round merges every
    position whose rank is no larger than both neighbours' (the leftmost
    of a run of equal overlapping pairs, then every other one), until no
    rule matches."""
    if pairs.shape[0] == 0:
        return corpus
    keys = (pairs[:, 0].long() << 32) | pairs[:, 1].long()
    ids = first_id + torch.arange(pairs.shape[0], device=corpus.device)
    keys, order = torch.sort(keys, stable=True)
    ids = ids[order]
    idx = torch.arange(corpus.shape[0], device=corpus.device)
    c = corpus
    while True:
        nxt = _shift_left(c, PAD_ID)
        ok = (c >= 0) & (nxt >= 0)
        q = (c.long() << 32) | (nxt.long() & 0xFFFFFFFF)
        pos = torch.clamp_max(torch.searchsorted(keys, q), keys.shape[0] - 1)
        hit = ok & (keys[pos] == q)
        if not bool(hit.any()):
            return c
        rank = torch.where(hit, ids[pos], torch.full_like(pos, BIG))
        alive, take_all = hit, torch.zeros_like(hit)
        while bool(alive.any()):
            p = torch.where(alive, rank, torch.full_like(rank, BIG))
            cand = (alive & (p <= _shift_right(p, BIG))
                    & (p <= _shift_left(p, BIG)))
            head = cand & ~_shift_right(cand, False)
            last_head = torch.cummax(torch.where(head, idx, -1), 0).values
            take = cand & ((idx - last_head) % 2 == 0)
            take_all |= take
            alive &= ~(take | _shift_right(take, False)
                       | _shift_left(take, False))
        out = torch.where(take_all, rank.to(c.dtype), c)
        out = torch.where(_shift_right(take_all, False),
                          torch.full_like(out, PAD_ID), out)
        c = _compact(out)


def pair_table(corpus: torch.Tensor, size: int):
    """The lexicographically first ``size`` distinct adjacent pairs as
    int64 keys ``hi << 32 | lo``, their counts, and the count of every
    distinct pair."""
    nxt = _shift_left(corpus, PAD_ID)
    ok = (corpus >= 0) & (nxt >= 0)
    keys = (corpus[ok].long() << 32) | nxt[ok].long()
    uniq, cnt = torch.unique(keys, sorted=True, return_counts=True)
    return uniq[:size], cnt[:size], int(uniq.shape[0])


# ------------------------------------------------------------------ scores

def gram_bound(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A bound on the rounding of a float32 Minkowski gram of ``d1``
    products: ``gamma_d1 * sum_e |x_e y_e|`` (gamma_n = n u / (1 - n u),
    u = 2^-24), in float64."""
    n = x.shape[-1]
    u = 2.0 ** -24
    return (n * u / (1 - n * u)) * (x.double() * y.double()).abs().sum(-1)


def candidates(rec: Recipe, keys, counts, lengths) -> torch.Tensor:
    """The table pairs that may be merged: seen at least ``min_pair_freq``
    times, and no longer than ``max_token_len`` once joined."""
    rows, cols = keys >> 32, keys & 0xFFFFFFFF
    return (counts >= rec.min_pair_freq) & (
        lengths[rows] + lengths[cols] <= rec.max_token_len)


def scores(rec: Recipe, keys, counts, emb, lengths, c, threshold, samples,
           dtype=torch.float32, bounds: bool = False):
    """Each table pair's score in ``dtype``; -inf where it may not be
    merged (rarer than ``min_pair_freq``, or longer than
    ``max_token_len``). With ``bounds``, also the least and the most the
    score can be when the pair's gram is anywhere within its float32
    rounding (:func:`gram_bound`): a pair of nearly equal points far from
    the origin, a self-pair above all, has a distance that float32 does not
    resolve, and its distance term is only known to that interval."""
    rows, cols = keys >> 32, keys & 0xFFFFFFFF
    e = emb.to(dtype)
    c = torch.as_tensor(c, dtype=dtype, device=emb.device)
    d = G.distance(e[rows], e[cols], c)
    f = counts.to(dtype)
    f_max = torch.clamp_min(counts.max() if counts.numel() else
                            counts.new_zeros(()), 1).to(dtype)
    freq = torch.log1p(f) / torch.clamp_min(torch.log1p(f_max), 1e-9)
    coh = torch.zeros_like(d)
    if rec.gamma:
        lr, lc = lengths[rows].to(dtype), lengths[cols].to(dtype)
        w = lc / torch.clamp_min(lr + lc, 1)
        s = samples.long()
        pts = e[s]
        parts = []
        for lo in range(0, rows.shape[0], COHERENCE_BLOCK):
            sl = slice(lo, lo + COHERENCE_BLOCK)
            mid = G.geodesic_point(e[rows[sl]], e[cols[sl]], w[sl])
            dm = G.pairwise_distance(mid, pts, c, eps=G.GRAD_EPS)
            other = ((s[None, :] != rows[sl, None])
                     & (s[None, :] != cols[sl, None]))
            n = torch.clamp_min(other.sum(1), 1).to(dtype)
            avg = torch.where(other, dm, torch.zeros_like(dm)).sum(1) / n
            parts.append(1.0 / (1.0 + torch.exp(avg - threshold)))
        coh = torch.cat(parts) if parts else coh
    sc = rec.alpha / (1.0 + d) + rec.beta * freq + rec.gamma * coh
    ok = candidates(rec, keys, counts, lengths)
    sc = torch.where(ok, sc, torch.full_like(sc, -torch.inf))
    if not bounds:
        return sc
    x, y = e[rows].double(), e[cols].double()
    g = G.mdot(x, y)
    b = gram_bound(e[rows], e[cols])
    rc = torch.sqrt(c.double())
    d_lo = G.acosh(torch.clamp_min(g - b, 1.0)) / rc
    d_hi = G.acosh(torch.clamp_min(g + b, 1.0)) / rc
    d = d.double()
    lo = sc.double() - rec.alpha * (1.0 / (1.0 + d) - 1.0 / (1.0 + d_hi))
    hi = sc.double() + rec.alpha * (1.0 / (1.0 + d_lo) - 1.0 / (1.0 + d))
    return sc, lo, hi


def queue(sc: torch.Tensor, size: int) -> torch.Tensor:
    """Table positions of the ``size`` best scores, best first, ties to the
    lowest position; no -inf entry."""
    order = torch.sort(sc, descending=True, stable=True).indices[:size]
    return order[sc[order] > -torch.inf]


def queue_shape(rec: Recipe, ok: torch.Tensor) -> tuple:
    """What :func:`schedule` is sent after a sync: the queue's length and
    whether the table held more candidates (``ok``) than the queue."""
    total = int(ok.sum())
    return min(total, rec.queue_size), total > rec.queue_size


def schedule(rec: Recipe, n0: int):
    """The events that a training owes, in order, from the recipe and the
    lengths of its queues alone: it yields ``("coherence", p)`` for a sync
    at ``p`` merges (and is sent :func:`queue_shape` of the queue that the
    sync built), ``("curvature", p)`` for a curvature step, and last
    ``("end", p)``.

    A chunk of ``log_every`` merges (the last one up to ``steps``) starts
    with a sync. Steps take the queue's head ``merge_batch`` at a time, and
    a chunk ends at the first step end at or past its budget. A step first
    takes the curvature step owed once the count has passed a multiple of
    ``curvature_freq`` since the last one, then resyncs when merges were
    made since the last sync and the queue is spent, or holds fewer than
    ``merge_batch`` while candidates were left out of it. A chunk whose
    sync finds nothing ends with no merge. Two such chunks in a row, the
    last chunk, the target vocabulary reached at a chunk's start, or full
    slots end the training."""
    nb = max(1, rec.merge_batch)
    freq = rec.curvature_freq
    cap = rec.max_vocab_size
    p = curv_last = zero = 0
    for j in range(-(-rec.steps // rec.log_every)):
        if n0 + p >= rec.target_vocab_size:
            break
        start = p
        budget = min(rec.log_every, rec.steps - j * rec.log_every)
        size, over = yield ("coherence", p)
        synced = p
        while p < start + budget:
            if freq > 0 and p // freq > curv_last // freq:
                yield ("curvature", p)
                curv_last = p
            left = size - (p - synced)
            if p > synced and (left == 0 or (over and left < nb)):
                size, over = yield ("coherence", p)
                synced = p
                continue
            k = min(nb, left, cap - n0 - p)
            if k <= 0:
                break
            p += k
        zero = zero + 1 if p == start else 0
        if zero >= 2 or n0 + p >= cap:
            break
    yield ("end", p)


def threshold_at(rec: Recipe, merges: int) -> float:
    """The merge threshold after ``merges`` merges (grown once at every
    multiple of ``threshold_growth_every``, in float32)."""
    t = np.float32(rec.merge_threshold)
    for _ in range(merges // rec.threshold_growth_every):
        t = np.float32(min(t * np.float32(rec.threshold_growth), 1e6))
    return float(t)


# --------------------------------------------------------------- curvature

def curvature_loss(rec: Recipe, emb, merges, nm: int, negs, ii, jj, c):
    """The hierarchy-preservation and distortion loss at curvature ``c``:
    the last ``hier_pairs`` merges held closer than random ids by a margin
    of 0.1, and pairwise distances kept from collapsing."""
    hp = rec.hier_pairs
    dev = emb.device
    idx = torch.arange(hp, device=dev)
    take = torch.minimum(max(nm - hp, 0) + idx,
                         torch.tensor(max(nm - 1, 0), device=dev))
    valid = idx < min(nm, hp)
    pi, pj = merges[take, 0], merges[take, 1]
    xi, xj = emb[pi], emb[pj]
    pair_d = G.distance(xi, xj, c, eps=G.GRAD_EPS)
    ne = emb[negs]
    d_i = G.distance(xi[:, None, :], ne, c, eps=G.GRAD_EPS)
    d_j = G.distance(xj[:, None, :], ne, c, eps=G.GRAD_EPS)
    other = (negs != pi[:, None]) & (negs != pj[:, None])
    zero = torch.zeros((), dtype=emb.dtype, device=dev)
    h = sum(torch.where(other, torch.relu(pair_d[:, None] - d + 0.1),
                        zero).sum(1) for d in (d_i, d_j))
    per_pair = h / torch.clamp_min(other.sum(1), 1)
    hier = (torch.where(valid, per_pair, zero).sum()
            / (2 * max(int(valid.sum()), 1)))
    dd = G.distance(emb[ii], emb[jj], c, eps=G.GRAD_EPS)
    keep = ii != jj
    n = max(int(keep.sum()), 1)
    mean = torch.where(keep, dd, zero).sum() / n
    var = torch.where(keep, (dd - mean) ** 2, zero).sum() / n
    distortion = torch.exp(-10.0 * mean) + 0.1 * var
    return rec.hierarchy_weight * hier + rec.distortion_weight * distortion


class CurvatureAdam:
    """Adam on the curvature (0.9, 0.999, 1e-8), clamped to [0.1, 10]."""

    def __init__(self, rec: Recipe, c0: float, device, dtype=torch.float32):
        self.rec = rec
        self.c = torch.tensor(c0, dtype=dtype, device=device)
        self.m = torch.zeros((), dtype=dtype, device=device)
        self.v = torch.zeros((), dtype=dtype, device=device)
        self.t = 0

    def step(self, emb, merges, nm: int, draws) -> None:
        negs, ii, jj = (d.long() for d in draws)
        with torch.enable_grad():
            c = self.c.detach().clone().requires_grad_(True)
            g = torch.autograd.grad(
                curvature_loss(self.rec, emb.to(c.dtype), merges, nm, negs,
                               ii, jj, c), c)[0]
        self.t += 1
        self.m = 0.9 * self.m + 0.1 * g
        self.v = 0.999 * self.v + 0.001 * g * g
        t = torch.tensor(float(self.t), dtype=self.c.dtype,
                         device=self.c.device)
        mhat = self.m / (1 - torch.pow(torch.tensor(0.9, dtype=t.dtype,
                                                    device=t.device), t))
        vhat = self.v / (1 - torch.pow(torch.tensor(0.999, dtype=t.dtype,
                                                     device=t.device), t))
        self.c = torch.clamp(self.c - self.rec.curvature_lr * mhat
                             / (torch.sqrt(vhat) + 1e-8), 0.1, 10.0)


def merged_points(emb, lengths, pairs, c, dtype=torch.float32):
    """The points of merged pairs whose parents exist already, re-projected
    onto the sheet of curvature ``c``."""
    e = emb.to(dtype)
    li, lj = lengths[pairs[:, 0]], lengths[pairs[:, 1]]
    w = (lj.to(dtype) / torch.clamp_min(li + lj, 1).to(dtype))
    x = G.geodesic_point(e[pairs[:, 0]], e[pairs[:, 1]], w)
    return G.project(x, torch.as_tensor(c, dtype=dtype, device=emb.device))


# -------------------------------------------------------------------- judge

def judge(rec: Recipe, corpus0: torch.Tensor, emb0: torch.Tensor,
          lengths0: List[int], vocab0: List[str], out: Dict,
          log: List[tuple]) -> Dict[str, float]:
    """Follow one training and measure its outputs.

    ``out``: the program's ``merges`` ((n, 2) ids), ``emb`` (its rows, at
    least ``n0 + n``), ``curvature`` (final) and ``vocab`` (its strings).
    ``log``: the benchmark sampler's calls in order, ``("coherence", V,
    samples)`` at each sync and ``("curvature", V, (negs, ii, jj))`` at
    each curvature step, V the vocabulary size at the call.

    Returns the numbers compared: ``merge_score_gap`` (the widest amount by
    which a merge's score lies below the best that its sync's queue still
    offered, each score taken at the end of its float32 interval that
    favours the program, :func:`scores`; ``GAP_UNOWED`` for a merge that
    no queue offered, and for a log whose syncs and curvature steps are
    not :func:`schedule`'s, a curvature step or a sync left out, added or
    moved, or a training that ends elsewhere), ``point_gap`` (the widest coordinate gap of a row,
    over the row's largest coordinate or 1), ``curvature_gap`` (relative),
    ``vocab_mismatch`` (merged strings that are not their parents
    joined), ``repeated_merges`` and ``unmerged_pairs`` (pairs that the
    corpus still holds when the training stopped short of its target)."""
    dev = corpus0.device
    n0 = len(vocab0)
    merges = out["merges"].to(dev).long()
    n = merges.shape[0]
    prog = out["emb"][:n0 + n].to(dev).float()
    made = n0 + torch.arange(n, device=dev)[:, None]
    known = ((merges >= 0) & (merges < made)).all(1)
    emb = torch.zeros((n0 + n, emb0.shape[1]), device=dev)
    emb[:n0] = emb0
    lengths = torch.zeros((n0 + n,), dtype=torch.long, device=dev)
    lengths[:n0] = torch.as_tensor(lengths0, device=dev)
    mm = torch.where(known[:, None], merges, torch.zeros_like(merges))
    lengths = _lengths(lengths, mm, n0)
    adam = CurvatureAdam(rec, 1.0, dev)
    corpus = corpus0
    done = 0           # rows computed for merges [0, done)
    last = None        # (prefix, queue, table keys, scores, least, most)
    gap = 0.0

    def rows_to(p):
        nonlocal done
        p = min(p, n)
        if p > done:
            emb[n0 + done:n0 + p] = merged_points(emb, lengths, mm[done:p],
                                                  adam.c)
            done = p

    def judge_window(p_end):
        nonlocal gap
        if last is None:
            return
        p0, qpos, keys, sc, lo, hi = last
        picks = merges[p0:min(p_end, n)]
        if picks.shape[0] == 0:
            return
        pk = (picks[:, 0] << 32) | (picks[:, 1] & 0xFFFFFFFF)
        if keys.numel():
            at = torch.clamp_max(torch.searchsorted(keys, pk),
                                 keys.shape[0] - 1)
            found = ((keys[at] == pk) & (sc[at] > -torch.inf)).cpu().numpy()
            p_hi = hi[at].cpu().numpy()
            at = at.cpu().numpy()
        else:
            found = np.zeros(pk.shape[0], bool)
            p_hi = at = np.zeros(pk.shape[0], np.int64)
        slot = np.full(keys.shape[0], -1, np.int64)   # table row -> queue
        slot[qpos.cpu().numpy()] = np.arange(qpos.shape[0])
        q_lo = lo[qpos].cpu().numpy()
        taken = np.zeros(qpos.shape[0], bool)
        # The best the queue still offers is the largest least-score of
        # its untaken entries (an entry's least score is below its score).
        best = [(-v, i) for i, v in enumerate(q_lo)]
        heapq.heapify(best)
        for t in range(picks.shape[0]):
            while best and taken[best[0][1]]:
                heapq.heappop(best)
            if not best or not found[t]:
                gap = GAP_UNOWED
                continue
            gap = max(gap, -best[0][0] - p_hi[t])
            s = slot[at[t]]
            if s >= 0:
                taken[s] = True

    p_sync = 0
    # The log has to be the schedule that the recipe owes, event for event.
    owed_events = schedule(rec, n0)
    owed = next(owed_events)
    consistent = True
    for kind, v, draws in log:
        p = v - n0
        consistent = consistent and owed == (kind, p)
        if not p_sync <= p <= n:   # a log that the history cannot have made
            consistent = False
            p = min(max(p, p_sync), n)
        if kind == "coherence":
            draws = torch.clamp_max(draws, n0 + p - 1)
            judge_window(p)
            rows_to(p)
            corpus = replay(corpus, mm[p_sync:p], n0 + p_sync)
            keys, counts, _ = pair_table(corpus, rec.freq_table_size)
            sc, lo, hi = scores(rec, keys, counts, emb[:n0 + p],
                                lengths[:n0 + p], adam.c,
                                threshold_at(rec, p), draws, bounds=True)
            last = (p, queue(sc, rec.queue_size), keys, sc, lo, hi)
            p_sync = p
            if consistent:
                owed = owed_events.send(queue_shape(rec, sc > -torch.inf))
        else:
            rows_to(p)
            draws = [torch.clamp_max(d, n0 + p - 1) for d in draws]
            adam.step(emb[:n0 + p], mm, p, draws)
            if consistent:
                owed = next(owed_events)
    judge_window(n)
    rows_to(n)
    corpus = replay(corpus, mm[p_sync:n], n0 + p_sync)
    # Syncs owed where the history ends change nothing and may be left
    # out; then the training has to end where the history does.
    keys, counts, _ = pair_table(corpus, rec.freq_table_size)
    while consistent and owed == ("coherence", n):
        owed = owed_events.send(queue_shape(
            rec, candidates(rec, keys, counts, lengths)))
    consistent = consistent and owed == ("end", n)
    nxt = _shift_left(corpus, PAD_ID)
    live = (corpus >= 0) & (nxt >= 0)
    lengths_c = torch.where(live, lengths[corpus.clamp_min(0).long()]
                            + lengths[nxt.clamp_min(0).long()], 0)
    left = int((live & (lengths_c <= rec.max_token_len)).sum())
    if (n0 + n >= min(rec.target_vocab_size, rec.max_vocab_size)
            or n >= rec.steps):
        left = 0

    scale = torch.clamp_min(emb.abs().amax(1), 1.0)
    point_gap = (float(((prog - emb).abs().amax(1) / scale).max())
                 if n0 + n else 0.0)
    if not bool(known.all()):
        point_gap = GAP_UNOWED
    pairs_host = merges.cpu().numpy()
    strings = list(vocab0)
    bad = 0
    for t, (a, b) in enumerate(pairs_host):
        ok = 0 <= a < len(strings) and 0 <= b < len(strings)
        s = strings[a] + strings[b] if ok else None
        strings.append(s)
        if (s is None or t + n0 >= len(out["vocab"])
                or out["vocab"][n0 + t] != s):
            bad += 1
    if len(out["vocab"]) != n0 + n:
        bad += abs(len(out["vocab"]) - (n0 + n))
    seen = {(int(a), int(b)) for a, b in pairs_host}
    c_ref = float(adam.c)
    if not consistent:
        gap = GAP_UNOWED
    return {
        "merge_score_gap": float(gap),
        "point_gap": float(point_gap),
        "curvature_gap": abs(float(out["curvature"]) - c_ref) / c_ref,
        "vocab_mismatch": float(bad),
        "repeated_merges": float(n - len(seen)),
        "unmerged_pairs": float(left),
    }


def _lengths(lengths, merges, n0):
    """String lengths of every token: a merged token's is its parents'
    sum, filled in merge order."""
    out = lengths.cpu().numpy()
    pairs = merges.cpu().numpy()
    for t, (a, b) in enumerate(pairs):
        out[n0 + t] = out[a] + out[b]
    return torch.from_numpy(out).to(lengths.device)


# -------------------------------------------------------------------- train

def train(rec: Recipe, corpus0: torch.Tensor, emb0: torch.Tensor,
          lengths0: List[int], vocab0: List[str], sampler,
          dtype=torch.float32) -> Dict:
    """A training of its own by the same mathematics and
    :func:`schedule`, in ``dtype``: at each sync a fresh queue, between
    events the queue's head merged in order. Draws through ``sampler``
    (``coherence``, ``curvature``). Returns :func:`judge`'s ``out``."""
    dev = corpus0.device
    n0 = len(vocab0)
    cap = rec.max_vocab_size
    emb = torch.zeros((cap, emb0.shape[1]), dtype=dtype, device=dev)
    emb[:n0] = emb0.to(dtype)
    lengths = torch.zeros((cap,), dtype=torch.long, device=dev)
    lengths[:n0] = torch.as_tensor(lengths0, device=dev)
    merges = torch.full((cap, 2), -1, dtype=torch.long, device=dev)
    adam = CurvatureAdam(rec, 1.0, dev, dtype)
    corpus = corpus0
    nm = synced = head = 0
    q = torch.zeros((0,), dtype=torch.long, device=dev)
    events = schedule(rec, n0)
    kind, p = next(events)
    while True:
        if p > nm:   # the queue's next entries, up to the event
            pk = q[head:head + p - nm]
            pairs = torch.stack([pk >> 32, pk & 0xFFFFFFFF], dim=1)
            emb[n0 + nm:n0 + p] = merged_points(emb, lengths, pairs, adam.c,
                                                dtype)
            lengths[n0 + nm:n0 + p] = (lengths[pairs[:, 0]]
                                       + lengths[pairs[:, 1]])
            merges[nm:p] = pairs
            head += p - nm
            nm = p
        if kind == "end":
            break
        if kind == "coherence":
            samples = sampler.coherence(rec.coherence_samples, n0 + nm)
            corpus = replay(corpus, merges[synced:nm], n0 + synced)
            synced = nm
            keys, counts, _ = pair_table(corpus, rec.freq_table_size)
            sc = scores(rec, keys, counts, emb[:n0 + nm], lengths[:n0 + nm],
                        adam.c, threshold_at(rec, nm), samples, dtype)
            q, head = keys[queue(sc, rec.queue_size)], 0
            kind, p = events.send(queue_shape(rec, sc > -torch.inf))
        else:
            draws = sampler.curvature(rec.hier_pairs, rec.hier_negatives,
                                      rec.distortion_samples, n0 + nm)
            adam.step(emb[:n0 + nm], merges, nm, draws)
            kind, p = next(events)
    strings = list(vocab0)
    for a, b in merges[:nm].cpu().tolist():
        strings.append(strings[a] + strings[b])
    return {"merges": merges[:nm], "emb": emb[:n0 + nm].float(),
            "curvature": float(adam.c), "vocab": strings}
