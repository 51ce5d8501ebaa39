"""The plain reference of the Quick start's all-features training, in
PyTorch.

It states what a training of HypTokenizer's ``EnhancedHyperbolicTokenizer``
with every feature on owes, as this repository's README Quick start runs it
(``train_enhanced_tokenizer`` at its defaults, after an RSGD pretraining):

* a *sync* replays the merges made since the last one onto the corpus in
  rank order (:func:`corpus_training.replay`), counts the adjacent pairs
  (the lexicographically first ``freq_table_size``) and scores each pair
  once per hierarchical phase: the weight cascade of frequency (distance,
  log-frequency, coherence), compression (``comp_w`` of the token total's
  gain, the others scaled by ``1 - comp_w``) and morphology (``morph_w`` of
  the phase's morphology score, the others scaled by ``1 - morph_w``); each
  phase queues its ``queue_size`` best, ties to the first pair;
* the *dense channel* proposes, at every step, the closest pair of the
  active vocabulary: for each row i the nearest row j > i whose pair was
  never merged and passes the length cap, and of those the least (lowest
  row on ties);
* a *step* takes the first ``merge_batch`` entries of the current phase's
  queue that are unconsumed and closer than the threshold, and, when the
  closest pair is closer than the threshold, that pair too, inserted at
  its score's rank among them (dense first on ties; a queue entry equal to
  it is left to the dense channel); a step that takes nothing counts an
  empty round. Merged pairs are consumed in all three queues; a merged
  token's point is the geodesic point of its parents at
  ``len_j / (len_i + len_j)``, re-projected at the curvature in force;
* the *dense channel's resync rule*: a step resyncs instead, once merges
  were made since the last sync, when its phase's table held more
  candidates than the queue and fewer than a batch of the queue are valid;
* the phase is 1, 2 or 3 by the merge count at the step's start
  (``phase2_step``, ``phase3_step``), and a new phase starts at its own
  threshold; the threshold grows by ``threshold_growth`` whenever a step
  crosses a multiple of ``threshold_growth_every`` merges, and by
  ``empty_growth`` after ``empty_growth_after`` empty rounds in a row (or,
  without adaptation, the training stops after ``empty_stop_after``);
* every ``curvature_freq`` merges one Adam step moves the curvature
  (:class:`corpus_training.CurvatureAdam`);
* when each of these falls is :func:`schedule`'s.

:func:`judge` follows a training the program made, from the benchmark
sampler's log, event by event, step by step: it rebuilds every sync's
queues, keeps each row's partners itself, and works out from the merge
history what each step merged. Every choice is judged on the rows the
program made, each distance at the end of its float32 interval that
favours the program (a gram of d+1 float32 products is known to
``gamma_{d+1} sum |x_e y_e|``; pairs at the acosh clamp floor are one
distance, so any of them is the closest); the rows themselves are held to
the reference's own merged points (``point_gap``) and the curvature to its
own Adam steps. The history does not say where one step ends and the next
begins, and where a distance's interval holds the threshold the rules
allow more than one reading of a step; a wrong one shows a few steps on
(a log event at another merge count, a merge no queue offers, a gap). So
the walk searches: it takes the readings with no gap first, the longest
first, keeps the others, and on a fault goes back to the newest kept
reading within ``WINDOW`` steps and takes it instead (at most ``TRIES``
times a fault, ``RESTORES`` in all); a fault no reading mends is the one
measured. Nothing the program records of its own choices is read.

The dense merge is held twice. ``dense_gap`` holds it to the least
distance among all active pairs, as the channel's design states;
``dense_held_gap`` to the nearest of the partners a row must still hold:
the tokenizer's column fold forgets a row's older partners once the pair
it tracks is merged, and with the curvature away from 1 a merged token's
re-projected point need not be its parent's nearest, so the program may
pass over an older, nearer pair. A step that no reading explains, and a
log one event off the schedule, read ``GAP_UNOWED``. :func:`train` is a
trainer of its own by the same rules; with a lower ``dtype`` it is the
control that the comparison must fail: its ranking (the queues' order, the
dense channel's choice) and its curvature and rows in that dtype, on the
float32 schedule.

Morphology is the published analysis (word counts, 2-5-grams at the 80th
and 70th percentiles, the prefix and suffix lists, frequent substrings of
common words; no WordNet lemmas), and a merged string's membership in its
sets is tested, as the tokenizer's design states, by the pair of 15-bit
polynomial hashes of its UTF-8 bytes. Imports nothing of the program.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference import corpus_training as R
from portbench.reference import geometry as G

GAP_UNOWED = R.GAP_UNOWED
# Why the last judge read GAP_UNOWED (None when it did not), and how its
# search went (readings kept, taken back, faults measured), for a reader.
last_unowed = None
last_search: Dict[str, int] = {}
WINDOW = 64                # steps back that a fault may be laid to
TRIES = 8                  # other readings tried for one fault
RESTORES = 128             # readings taken back in one walk
U32 = 2.0 ** -24           # float32's unit roundoff
SCORE_SLACK = 64 * U32     # float32 rounding of a score's other terms
BLOCK = 1 << 15            # pairs per block of a sync's coherence
FLOOR = 1.0                # float32's 1 + 1e-8: the distances' acosh clamp
GRAD_FLOOR = float(np.float32(1.0 + G.GRAD_EPS))   # the coherence's clamp

# The keys a training needs that the configuration file leaves to the
# constructor, at the constructor's defaults.
DEFAULTS = dict(
    max_token_len=512, threshold_growth_every=1000, threshold_growth=1.1,
    empty_growth_after=6, empty_growth=1.5, empty_stop_after=10,
    adaptive_threshold=True, morphology_weight=0.3,
    phase_thresholds=(0.05, 0.1, 0.2), coherence_samples=50,
    hier_pairs=100, hier_negatives=10, distortion_samples=500,
    target_vocab_size=None, corpus_shards=1)

PREFIXES = {"re", "un", "in", "im", "il", "ir", "dis", "en", "em", "non",
            "de", "pre", "pro", "mis"}
SUFFIXES = {"ing", "ed", "er", "est", "ly", "ity", "ment", "ness", "able",
            "ible", "al", "ial"}
WORD = re.compile(r"\b\w+\b")
VOWEL = re.compile(r"[aeiou]")
HASH_P = (32749, 32719)
HASH_B = (257, 263)
HASH_POWERS = 4096


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The all-features recipe's numbers."""

    alpha: float
    beta: float
    gamma: float
    compression_weight: float
    morphology_weight: float
    use_frequency_aware: bool
    use_compression_aware: bool
    use_hierarchical: bool
    use_adaptive_curvature: bool
    merge_batch: int
    queue_size: int
    freq_table_size: int
    min_pair_freq: int
    max_token_len: int
    merge_threshold: float
    phase2_step: int
    phase3_step: int
    phase_thresholds: tuple
    threshold_growth_every: int
    threshold_growth: float
    empty_growth_after: int
    empty_growth: float
    empty_stop_after: int
    adaptive_threshold: bool
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
    target_vocab_size: Optional[int]
    max_vocab_size: int
    corpus_shards: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Recipe":
        """From a configuration's keys, ``DEFAULTS`` for those it lacks;
        the queue is the constructor's: at most the table, at least a
        batch."""
        c = dict(DEFAULTS, **cfg)
        c["curvature_freq"] = (c["optimize_curvature_freq"]
                               if c["use_adaptive_curvature"] else 0)
        c["phase_thresholds"] = tuple(c["phase_thresholds"])
        c["queue_size"] = max(min(c["queue_size"], c["freq_table_size"]),
                              c["merge_batch"], 1)
        return cls(**{f.name: c[f.name] for f in dataclasses.fields(cls)})

    def weights(self):
        """(alpha, beta, gamma, comp_w, morph_w) after the cascade."""
        if self.use_frequency_aware:
            a, b, g = self.alpha, self.beta, self.gamma
        else:
            a, b, g = 0.7, 0.0, 0.0
        cw = mw = 0.0
        if self.use_compression_aware:
            cw = self.compression_weight
            a, b, g = a * (1 - cw), b * (1 - cw), g * (1 - cw)
        if self.use_hierarchical:
            mw = self.morphology_weight
            a, b, g = a * (1 - mw), b * (1 - mw), g * (1 - mw)
            cw *= 1 - mw
        return a, b, g, cw, mw


# ------------------------------------------------------------------ inputs

def shard_align(ids: np.ndarray, n_shards: int, pad: int = -1,
                sep: int = -2) -> np.ndarray:
    """The corpus laid out in ``n_shards`` equal buckets, each segment (up
    to and with its separator) whole in one bucket, in order; a segment
    that does not fit the rest of a bucket opens the next, one longer than
    a bucket is cut at bucket ends, and what fits in no bucket is left
    out."""
    n = ids.shape[0]
    if n_shards <= 1 or n % n_shards:
        return ids
    cap = n // n_shards
    live = ids[ids != pad]
    out = np.full((n,), pad, np.int32)
    bucket = fill = 0
    start = 0
    for end in list(np.flatnonzero(live == sep) + 1) + [live.shape[0]]:
        seg = live[start:end]
        start = end
        while seg.shape[0]:
            room = cap - fill
            if room == 0 or seg.shape[0] > room and seg.shape[0] <= cap:
                bucket, fill = bucket + 1, 0
                if bucket >= n_shards:
                    return out
                continue
            take = min(room, seg.shape[0])
            out[bucket * cap + fill:bucket * cap + fill + take] = seg[:take]
            fill += take
            seg = seg[take:]
    return out


def morphology(lines: List[str]) -> Tuple[set, set]:
    """(morpheme set, word set) of the corpus: the 2-5-grams of its words
    seen at least as often as the 80th percentile, the prefix and suffix
    lists and the 2-5-grams found in 5 or more common words; the words seen
    at least as often as the 70th percentile."""
    words: Counter = Counter()
    grams: Counter = Counter()
    for ln in lines:
        ws = WORD.findall(ln.lower())
        words.update(ws)
        for w in ws:
            for n in range(2, min(5, len(w)) + 1):
                grams.update(w[i:i + n] for i in range(len(w) - n + 1))
    common_m, common_w = set(), set()
    if grams:
        t = np.percentile(list(grams.values()), 80)
        common_m = {s for s, c in grams.items() if c >= t}
    if words:
        t = np.percentile(list(words.values()), 70)
        common_w = {w for w, c in words.items() if c >= t}
    inside: Counter = Counter()
    for w in common_w:
        inside.update({w[i:i + n] for n in range(2, 6)
                       for i in range(len(w) - n + 1)})
    frequent = {s for s, c in inside.items() if c >= 5}
    return common_m | PREFIXES | SUFFIXES | frequent, common_w


def str_hash(s: str) -> Tuple[int, int]:
    h1 = h2 = 0
    for ch in s.encode("utf-8"):
        h1 = (h1 * HASH_B[0] + ch) % HASH_P[0]
        h2 = (h2 * HASH_B[1] + ch) % HASH_P[1]
    return h1, h2


def hash_keys(strings, device) -> torch.Tensor:
    """The sorted hash keys ``h1 * 65536 + h2`` of a set of strings."""
    keys = sorted({a * 65536 + b for a, b in map(str_hash, strings)})
    return torch.tensor(keys, dtype=torch.int64, device=device)


class Tokens:
    """Per token: its string, character and byte length, hash pair and
    vowel bit, in ``cap`` slots; the morphology's key sets; the hash
    power tables."""

    def __init__(self, vocab0: List[str], morph: Tuple[set, set], device,
                 cap: int):
        self.dev = torch.device(device)
        self.strings = list(vocab0)
        self.f = torch.zeros((max(cap, len(vocab0)), 5), dtype=torch.int64,
                             device=self.dev)
        self.f[:len(vocab0)] = torch.tensor(
            [self._feat(s) for s in vocab0], dtype=torch.int64,
            device=self.dev).reshape(-1, 5)
        self.morph_keys = hash_keys(morph[0], self.dev)
        self.word_keys = hash_keys(morph[1], self.dev)
        self.morph_set = set(self.morph_keys.tolist())
        self.word_set = set(self.word_keys.tolist())
        pw = np.ones((2, HASH_POWERS), np.int64)
        for k in range(1, HASH_POWERS):
            pw[:, k] = pw[:, k - 1] * np.array(HASH_B) % np.array(HASH_P)
        self.powers = torch.from_numpy(pw).to(self.dev)

    @staticmethod
    def _feat(s: str):
        h1, h2 = str_hash(s)
        return [len(s), len(s.encode("utf-8")), h1, h2,
                int(bool(VOWEL.search(s)))]

    @property
    def lengths(self) -> torch.Tensor:
        """Character lengths of every slot (0 past the made tokens)."""
        return self.f[:, 0]

    def add(self, pairs: List[Tuple[int, int]]) -> None:
        new = [self.strings[a] + self.strings[b] for a, b in pairs]
        v = len(self.strings)
        self.strings.extend(new)
        if new:
            self.f[v:v + len(new)] = torch.tensor(
                [self._feat(s) for s in new], dtype=torch.int64,
                device=self.dev)

    def morph_scores(self, rows, cols) -> torch.Tensor:
        """(n, 3) float64 morphology score of each pair per phase: short
        parts; a known morpheme; a known word, or 3 or more characters with
        a vowel."""
        fi, fj = self.f[rows], self.f[cols]
        p1 = torch.where((fi[:, 0] <= 2) & (fj[:, 0] <= 2), 0.8, 0.2)
        k = torch.clamp_max(fj[:, 1], HASH_POWERS - 1)
        c1 = (fi[:, 2] * self.powers[0, k] + fj[:, 2]) % HASH_P[0]
        c2 = (fi[:, 3] * self.powers[1, k] + fj[:, 3]) % HASH_P[1]
        key = c1 * 65536 + c2
        p2 = torch.where(_member(key, self.morph_keys), 0.9, 0.3)
        word = _member(key, self.word_keys) | (
            (fi[:, 0] + fj[:, 0] >= 3) & ((fi[:, 4] | fj[:, 4]) > 0))
        p3 = torch.where(word, 1.0, 0.4)
        return torch.stack([p1, p2, p3], 1).double()


def _member(keys, table) -> torch.Tensor:
    if table.numel() == 0:
        return torch.zeros_like(keys, dtype=torch.bool)
    pos = torch.clamp_max(torch.searchsorted(table, keys), table.shape[0] - 1)
    return table[pos] == keys


# ---------------------------------------------------------------- geometry

def _gram(x, y):
    """Minkowski grams and sums of |x_e y_e| of paired rows (last axis)."""
    sig = G.signature(x.shape[-1], x)
    return (x * sig * y).sum(-1), (x * y).abs().sum(-1)


def _gram_matrix(x, y):
    """(n, m) Minkowski grams and sums of |x_e y_e|; no TF32."""
    sig = G.signature(x.shape[-1], x)
    return x @ (y * sig).T, x.abs() @ y.abs().T


def acosh_bounds(g, s, d1: int):
    """acosh of the least and the most that a float32 evaluation of a gram
    ``g`` (with ``s`` its sum of |products|) and of its acosh can give,
    clamped at 1, in float64."""
    n = d1 + 4
    eg = (n * U32 / (1 - n * U32)) * s + 2 * U32 * g.abs()
    return (G.acosh(torch.clamp_min(g - eg, FLOOR)),
            G.acosh(torch.clamp_min(g + eg, FLOOR)))


def pair_acosh(emb: np.ndarray, i: int, j: int):
    """(exact, least, most) acosh of the pair's gram, on the host."""
    x, y = emb[i], emb[j]
    p = x * y
    g = p[0] - p[1:].sum()
    s = np.abs(p).sum()
    n = x.shape[0] + 4
    eg = (n * U32 / (1 - n * U32)) * s + 2 * U32 * abs(g)
    return (float(np.arccosh(max(g, FLOOR))),
            float(np.arccosh(max(g - eg, FLOOR))),
            float(np.arccosh(max(g + eg, FLOOR))))


def geodesic(x, y, w):
    """The point at fraction ``w`` from ``x`` to ``y``
    (:func:`geometry.geodesic_point`), its distance clamped as float32
    clamps it: ``x`` itself wherever the gram is at most 1."""
    d = G.acosh(torch.clamp_min(G.mdot(x, y), FLOOR))
    w = torch.as_tensor(w, dtype=x.dtype, device=x.device)
    a, b = (1.0 - w) * d, w * d
    num_x = torch.exp(-b) * (1.0 - torch.exp(-2.0 * a))
    num_y = torch.exp(-a) * (1.0 - torch.exp(-2.0 * b))
    den = torch.clamp_min(1.0 - torch.exp(-2.0 * d), G.EPS_NORM)
    out = (num_x[..., None] * x + num_y[..., None] * y) / den[..., None]
    return torch.where((d < G.EXP_ZERO_TOL)[..., None], x, out)


# ------------------------------------------------------------------ scores

@dataclasses.dataclass
class Table:
    """A sync's pair table: sorted int64 keys and counts (and their copies
    on the host), the largest count, the live token total and whether
    more pairs are candidates than the queue holds."""

    keys: torch.Tensor
    counts: torch.Tensor
    f_max: int
    tokens: int
    truncated: bool

    def __post_init__(self):
        self.keys_host = self.keys.cpu().numpy()
        self.counts_host = self.counts.cpu().numpy()

    def count(self, a: int, b: int) -> int:
        """The pair's count in the table, 0 if absent."""
        k = (a << 32) | b
        pos = int(np.searchsorted(self.keys_host, k))
        return (int(self.counts_host[pos]) if pos < self.keys_host.shape[0]
                and self.keys_host[pos] == k else 0)


def candidate_mask(rec: Recipe, counts, lengths, rows, cols):
    return (counts >= rec.min_pair_freq) & (
        lengths[rows] + lengths[cols] <= rec.max_token_len)


def scores(rec: Recipe, tab: Table, rows, cols, counts, emb, toks: Tokens,
           c, thr: float, samples, dist, gate: bool = True
           ) -> torch.Tensor:
    """(n, 3) scores of the pairs (rows, cols) per phase in the dtype of
    ``emb``, at curvature ``c`` and threshold ``thr`` (the coherence's),
    with the sync's samples, counts, largest count and token total, and
    the pairs' distances ``dist``; with ``gate``, -inf where the pair may
    not be merged from the queue."""
    dt = emb.dtype
    dev = emb.device
    a, b, g, cw, mw = rec.weights()
    ct = torch.as_tensor(c, dtype=dt, device=dev)
    rc = torch.sqrt(ct)
    lengths = toks.lengths
    n = rows.shape[0]
    base = a / (1.0 + dist)
    if rec.use_frequency_aware:
        f = counts.to(dt)
        den = torch.clamp_min(torch.log1p(torch.as_tensor(
            float(max(tab.f_max, 1)), dtype=dt, device=dev)), 1e-9)
        base = base + b * (torch.log1p(f) / den)
        s = samples.long()
        pts = emb[s]
        li, lj = lengths[rows].to(dt), lengths[cols].to(dt)
        w = lj / torch.clamp_min(li + lj, 1)
        parts = []
        for lo in range(0, n, BLOCK):
            sl = slice(lo, lo + BLOCK)
            mid = geodesic(emb[rows[sl]], emb[cols[sl]], w[sl])
            gm, _ = _gram_matrix(mid, pts)
            dm = G.acosh(torch.clamp_min(gm, GRAD_FLOOR)) / rc
            other = ((s[None, :] != rows[sl, None])
                     & (s[None, :] != cols[sl, None]))
            cnt = torch.clamp_min(other.sum(1), 1).to(dt)
            avg = torch.where(other, dm, torch.zeros_like(dm)).sum(1) / cnt
            parts.append(1.0 / (1.0 + torch.exp(avg - thr)))
        if parts:
            base = base + g * torch.cat(parts)
    if rec.use_compression_aware:
        total = torch.as_tensor(float(max(tab.tokens, 1)), dtype=dt,
                                device=dev)
        ratio = total / torch.clamp_min(total - counts.to(dt), 1.0)
        base = base + cw * torch.clamp(ratio - 1.0, 0.0, 1.0)
    sc = base[:, None].expand(n, 3)
    if rec.use_hierarchical:
        sc = sc + mw * toks.morph_scores(rows, cols).to(dt)
    if not gate:
        return sc
    ok = candidate_mask(rec, counts, lengths, rows, cols)
    return torch.where(ok[:, None], sc, torch.full_like(sc, -torch.inf))


def score_bounds(rec: Recipe, sc, a_ex, a_lo, a_hi, c: float, rel: float):
    """The least and the most each score can be when its distance is
    anywhere within its interval (acosh values ``a_lo``-``a_hi`` around
    ``a_ex``, scaled by 1/sqrt(c) and widened by ``rel``), with
    ``SCORE_SLACK`` for the rest. Where the gram may lie on either side of
    1, the midpoint may be either parent's point or the geodesic one
    (:func:`geodesic`), and the coherence anything in [0, 1]."""
    alpha, _, gamma, _, _ = rec.weights()
    rc = c ** 0.5
    d = a_ex / rc
    d_lo, d_hi = a_lo * (1 - rel) / rc, a_hi * (1 + rel) / rc
    coh = gamma * ((a_lo == 0) & (a_hi > 0)).to(sc.dtype)
    if not rec.use_frequency_aware:
        coh = torch.zeros_like(coh)
    lo = sc - (alpha * (1 / (1 + d) - 1 / (1 + d_hi)) + coh)[..., None] \
        - SCORE_SLACK
    hi = sc + (alpha * (1 / (1 + d_lo) - 1 / (1 + d)) + coh)[..., None] \
        + SCORE_SLACK
    return lo, hi


# ---------------------------------------------------------------- schedule

def schedule(rec: Recipe, n0: int):
    """The events that a training owes, in order. It yields

    * ``("coherence", p, thr)``: a sync at ``p`` merges (at threshold
      ``thr``, which the coherence reads); sent nothing;
    * ``("phase", p, phase, thr)``: a step at ``p`` opens a new phase at
      its threshold;
    * ``("curvature", p)``: the curvature step, at the first step start
      past each multiple of ``curvature_freq``;
    * ``("step", p, phase, thr, consumed)``: a step, ``consumed`` whether
      merges were made since the last sync; it is sent ``"resync"`` when
      the step resyncs, else the number of merges it made;
    * ``("empty_growth", p, thr)`` and ``("growth", p, thr)``: the
      threshold's growth after empty rounds and at a multiple of
      ``threshold_growth_every``;
    * ``("end", p)``.

    A chunk of ``log_every`` merges (the last up to ``steps``) opens with a
    sync and runs steps until its merges reach the chunk's budget, a
    resync (after which a sync opens the rest of the chunk, with a step
    budget of the merges left plus 1024 from there) or the step budget; a
    chunk that merges nothing twice in a row, the target vocabulary at a
    chunk's start, full slots or a stop end the training."""
    cap = rec.max_vocab_size
    every = rec.threshold_growth_every
    freq = rec.curvature_freq
    thr = np.float32(rec.phase_thresholds[0] if rec.use_hierarchical
                     else rec.merge_threshold)
    p = step = empty = curv_last = zero = done = 0
    phase = 1
    stopped = False
    while done < rec.steps:
        if rec.target_vocab_size is not None and \
                n0 + p >= rec.target_vocab_size:
            break
        chunk = min(rec.log_every, rec.steps - done)
        start = p
        remaining = chunk
        while True:
            before = p
            yield ("coherence", p, float(thr))
            synced = p
            m_budget, s_budget = p + remaining, step + remaining + 1024
            resync = False
            while not (stopped or p >= m_budget or step >= s_budget):
                if rec.use_hierarchical:
                    ph = 1 + (p >= rec.phase2_step) + (p >= rec.phase3_step)
                    if ph != phase:
                        phase = ph
                        thr = np.float32(rec.phase_thresholds[ph - 1])
                        yield ("phase", p, phase, float(thr))
                if freq > 0 and p // freq > curv_last // freq:
                    yield ("curvature", p)
                    curv_last = p
                k = yield ("step", p, phase, float(thr), p > synced)
                if k == "resync":
                    resync = True
                    break
                prev = p
                if k > 0:
                    p += k
                    empty = 0
                else:
                    empty += 1
                    if rec.adaptive_threshold:
                        if empty >= rec.empty_growth_after:
                            thr = np.float32(min(thr * np.float32(
                                rec.empty_growth), 1e6))
                            empty = 0
                            yield ("empty_growth", p, float(thr))
                    elif empty >= rec.empty_stop_after:
                        stopped = True
                step += 1
                if rec.adaptive_threshold and every > 0 and \
                        p // every > prev // every:
                    thr = np.float32(min(thr * np.float32(
                        rec.threshold_growth), 1e6))
                    yield ("growth", p, float(thr))
                if n0 + p >= cap:
                    stopped = True
            remaining -= p - before
            if remaining <= 0 or stopped or not resync:
                break
        zero = zero + 1 if p == start else 0
        if zero >= 2:
            break
        done += chunk
        if stopped:
            break
    yield ("end", p)


# ------------------------------------------------------------------- state

class _Dense:
    """Each active row's nearest partner above it among the pairs that
    pass the length cap, kept as acosh values. ``exact`` (a trainer's):
    the nearest unmerged partner and its column, in the dtype of the rows.
    Else (the judge's), float64 ends of float32 intervals over all
    unmerged partners (``lo``, the least; ``top``, the most the least can
    be), and ``hi``, the most over the partners a row must still hold when
    it forgets its older ones once a pair of it is merged (the rows made
    since that step). New rows are folded into every row below them; a row
    one of whose pairs is merged is recomputed."""

    def __init__(self, emb, lengths, max_len: int, n: int, exact: bool):
        self.emb, self.lengths, self.max_len = emb, lengths, max_len
        self.exact = exact
        cap = emb.shape[0]
        dev = emb.device
        dt = emb.dtype if exact else torch.float64
        self.lo = torch.full((cap,), torch.inf, dtype=dt, device=dev)
        self.hi = self.lo.clone()
        self.top = self.lo.clone()
        self.best_j = torch.zeros((cap,), dtype=torch.long, device=dev)
        self.merged: Dict[int, List[int]] = {}
        self.since: Dict[int, int] = {}
        # (row, its ``since`` before) per merged pair, to take steps back.
        self.journal: List[Tuple[int, Optional[int]]] = []
        self.v = self.v0 = 0
        self.grow(n)

    def snapshot(self):
        return (self.lo.clone(), self.hi.clone(), self.top.clone(),
                self.best_j.clone(), len(self.journal), self.v, self.v0)

    def restore(self, snap) -> None:
        lo, hi, top, best_j, n_journal, self.v, self.v0 = snap
        for t, x in ((self.lo, lo), (self.hi, hi), (self.top, top),
                     (self.best_j, best_j)):
            t.copy_(x)
        while len(self.journal) > n_journal:
            a, since = self.journal.pop()
            self.merged[a].pop()
            if since is None:
                del self.since[a]
            else:
                self.since[a] = since

    def _take(self, rows, g, s, ok, held, fold: bool):
        """Minima of the pairs of ``rows`` with the grams' columns, over
        ``ok`` (``lo``, ``top``) and ``held`` (``hi``); folded in or
        replacing."""
        inf = torch.full_like(g, torch.inf)
        if self.exact:
            a = torch.where(ok, G.acosh(torch.clamp_min(g, FLOOR)), inf)
            val, arg = a.min(1)
            if fold:
                better = val < self.lo[rows]
                val = torch.where(better, val, self.lo[rows])
                arg = torch.where(better, arg + self.v0, self.best_j[rows])
            self.lo[rows], self.best_j[rows] = val, arg
            return
        lo, hi = acosh_bounds(g, s, self.emb.shape[1])
        top = torch.where(ok, hi, inf).min(1).values
        lo = torch.where(ok, lo, inf).min(1).values
        hi = torch.where(held, hi, inf).min(1).values
        if fold:
            lo = torch.minimum(lo, self.lo[rows])
            hi = torch.minimum(hi, self.hi[rows])
            top = torch.minimum(top, self.top[rows])
        self.lo[rows], self.hi[rows], self.top[rows] = lo, hi, top

    def grow(self, v: int, merged=()):
        """Rows [self.v, v) are new; ``merged`` pairs were merged in the
        step that made them."""
        dev = self.emb.device
        redo = sorted({a for a, b in merged if a < b})
        for a, b in merged:
            if a < b:
                self.journal.append((a, self.since.get(a)))
                self.merged.setdefault(a, []).append(b)
                self.since[a] = self.v
        if v > self.v:
            self.v0 = self.v
            new = torch.arange(self.v, v, device=dev)
            rows = torch.arange(v, device=dev)
            g, s = _gram_matrix(self.emb[:v], self.emb[self.v:v])
            ok = (rows[:, None] < new[None, :]) & (
                self.lengths[:v][:, None] + self.lengths[new][None, :]
                <= self.max_len)
            self.v = v
            self._take(rows, g, s, ok, ok, fold=True)
        if redo:
            rows = torch.tensor(redo, device=dev)
            g, s = _gram_matrix(self.emb[rows], self.emb[:v])
            col = torch.arange(v, device=dev)
            ok = (col[None, :] > rows[:, None]) & (
                self.lengths[rows][:, None] + self.lengths[:v][None, :]
                <= self.max_len)
            held = ok.clone()
            for k, r in enumerate(redo):
                ok[k, self.merged[r]] = False
                held[k, :self.since[r]] = False
            self._take(rows, g, s, ok, held, fold=False)

    def bounds(self):
        """(least acosh any row can hold, most the least held can be, most
        the least of all can be)."""
        return torch.stack([self.lo[:self.v].min(), self.hi[:self.v].min(),
                            self.top[:self.v].min()]).tolist()

    def argmin(self):
        """A trainer's nearest pair: (row, column, acosh), lowest row on
        ties."""
        i = int(torch.argmin(self.lo[:self.v]))
        return i, int(self.best_j[i]), self.lo[i]


def _sync_table(rec: Recipe, corpus, toks: Tokens):
    keys, counts, _ = R.pair_table(corpus, rec.freq_table_size)
    rows, cols = keys >> 32, keys & 0xFFFFFFFF
    ok = candidate_mask(rec, counts, toks.lengths, rows, cols)
    tab = Table(keys, counts, int(counts.max()) if counts.numel() else 0,
                int((corpus >= 0).sum()), int(ok.sum()) > rec.queue_size)
    return tab, rows, cols


def _geodesic_host(x, y, w):
    """:func:`geodesic` of two rows, in numpy float64."""
    g = x[0] * y[0] - x[1:] @ y[1:]
    d = float(np.arccosh(max(g, FLOOR)))
    if d < G.EXP_ZERO_TOL:
        return x
    a, b = (1.0 - w) * d, w * d
    num_x = np.exp(-b) * (1.0 - np.exp(-2.0 * a))
    num_y = np.exp(-a) * (1.0 - np.exp(-2.0 * b))
    den = max(1.0 - np.exp(-2.0 * d), G.EPS_NORM)
    return (num_x * x + num_y * y) / den


# ------------------------------------------------------------------- judge

class _Sync:
    """What the judge keeps of a sync: its table, the samples, and per
    phase the queue: the entries that may be among the program's
    ``queue_size`` best, best first, as numpy arrays (``key``, ``i``,
    ``j``, ``sc``, ``lo``, ``hi``, ``a_lo``, ``a_hi``, ``sure``: surely
    queued, ``live``: not merged yet) with their keys sorted (``skey``,
    ``spos``)."""

    def __init__(self, tab: Table, samples, queues):
        self.tab, self.queues = tab, queues
        self.samples = samples.cpu().numpy()

    @staticmethod
    def find(q, a: int, b: int):
        """The pair's entry in the queue, or None."""
        k = (a << 32) | b
        pos = int(np.searchsorted(q["skey"], k))
        if pos < q["skey"].shape[0] and q["skey"][pos] == k:
            return int(q["spos"][pos])
        return None


class _Follow:
    """The judge's walk through one training (see :func:`judge`)."""

    def __init__(self, rec, corpus0, emb0, vocab0, morph, out, log):
        self.rec = rec
        dev = corpus0.device
        self.dev = dev
        self.n0 = n0 = len(vocab0)
        self.merges = out["merges"].to(dev).long()
        self.n = n = self.merges.shape[0]
        self.pairs = [tuple(p) for p in self.merges.cpu().tolist()]
        self.prog = out["emb"][:n0 + n].to(dev).double()
        self.prog_host = self.prog.cpu().numpy()
        self.log = log
        self.toks = Tokens(vocab0, morph, dev, n0 + n)
        self.d1 = emb0.shape[1]
        self.ref = torch.zeros((n0 + n, self.d1), device=dev)
        self.ref[:n0] = emb0
        self.adam = R.CurvatureAdam(rec, 1.0, dev)
        self.curv_steps = 0
        self.corpus = corpus0
        self.synced = 0
        self.gap = 0.0
        self.held_gap = 0.0
        self.all_gap = 0.0
        self.seen = set()
        self.dense = _Dense(self.prog, self.toks.lengths, rec.max_token_len,
                            n0, exact=False)
        self.sync = None
        self.li = 0
        self.phase = 1

    @property
    def c(self) -> float:
        return float(self.adam.c)

    @property
    def p(self) -> int:
        """Merges walked."""
        return len(self.toks.strings) - self.n0

    def snapshot(self):
        """What a step changes, to take the step back (:meth:`restore`)."""
        live = ([q["live"].copy() for q in self.sync.queues]
                if self.sync is not None else None)
        return (self.p, copy.copy(self.adam), self.curv_steps, self.corpus,
                self.synced, self.gap, self.held_gap, self.all_gap,
                self.dense.snapshot(), self.sync, live, self.li, self.phase)

    def restore(self, snap) -> None:
        (p, adam, self.curv_steps, self.corpus, self.synced, self.gap,
         self.held_gap, self.all_gap, dense, self.sync, live, self.li,
         self.phase) = snap
        self.adam = copy.copy(adam)
        self.dense.restore(dense)
        if live is not None:
            for q, x in zip(self.sync.queues, live):
                q["live"] = x.copy()
        del self.toks.strings[self.n0 + p:]
        self.seen = set(self.pairs[:p])

    def rel(self) -> float:
        """Relative width added to a distance: its acosh and division,
        and each curvature step's rescale of a cached distance (and of the
        curvature itself)."""
        return 8 * U32 + 4 * U32 * (self.curv_steps + 1)

    def next_log(self):
        return self.log[self.li] if self.li < len(self.log) else None

    def take_log(self, kind: str, p: int):
        e = self.next_log()
        if e is None or e[0] != kind or e[1] - self.n0 != p:
            raise _Unowed(f"log {e and e[:2]} where {kind} at {p} is owed")
        self.li += 1
        return e[2]

    # -- events
    def on_sync(self, p: int, thr: float, samples):
        rec, toks = self.rec, self.toks
        v = self.n0 + p
        samples = torch.clamp_max(samples.to(self.dev).long(), v - 1)
        self.corpus = R.replay(self.corpus, self.merges[self.synced:p],
                               self.n0 + self.synced)
        self.synced = p
        tab, rows, cols = _sync_table(rec, self.corpus, toks)
        g, s = _gram(self.prog[rows], self.prog[cols])
        a_ex = G.acosh(torch.clamp_min(g, FLOOR))
        a_lo, a_hi = acosh_bounds(g, s, self.d1)
        c = self.c
        sc = scores(rec, tab, rows, cols, tab.counts, self.prog, toks, c, thr,
                    samples, dist=a_ex / c ** 0.5)
        lo, hi = score_bounds(rec, sc, a_ex, a_lo, a_hi, c, self.rel())
        k = rec.queue_size
        queues = []
        for ph in range(3):
            s_p, lo_p, hi_p = sc[:, ph], lo[:, ph], hi[:, ph]
            live = s_p > -torch.inf
            if int(live.sum()) > k:
                # The program's queue holds its k best: those whose score
                # can reach the k-th least, surely those above the
                # (k+1)-th most.
                l_k = torch.topk(torch.where(live, lo_p, -torch.inf), k
                                 ).values[-1]
                h_k1 = torch.topk(torch.where(live, hi_p, -torch.inf), k + 1
                                  ).values[-1]
                ext, sure = live & (hi_p >= l_k), lo_p > h_k1
            else:
                ext, sure = live, live
            pos = torch.nonzero(ext).flatten()
            pos = pos[torch.sort(s_p[pos], descending=True, stable=True
                                 ).indices]
            q = {name: t[pos].cpu().numpy() for name, t in (
                ("key", tab.keys), ("i", rows), ("j", cols), ("sc", s_p),
                ("lo", lo_p), ("hi", hi_p), ("a_lo", a_lo), ("a_hi", a_hi),
                ("sure", sure))}
            q["live"] = np.ones(pos.shape[0], bool)
            q["spos"] = np.argsort(q["key"], kind="stable")
            q["skey"] = q["key"][q["spos"]]
            queues.append(q)
        self.sync = _Sync(tab, samples, queues)

    def on_curvature(self, p: int, draws):
        v = self.n0 + p
        draws = [torch.clamp_max(d.to(self.dev), v - 1) for d in draws]
        self.adam.step(self.ref[:v], self.merges, p, draws)
        self.curv_steps += 1

    # -- a step
    def _distance(self, a, scale: float):
        return a * scale / self.c ** 0.5

    def _validity(self, q, thr: float):
        """Per queue entry: surely valid, possibly valid."""
        rel = self.rel()
        return (self._distance(q["a_hi"], 1 + rel) < thr,
                self._distance(q["a_lo"], 1 - rel) < thr)

    def _possible_dense(self, a: int, b: int, thr: float, v: int):
        """Whether the pair can be the dense channel's at threshold
        ``thr``: a pair of rows, the first lower, never merged, within the
        length cap, possibly closer than the threshold."""
        if not (0 <= a < b < v) or (a, b) in self.seen:
            return False
        s = self.toks.strings
        if len(s[a]) + len(s[b]) > self.rec.max_token_len:
            return False
        _, lo, _ = pair_acosh(self.prog_host, a, b)
        return self._distance(lo, 1 - self.rel()) < thr

    def on_step(self, p, phase, thr, consumed):
        """The readings of the step at ``p`` that the rules allow:
        ``[("resync", None)]`` where the log resyncs here, else ``(k,
        gaps)`` for each number of merges ``k`` that some reading takes,
        with the least (score, held dense, all-pairs dense) gaps of those
        readings; those with the least gap first, the longest first."""
        rec = self.rec
        nb = max(1, rec.merge_batch)
        v = self.n0 + p
        self.phase = phase
        q = self.sync.queues[phase - 1 if rec.use_hierarchical else 0]
        sure_v, may_v = self._validity(q, thr)
        live = q["live"]
        pv = live & may_v                       # possibly valid
        sv = live & sure_v & q["sure"]          # surely valid and queued
        a_lo, a_hi, a_top = self.dense.bounds()
        rel = self.rel()
        m_lo, m_hi, m_top = (self._distance(a_lo, 1 - rel),
                             self._distance(a_hi, 1 + rel),
                             self._distance(a_top, 1 + rel))
        dense = "sure" if m_hi < thr else ("no" if m_lo >= thr else "maybe")
        trunc = self.sync.tab.truncated
        n_lo = int(sv.sum()) - (dense != "no")
        n_hi = int(pv.sum())
        nxt = self.next_log()
        if nxt is not None and nxt[0] == "coherence" and \
                nxt[1] - self.n0 == p:
            if not (trunc and consumed and n_lo < nb):
                raise _Unowed(f"a resync at {p} that no count owes")
            return [("resync", None)]
        if trunc and consumed and n_hi < nb:
            raise _Unowed(f"a resync owed at {p} and not made")
        limit = min(nb + (dense != "no"), rec.max_vocab_size - v, self.n - p)
        if nxt is not None and nxt[1] - self.n0 > p:
            limit = min(limit, nxt[1] - self.n0 - p)
        out = []
        for k in range(max(limit, 0), -1, -1):
            best = None
            for t_d in self._parse(p, k, q, pv, sv, dense, thr, v, nb,
                                   trunc and consumed):
                gaps = self._gaps(p, k, q, t_d, thr, m_hi, m_top)
                if best is None or max(gaps[:2]) < max(best[:2]):
                    best = gaps
            if best is not None:
                out.append((k, best))
        if not out:
            raise _Unowed(f"no reading of the intervals explains the step "
                          f"at {p}")
        return sorted(out, key=_preference)

    def take_step(self, p: int, k: int, gaps) -> None:
        """Take the reading that the step at ``p`` made ``k`` merges, at
        ``gaps``."""
        self.gap = max(self.gap, gaps[0])
        self.held_gap = max(self.held_gap, gaps[1])
        self.all_gap = max(self.all_gap, gaps[2])
        self._merge(p, k)

    def _parse(self, p, k, q, pv, sv, dense, thr, v, nb, rs_rule):
        """The positions of the dense merge among the next ``k`` merges
        (-1: none) that make them a step the rules allow: the others
        unmerged, possibly valid queue entries, at most a batch, and a
        whole batch unless no surely valid entry is left and no resync is
        owed instead."""
        ms = self.pairs[p:p + k]
        idx = [_Sync.find(q, a, b) for a, b in ms]
        options = [] if dense == "sure" else [-1]
        if dense != "no":
            options += [t for t, (a, b) in enumerate(ms)
                        if self._possible_dense(a, b, thr, v)]
        out = []
        for t_d in options:
            picks = [i for t, i in enumerate(idx) if t != t_d]
            if len(picks) > nb or any(i is None or not pv[i]
                                      for i in picks):
                continue
            if len(set(picks)) != len(picks):
                continue
            if len(picks) < nb:
                if rs_rule:
                    continue
                left = sv.copy()
                left[picks] = False
                if t_d >= 0 and idx[t_d] is not None:
                    left[idx[t_d]] = False
                if left.any():
                    continue
            out.append(t_d)
        return out

    def _gaps(self, p, k, q, t_d, thr, m_hi, m_top):
        """(score gap, held dense gap, all-pairs dense gap) of reading the
        next ``k`` merges as a step with its dense merge at ``t_d`` (-1:
        none)."""
        ms = self.pairs[p:p + k]
        picks = [(t, _Sync.find(q, a, b)) for t, (a, b) in enumerate(ms)
                 if t != t_d]
        sc_lo, sc_hi = q["lo"], q["hi"]
        gap = held = every = 0.0
        # A surely valid entry left behind that scores above a pick.
        mask = q["live"] & self._validity(q, thr)[0] & q["sure"]
        for _, i in picks:
            mask[i] = False
        if t_d >= 0:
            i = _Sync.find(q, *ms[t_d])
            if i is not None:
                mask[i] = False
        if picks and mask.any():
            gap = float(sc_lo[mask].max()) - min(float(sc_hi[i])
                                                 for _, i in picks)
        # The picks in queue order, the dense one at its rank.
        for (_, i), (_, j) in zip(picks, picks[1:]):
            gap = max(gap, float(sc_lo[j]) - float(sc_hi[i]))
        if t_d >= 0:
            a, b = ms[t_d]
            ex, lo, hi = pair_acosh(self.prog_host, a, b)
            d_lo = self._distance(lo, 1 - self.rel())
            held = max(d_lo - m_hi, 0.0) / max(m_hi, 1e-30)
            every = max(d_lo - m_top, 0.0) / max(m_top, 1e-30)
            if picks:
                ds_lo, ds_hi = self._pair_score(a, b, ex, lo, hi, thr)
                for t, i in picks:
                    gap = max(gap, ds_lo - float(sc_hi[i]) if t < t_d
                              else float(sc_lo[i]) - ds_hi)
        return max(gap, 0.0), held, every

    def _pair_score(self, a, b, ex, lo, hi, thr):
        """The least and the most the dense channel's score of the pair can
        be at this step (:func:`scores` and :func:`score_bounds` for one
        pair, on the host): at the current curvature and threshold, with
        the last sync's samples, counts and token total, at this phase."""
        rec, s = self.rec, self.sync
        al, be, ga, cw, mw = rec.weights()
        rc = self.c ** 0.5
        d = ex / rc
        f = s.tab.count(a, b)
        la, lb = len(self.toks.strings[a]), len(self.toks.strings[b])
        score = al / (1 + d)
        amb = 0.0
        if rec.use_frequency_aware:
            score += be * np.log1p(f) / max(
                np.log1p(max(s.tab.f_max, 1)), 1e-9)
            e = self.prog_host
            mid = _geodesic_host(e[a], e[b], lb / max(la + lb, 1))
            pts = e[s.samples]
            gm = pts[:, 0] * mid[0] - pts[:, 1:] @ mid[1:]
            dm = np.arccosh(np.maximum(gm, GRAD_FLOOR)) / rc
            other = (s.samples != a) & (s.samples != b)
            avg = dm[other].sum() / max(int(other.sum()), 1)
            score += ga / (1 + np.exp(avg - thr))
            amb = ga if lo == 0 < hi else 0.0
        if rec.use_compression_aware:
            total = max(s.tab.tokens, 1)
            score += cw * min(max(total / max(total - f, 1) - 1, 0.0), 1.0)
        if rec.use_hierarchical:
            tok = self.toks.strings[a] + self.toks.strings[b]
            h1, h2 = str_hash(tok)
            key = h1 * 65536 + h2
            score += mw * (
                (0.8 if la <= 2 and lb <= 2 else 0.2),
                (0.9 if key in self.toks.morph_set else 0.3),
                (1.0 if key in self.toks.word_set or (
                    la + lb >= 3 and VOWEL.search(tok)) else 0.4),
            )[self.phase - 1]
        rel = self.rel()
        d_lo, d_hi = lo * (1 - rel) / rc, hi * (1 + rel) / rc
        return (score - al * (1 / (1 + d) - 1 / (1 + d_hi)) - amb
                - SCORE_SLACK,
                score + al * (1 / (1 + d_lo) - 1 / (1 + d)) + amb
                + SCORE_SLACK)

    def _merge(self, p: int, k: int):
        """Apply the program's next ``k`` merges."""
        if k == 0:
            return
        ms = self.pairs[p:p + k]
        v = self.n0 + p
        for a, b in ms:
            if not (0 <= a < v and 0 <= b < v):
                raise _Unowed(f"a merge at {p} of a token not made yet")
        self.ref[v:v + k] = R.merged_points(
            self.ref, self.toks.lengths, self.merges[p:p + k], self.adam.c)
        self.toks.add(ms)
        keys = np.array([(a << 32) | b for a, b in ms], np.int64)
        for qq in self.sync.queues:
            qq["live"] &= ~np.isin(qq["key"], keys)
        self.seen.update(ms)
        self.dense.grow(v + k, ms)


class _Unowed(Exception):
    pass


def judge(rec: Recipe, corpus0: torch.Tensor, emb0: torch.Tensor,
          vocab0: List[str], morph, out: Dict, log: List[tuple]
          ) -> Dict[str, float]:
    """Follow one training and measure its outputs.

    ``corpus0``: the corpus ids (shard-aligned as the recipe lays them
    out); ``emb0``: the initial points; ``morph``: :func:`morphology` of
    the corpus lines; ``out``: the program's ``merges``, ``emb``,
    ``curvature`` and ``vocab``; ``log``: the benchmark sampler's calls.

    Returns ``merge_score_gap`` (the widest amount by which a queue merge's
    score lies below a valid entry its step left behind, or out of order
    with its step's other merges, the dense one at its rank; each score at
    the end of its interval that favours the program), ``dense_held_gap``
    (the most by which a dense merge's distance lies above the least
    distance a row must still hold at its step, relative to it),
    ``dense_gap`` (the same against the least distance among all active
    pairs), ``point_gap``, ``curvature_gap``, ``vocab_mismatch``,
    ``repeated_merges`` and ``unmerged_pairs`` as
    :func:`corpus_training.judge` has them; of the readings the search
    finds, the first with no score or held gap, else the one it settled
    on. A log off :func:`schedule`, a step no reading explains, a merge
    that no queue offered, and a dense merge owed and not made read
    ``GAP_UNOWED``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _judge(rec, corpus0, emb0, vocab0, morph, out, log)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class _Choice:
    """A step read one way while other readings were left: the step's
    count, the state before it, the sends before it, the readings left."""

    def __init__(self, step: int, snap, sent: int, left: list):
        self.step, self.snap, self.sent, self.left = step, snap, sent, left


def _preference(reading):
    """The order in which a step's readings are taken: the least score or
    held gap, then the longest."""
    k, gaps = reading
    return max(gaps[:2]), -k


def _faults(gaps) -> bool:
    return max(gaps[:2]) > 0.0


def _walk(f: _Follow, rec: Recipe, log) -> bool:
    """Follow the schedule through the training, searching the readings of
    its steps (module docstring); False where no reading reaches the end.
    """
    global last_unowed
    n0, n = f.n0, f.n
    sent: List = []          # what the schedule was sent, in order
    kept: deque = deque()    # _Choice, oldest first
    stats = dict(choices=0, restores=0, faults=0)
    events = schedule(rec, n0)
    ev = next(events)
    steps = tries = 0
    fault_at = -1
    forced = None            # the reading taken up again at a step
    try:
        while True:
            try:
                kind, x = ev[0], None
                if kind == "coherence":
                    f.on_sync(ev[1], ev[2], f.take_log("coherence", ev[1]))
                elif kind == "curvature":
                    f.on_curvature(ev[1], f.take_log("curvature", ev[1]))
                elif kind == "step":
                    if forced is None:
                        rs = f.on_step(*ev[1:])
                        good = [r for r in rs if r[1] is None
                                or not _faults(r[1])]
                        if not good and kept and tries < TRIES and \
                                stats["restores"] < RESTORES:
                            raise _Unowed(f"a gap at {ev[1]}")
                        if not good:
                            stats["faults"] += 1
                            kept.clear()   # measured: nothing reopens
                        elif len(good) > 1:
                            stats["choices"] += 1
                            kept.append(_Choice(steps, f.snapshot(),
                                                len(sent), good[1:]))
                        x, gaps = (good or rs)[0]
                    else:
                        (x, gaps), forced = forced, None
                    if x != "resync":
                        f.take_step(ev[1], x, gaps)
                        steps += 1
                        if steps > fault_at:
                            tries = 0
                        while kept and kept[0].step < steps - WINDOW:
                            kept.popleft()
                elif kind == "end":
                    if ev[1] != n or f.li != len(log):
                        raise _Unowed(f"the training ends at {n}, owed at "
                                      f"{ev[1]}")
                    return True
                sent.append(x)
                ev = events.send(x)
            except _Unowed as e:
                fault_at = max(fault_at, steps)
                if not kept or tries >= TRIES or \
                        stats["restores"] >= RESTORES:
                    last_unowed = str(e)
                    return False
                c = kept[-1]
                forced = c.left.pop(0)
                if not c.left:
                    kept.pop()
                f.restore(c.snap)
                del sent[c.sent:]
                events = schedule(rec, n0)
                ev = next(events)
                for y in sent:
                    ev = events.send(y)
                steps = c.step
                tries += 1
                stats["restores"] += 1
    finally:
        last_search.clear()
        last_search.update(stats)


def _judge(rec, corpus0, emb0, vocab0, morph, out, log):
    global last_unowed
    last_unowed = None
    f = _Follow(rec, corpus0, emb0, vocab0, morph, out, log)
    n0, n = f.n0, f.n
    consistent = _walk(f, rec, log)
    # Rows past where the walk ended, at the last curvature.
    made = n0 + torch.arange(n, device=f.dev)[:, None]
    known = bool(((f.merges >= 0) & (f.merges < made)).all())
    done = len(f.toks.strings) - n0
    if known and done < n:
        # In runs of merges whose parents all exist before the run.
        newest = f.merges.max(1).values
        t = done
        while t < n:
            late = torch.nonzero(newest[t:] >= n0 + t)
            k = max(int(late[0]) if late.numel() else n - t, 1)
            f.ref[n0 + t:n0 + t + k] = R.merged_points(
                f.ref, f.toks.lengths, f.merges[t:t + k], f.adam.c)
            f.toks.add(f.pairs[t:t + k])
            t += k
    ref = f.ref[:n0 + n]
    prog = out["emb"][:n0 + n].to(f.dev).float()
    scale = torch.clamp_min(ref.abs().amax(1), 1.0)
    point_gap = (float(((prog - ref).abs().amax(1) / scale).max())
                 if n0 + n else 0.0)
    if not known:
        point_gap = GAP_UNOWED
    strings = list(vocab0)
    bad = 0
    for t, (a, b) in enumerate(f.pairs):
        ok = 0 <= a < len(strings) and 0 <= b < len(strings)
        s = strings[a] + strings[b] if ok else None
        strings.append(s)
        if (s is None or n0 + t >= len(out["vocab"])
                or out["vocab"][n0 + t] != s):
            bad += 1
    bad += abs(len(out["vocab"]) - (n0 + n))
    left = 0
    if n < rec.steps and not (rec.target_vocab_size is not None and n0 + n
                              >= rec.target_vocab_size) \
            and n0 + n < rec.max_vocab_size and consistent:
        corpus = R.replay(f.corpus, f.merges[f.synced:n], n0 + f.synced)
        nxt = torch.cat([corpus[1:], corpus.new_full((1,), -1)])
        left = int(((corpus >= 0) & (nxt >= 0)).sum())
    c_ref = float(f.adam.c)
    gaps = (f.gap, f.held_gap, f.all_gap)
    if not consistent:
        gaps = (GAP_UNOWED,) * 3
    return {
        "merge_score_gap": float(gaps[0]),
        "dense_held_gap": float(gaps[1]),
        "dense_gap": float(gaps[2]),
        "point_gap": float(point_gap),
        "curvature_gap": abs(float(out["curvature"]) - c_ref) / c_ref,
        "vocab_mismatch": float(bad),
        "repeated_merges": float(n - len(set(f.pairs))),
        "unmerged_pairs": float(left),
    }


# -------------------------------------------------------------------- train

def train(rec: Recipe, corpus0: torch.Tensor, emb0: torch.Tensor,
          vocab0: List[str], morph, sampler, dtype=torch.float32) -> Dict:
    """A training of its own by the same rules and :func:`schedule`: each
    step's dense pair is its own argmin (lowest row on ties), its queue
    picks the first valid entries of its own queues. Draws through
    ``sampler`` (``coherence``, ``curvature``). Returns :func:`judge`'s
    ``out``.

    With a ``dtype`` below float32, the control: the rows, the curvature
    that the schedule's choices read and every test against the threshold
    stay float32, so that the judge can follow it, and in ``dtype`` are
    the ranking (each queue's order among its float32 members, and the
    dense channel's choice among the rows whose nearest partner is under
    the threshold, from grams of the rows rounded to ``dtype``), the
    curvature it returns (Adam in ``dtype`` on the same inputs) and
    ``emb_low``, its rows merged in ``dtype`` from their parents there."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(rec, corpus0, emb0, vocab0, morph, sampler, dtype)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _train(rec, corpus0, emb0, vocab0, morph, sampler, dtype):
    dev = corpus0.device
    n0 = len(vocab0)
    cap = rec.max_vocab_size
    nb = max(1, rec.merge_batch)
    f32 = torch.float32
    low = dtype != f32
    emb = torch.zeros((cap, emb0.shape[1]), dtype=f32, device=dev)
    emb[:n0] = emb0.float()
    if low:
        emb_low = emb.to(dtype)
        adam_low = R.CurvatureAdam(rec, 1.0, dev, dtype)
    toks = Tokens(vocab0, morph, dev, cap)
    merges = torch.full((cap, 2), -1, dtype=torch.long, device=dev)
    adam = R.CurvatureAdam(rec, 1.0, dev)
    dense = _Dense(emb, toks.lengths, rec.max_token_len, n0, exact=True)
    corpus, synced, p = corpus0, 0, 0
    tab = samples = None
    queues = []
    events = schedule(rec, n0)
    ev = next(events)
    while ev[0] != "end":
        kind, p = ev[0], ev[1]
        v = n0 + p
        if kind == "coherence":
            thr = ev[2]
            samples = sampler.coherence(rec.coherence_samples, v).long()
            corpus = R.replay(corpus, merges[synced:p], n0 + synced)
            synced = p
            tab, rows, cols = _sync_table(rec, corpus, toks)
            gr, _ = _gram(emb[rows], emb[cols])
            a = G.acosh(torch.clamp_min(gr, FLOOR))
            sc = scores(rec, tab, rows, cols, tab.counts, emb, toks, adam.c,
                        thr, samples, dist=a / torch.sqrt(adam.c))
            if low:
                rl = emb[rows].to(dtype), emb[cols].to(dtype)
                al = G.acosh(torch.clamp_min(_gram(*rl)[0], FLOOR))
                sc_rank = scores(rec, tab, rows, cols, tab.counts,
                                 emb.to(dtype), toks, adam.c.to(dtype), thr,
                                 samples,
                                 dist=al / torch.sqrt(adam.c.to(dtype)))
            queues = []
            for ph in range(3):
                order = torch.sort(sc[:, ph], descending=True, stable=True
                                   ).indices[:rec.queue_size]
                order = order[sc[order, ph] > -torch.inf]
                rank = sc[order, ph]
                if low:
                    rank = sc_rank[order, ph]
                    order = order[torch.sort(rank, descending=True,
                                             stable=True).indices]
                    rank = sc_rank[order, ph]
                queues.append({"key": tab.keys[order], "i": rows[order],
                               "j": cols[order], "sc": rank,
                               "a": a[order],
                               "live": torch.ones_like(order, dtype=bool)})
            ev = events.send(None)
        elif kind == "curvature":
            draws = sampler.curvature(rec.hier_pairs, rec.hier_negatives,
                                      rec.distortion_samples, v)
            adam.step(emb[:v], merges, p, draws)
            if low:
                adam_low.step(emb[:v], merges, p, draws)
            ev = next(events)
        elif kind == "step":
            _, _, phase, thr, consumed = ev
            q = queues[phase - 1 if rec.use_hierarchical else 0]
            rc = torch.sqrt(adam.c)
            di, dj, best = dense.argmin()
            dd = best / rc
            dense_ok = bool(torch.isfinite(dd) & (dd < thr))
            if dense_ok and low:
                # The global argmin taken over distances from grams of
                # the rows in ``dtype``, among the rows under the
                # threshold.
                cand = torch.nonzero(dense.lo[:v] / rc < thr).flatten()
                x = (emb[cand].to(dtype),
                     emb[dense.best_j[cand]].to(dtype))
                al = G.acosh(torch.clamp_min(G.mdot(*x), FLOOR))
                di = int(cand[torch.argmin(al)])
                dj = int(dense.best_j[di])
                dd = dense.lo[di] / rc
            valid = q["live"] & (q["a"] / rc < thr)
            if dense_ok:
                valid &= q["key"] != ((di << 32) | dj)
            pos = torch.nonzero(valid).flatten()
            if tab.truncated and consumed and pos.shape[0] < nb:
                ev = events.send("resync")
                continue
            pos = pos[:nb]
            ii, jj = q["i"][pos], q["j"][pos]
            if dense_ok:
                e = emb.to(dtype)
                ds = scores(rec, tab, torch.tensor([di], device=dev),
                            torch.tensor([dj], device=dev),
                            torch.tensor([tab.count(di, dj)], device=dev),
                            e, toks, adam.c.to(e.dtype), thr, samples,
                            dist=dd.reshape(1).to(e.dtype), gate=False)[
                                0, phase - 1 if rec.use_hierarchical else 0]
                r = int((q["sc"][pos] > ds).sum())
                ii = torch.cat([ii[:r], ii.new_tensor([di]), ii[r:]])
                jj = torch.cat([jj[:r], jj.new_tensor([dj]), jj[r:]])
            k = min(ii.shape[0], cap - v)
            pairs = torch.stack([ii[:k], jj[:k]], 1)
            if k:
                emb[v:v + k] = R.merged_points(emb, toks.lengths, pairs,
                                               adam.c)
                if low:
                    emb_low[v:v + k] = R.merged_points(
                        emb_low, toks.lengths, pairs, adam.c, dtype)
                merges[p:p + k] = pairs
                ms = [tuple(x) for x in pairs.tolist()]
                toks.add(ms)
                keys = (pairs[:, 0] << 32) | pairs[:, 1]
                for qq in queues:
                    qq["live"] &= ~torch.isin(qq["key"], keys)
                dense.grow(v + k, ms)
            ev = events.send(k)
        else:
            ev = next(events)
    p = ev[1]
    out = {"merges": merges[:p], "emb": emb[:n0 + p],
           "curvature": float(adam.c), "vocab": toks.strings[:n0 + p]}
    if low:
        out["curvature"] = float(adam_low.c)
        out["emb_low"] = emb_low[:n0 + p].float()
    return out
