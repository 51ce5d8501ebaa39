"""Data pipeline: text cleaning, vocabulary building, embedding init, IO.

Port of ``hyptokenizer_tpu/utils/data.py``: ``clean_text``, ``open_text``
(bz2-aware), ``preprocess_lines``, ``build_initial_vocab`` (first-seen
order), ``load_vocab``/``save_vocab``, ``encode_corpus_chars`` and
``shard_align_corpus`` are copied (numpy only); ``initialize_embeddings``
draws through the port's ``lorentz.random_points`` from a
``torch.Generator``. ``read_corpus_lines`` reads the flagship benchmark's
``data/wiki_corpus.txt.bz2``.
"""

from __future__ import annotations

import bz2
import re
import unicodedata
from collections import Counter
from typing import IO, Iterable, List, Optional, Union

import numpy as np
import torch

SPECIAL_TOKENS = ["<pad>", "<bos>", "<eos>", "<unk>"]
_STRIP_RE = re.compile(r"[^a-z0-9\s\.\,]")
_WS_RE = re.compile(r"\s+")


def clean_text(text: str) -> str:
    """NFC normalise, lowercase, strip to [a-z0-9 space . ,], collapse ws.

    Parity: preprocess_wiki.py:30-52. (Note: accented chars are *removed*, not
    transliterated — NFC keeps 'é' composed and the regex deletes it; the
    reference's own test asserting 'café'->'cafe' fails against this, see
    SURVEY §4 / DEVIATIONS context.)
    """
    text = unicodedata.normalize("NFC", text)
    text = text.lower().strip()
    text = _STRIP_RE.sub(" ", text)
    text = _WS_RE.sub(" ", text)
    return text


def open_text(path: str, mode: str = "r") -> IO:
    """BZ2-aware text open (preprocess_wiki.py:55-75)."""
    if path.endswith(".bz2"):
        if "r" in mode:
            return bz2.open(path, mode + "t", encoding="utf-8",
                            errors="ignore")
        return bz2.open(path, mode + "t", encoding="utf-8")
    return open(path, mode, encoding="utf-8")


def preprocess_lines(lines: Iterable[str], min_length: int = 0) -> Iterable[str]:
    """Clean lines, dropping those shorter than ``min_length`` post-cleaning."""
    for line in lines:
        cleaned = clean_text(line)
        if len(cleaned) >= min_length and cleaned:
            yield cleaned


def build_initial_vocab(lines: Iterable[str], min_count: int = 5) -> List[str]:
    """Char-frequency vocab with specials prepended (preprocess_wiki.py:126-166).

    Characters keep first-seen order, filtered by ``min_count``.
    """
    counts: Counter = Counter()
    seen_order: List[str] = []
    seen = set()
    for line in lines:
        for ch in line:
            counts[ch] += 1
            if ch not in seen:
                seen.add(ch)
                seen_order.append(ch)
    vocab = [ch for ch in seen_order if counts[ch] >= min_count]
    return SPECIAL_TOKENS + vocab


def load_vocab(path: str) -> List[str]:
    """One token per line (train_hyperbolic_tokenizer.py:50-62)."""
    with open_text(path) as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n")]


def save_vocab(vocab: List[str], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for tok in vocab:
            f.write(tok + "\n")


def initialize_embeddings(n: int, dim: int, curvature: float = 1.0,
                          sigma: float = 0.01,
                          seed: Union[int, torch.Generator] = 42,
                          device=None) -> torch.Tensor:
    """Tangent-Gaussian init at the origin -> exp map -> projection, as a
    (n, dim+1) float32 tensor on ``device`` (default: the card).

    ``seed`` is an int or a ``torch.Generator`` on ``device``. The numbers
    differ from the JAX package's ``PRNGKey(seed)`` draws; the distribution
    is the same (train_hyperbolic_tokenizer.py:64-107: sigma 0.01, zero
    time coordinate in the tangent, final re-projection).
    """
    from hyptokenizer_tpu_torch import _device
    from hyptokenizer_tpu_torch.ops import lorentz as L
    dev = _device.resolve(device)
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    return L.random_points(gen, n, dim, c=curvature, sigma=sigma, device=dev)


def read_corpus_lines(path: str) -> List[str]:
    """Non-empty lines of a (bz2-compressed) text corpus, newline stripped.

    The corpus recipe of the flagship benchmark (``bench.py``
    ``load_corpus``)."""
    opener = bz2.open if path.endswith(".bz2") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


def encode_corpus_chars_py(texts: Iterable[str], vocab: List[str],
                           max_tokens: int, unk_id: int = 3,
                           sep_id: int = -2, pad_id: int = -1,
                           pre_split: Optional[str] = None) -> np.ndarray:
    """Reference (pure-python) corpus encoder; see encode_corpus_chars."""
    t2i = {}
    for i, t in enumerate(vocab):
        t2i.setdefault(t, i)
    ids: List[int] = []
    for text in texts:
        if pre_split is not None:
            from hyptokenizer_tpu_torch.tokenizer.normalize import segments
            for seg in segments(text, pre_split):
                ids.extend(t2i.get(ch, unk_id) for ch in seg)
                ids.append(sep_id)
        else:
            ids.extend(t2i.get(ch, unk_id) for ch in text)
            ids.append(sep_id)
        if len(ids) >= max_tokens:
            break
    ids = ids[:max_tokens]
    arr = np.full((max_tokens,), pad_id, np.int32)
    arr[:len(ids)] = ids
    return arr


def _char_classes(uniq_codes: np.ndarray) -> np.ndarray:
    """Regex-exact char class per unique codepoint for WORDS_WITH_SPACE:
    0 space, 1 letter, 2 digit, 3 punct ([^\\w\\s]), 4 unmatched word char
    (e.g. '_', which no alternative of the pattern matches — it surfaces as
    a gap segment in normalize.segments)."""
    is_space = re.compile(r"\s")
    is_letter = re.compile(r"[^\W\d_]")
    is_digit = re.compile(r"\d")
    is_punct = re.compile(r"[^\w\s]")
    out = np.full(uniq_codes.shape, 4, np.int8)
    for k, code in enumerate(uniq_codes):
        ch = chr(int(code))
        if is_space.match(ch):
            out[k] = 0
        elif is_letter.match(ch):
            out[k] = 1
        elif is_digit.match(ch):
            out[k] = 2
        elif is_punct.match(ch):
            out[k] = 3
    return out


def encode_corpus_chars(texts: Iterable[str], vocab: List[str],
                        max_tokens: int, unk_id: int = 3,
                        sep_id: int = -2, pad_id: int = -1,
                        pre_split: Optional[str] = None) -> np.ndarray:
    """Char-encode lines into a fixed-size id array with SEP between lines.

    The shared corpus representation of the enhanced scorer and the RSGD
    embedding trainer (PAD=-1 tail, SEP=-2 line separators; see
    tokenizer/scoring.py).

    ``pre_split``: optional regex (tokenizer/normalize.py) — SEPs are also
    inserted between the lossless segments of each line, so merge candidates
    (adjacent corpus pairs) never cross a segment boundary. This is the
    training-side counterpart of the encode path's pre-splitting: a tokenizer
    trained this way with ``normalizer=NormalizerConfig(pre_split=...)``
    tokenizes exactly the units it was trained on, and stays lossless (every
    character, separators included, belongs to a segment).

    Implementation: numpy-vectorised (codepoint LUT + run-class boundary
    logic for the two canonical pre-split patterns) — ~100x the python char
    loop, which matters at the 100 MB corpus scale. Output is fuzz-tested
    identical to :func:`encode_corpus_chars_py`; non-canonical patterns fall
    back to the python path.
    """
    from hyptokenizer_tpu_torch.tokenizer import normalize as N

    if pre_split is not None and pre_split not in (N.WHITESPACE,
                                                   N.WORDS_WITH_SPACE):
        return encode_corpus_chars_py(texts, vocab, max_tokens, unk_id,
                                      sep_id, pad_id, pre_split)
    # Accumulate only as much text as max_tokens can consume (every char
    # yields >= 1 output slot, so max_tokens chars always suffice).
    lines: List[str] = []
    total = 0
    for text in texts:
        lines.append(text)
        total += len(text) + 1
        if total >= max_tokens:
            break
    # NUL as the line marker: impossible in normal text lines; stray
    # occurrences (checked with one fast count) are stripped first so the
    # marker stays unambiguous.
    big = "\x00".join(lines)
    if big.count("\x00") != len(lines) - 1:
        big = "\x00".join(ln.replace("\x00", "") for ln in lines)
    codes = np.frombuffer(big.encode("utf-32-le"), np.uint32)
    n = codes.shape[0]
    arr = np.full((max_tokens,), pad_id, np.int32)
    if n == 0:
        if lines and pre_split is None:  # an empty line still emits its SEP
            arr[0] = sep_id
        return arr

    # Dense codepoint LUTs (one O(n) presence pass; no sort): token id per
    # codepoint (first vocab occurrence wins, as the python dict in the
    # reference) and — below — the regex char class.
    lut_size = int(codes.max()) + 1
    id_lut = np.full((lut_size,), unk_id, np.int32)
    lut_set = np.zeros((lut_size,), bool)
    for i, t in enumerate(vocab):
        if len(t) == 1 and ord(t) < lut_size and not lut_set[ord(t)]:
            lut_set[ord(t)] = True
            id_lut[ord(t)] = i
    ids = id_lut[codes]
    is_nl = codes == 0  # the line marker
    keep = ~is_nl

    if pre_split is None:
        # Segments are whole lines. A kept char is last-of-line iff the
        # next code is a marker (or end of text). Every line — even an
        # empty one — emits one SEP: bare seps ride on markers whose line
        # is empty (marker at position 0, after another marker, or final).
        last = np.zeros((n,), bool)
        last[:-1] = keep[:-1] & is_nl[1:]
        last[n - 1] = keep[n - 1]
        # Empty lines still emit one SEP each: a marker preceded by another
        # marker (or at text start) covers the empty line BEFORE it; a
        # marker at text end additionally covers the empty FINAL line.
        bare_start = np.zeros((n,), np.int8)
        bare_start[0] = is_nl[0]
        bare_start[1:] = is_nl[1:] & is_nl[:-1]
        bare_end = np.zeros((n,), np.int8)
        bare_end[n - 1] = is_nl[n - 1]
        sepf = last.astype(np.int8) + bare_start + bare_end
    else:
        # Class LUT filled only at codepoints actually present (bincount
        # presence pass — no 105M-element sort).
        present = np.nonzero(np.bincount(
            np.minimum(codes, lut_size - 1), minlength=lut_size))[0]
        cls_lut = np.zeros((lut_size,), np.int8)
        cls_lut[present] = _char_classes(present)
        cls = cls_lut[codes]
        cls = np.where(is_nl, np.int8(-1), cls)  # marker: its own run
        if pre_split == N.WHITESPACE:
            cls = np.where(cls > 0, np.int8(1), cls)  # \S+ | \s+
        start = np.zeros((n,), bool)
        start[0] = True
        start[1:] = cls[1:] != cls[:-1]
        if pre_split == N.WORDS_WITH_SPACE:
            # A run of EXACTLY one space binds to a following letter/digit/
            # punct run (the \s? of those alternatives); longer space runs
            # are greedy \s+ segments; gap runs (class 4) never bind.
            single = np.zeros((n,), bool)
            single[:-1] = (start[:-1] & start[1:] & (cls[:-1] == 0)
                           & (cls[1:] >= 1) & (cls[1:] <= 3))
            start[1:] &= ~single[:-1]
        # SEP after the last kept char of every segment; empty lines emit
        # nothing (python presplit path appends seps per segment only).
        last = np.zeros((n,), bool)
        last[:-1] = keep[:-1] & start[1:]
        last[n - 1] = keep[n - 1]
        sepf = last

    # Slot assembly: each position occupies keep + sepf output slots
    # (char, then possibly SEP(s)). int32 throughout: these passes are
    # memory-bandwidth-bound at the 100 MB corpus scale.
    slots = keep.astype(np.int8) + np.asarray(sepf, np.int8)
    off = np.cumsum(slots, dtype=np.int32)
    total = int(off[-1])
    off -= slots  # exclusive
    buf = np.full((total,), sep_id, np.int32)
    buf[off[keep]] = ids[keep]
    out = buf[:max_tokens]
    arr[:out.shape[0]] = out
    return arr


def shard_align_corpus(arr: np.ndarray, n_shards: int, pad_id: int = -1,
                       sep_id: int = -2) -> np.ndarray:
    """Repack an encoded corpus so every 1/n_shards boundary lands on PAD/SEP.

    Corpus-dimension sharding (parallel/sharded.sync_corpus_sharded) computes
    pair counts per shard independently; a document straddling a shard
    boundary would lose its boundary pair. This host-side post-pass packs the
    SEP-delimited segments greedily into ``n_shards`` equal buckets (order
    preserved; a segment that exceeds the remaining bucket capacity is cut at
    the boundary, costing at most one adjacent pair — the same cost the flat
    encoder's ``max_tokens`` truncation already pays at the corpus tail).
    Aligned for every divisor of ``n_shards``, so one layout serves meshes of
    1..n_shards devices. No-op for n_shards <= 1.
    """
    n = arr.shape[0]
    if n_shards <= 1 or n % n_shards != 0:
        return arr
    cap = n // n_shards
    ids = arr[arr != pad_id]  # PAD appears only as filler, never in-segment
    used = ids.shape[0]
    out = np.full((n,), pad_id, np.int32)
    # Segment boundaries: SEP terminates a segment (SEP belongs to it).
    sep_pos = np.flatnonzero(ids == sep_id)
    starts = np.concatenate([[0], sep_pos + 1])
    ends = np.concatenate([sep_pos + 1, [used]])
    bucket = 0
    fill = 0
    for s, e in zip(starts, ends):
        if s >= e:
            continue
        seg = ids[s:e]
        while seg.shape[0] > 0:
            room = cap - fill
            # Whole segments move to the next bucket rather than being cut;
            # only segments longer than a full bucket are ever split.
            if room == 0 or (seg.shape[0] > room and seg.shape[0] <= cap):
                bucket += 1
                fill = 0
                if bucket >= n_shards:
                    return out
                continue
            take = min(room, seg.shape[0])
            out[bucket * cap + fill:bucket * cap + fill + take] = seg[:take]
            fill += take
            seg = seg[take:]
    return out
