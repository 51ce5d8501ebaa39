"""The benchmark's corpus: its lines, its characters and their ids, in plain
Python and PyTorch.

A traffic file (``portbench/traffic/<name>.json``) names a corpus under
``portbench/data/``, its rule for lines (``lines``: a key of ``LINES``),
an optional ``max_lines`` and its rule for the vocabulary (``vocabulary``:
a key of ``VOCABULARIES``, with that rule's own keys). The one corpus
today is ``wiki_corpus.txt.bz2`` (a frozen copy of the repository's
``data/wiki_corpus.txt.bz2``: 5,352 lines of English Wikipedia text, 2.35
MB). Both sides of a comparison get what these functions make; the
program never makes them for the reference.
"""

from __future__ import annotations

import bz2
import io
import os
import re
from collections import Counter
from typing import List

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(HERE, "data")

SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>"]
UNK_ID = 3
PAD_ID = -1
SEP_ID = -2
# GPT-2-style word units with their leading space (the "words" pre-split).
WORDS_WITH_SPACE = r"\s?[^\W\d_]+|\s?\d+|\s?[^\w\s]+|\s+"


def corpus_text(name: str) -> str:
    """The text of corpus ``name`` under ``portbench/data/``."""
    with bz2.open(os.path.join(DATA, name), "rt", encoding="utf-8") as f:
        return f.read()


def nonempty_lines(text: str) -> List[str]:
    """The corpus's non-empty lines without their newline (the flagship
    recipe's corpus)."""
    return [ln.rstrip("\n") for ln in io.StringIO(text) if ln.strip()]


def file_lines(text: str) -> List[str]:
    """Every line as a text file yields it, newline kept (what a CLI that
    iterates the corpus file sees)."""
    return list(io.StringIO(text))


def sorted_char_vocab(lines: List[str]) -> List[str]:
    """The specials, then every character of the lines in code point
    order."""
    return SPECIALS + sorted({ch for ln in lines for ch in ln})


def counted_char_vocab(lines: List[str], min_count: int = 5) -> List[str]:
    """The specials, then the characters seen at least ``min_count`` times,
    in the order they are first seen."""
    counts: Counter = Counter()
    order: List[str] = []
    for ln in lines:
        for ch in ln:
            if ch not in counts:
                order.append(ch)
            counts[ch] += 1
    return SPECIALS + [ch for ch in order if counts[ch] >= min_count]


LINES = {"nonempty": nonempty_lines, "file": file_lines}
VOCABULARIES = {
    "sorted_chars": lambda lines, traffic: sorted_char_vocab(lines),
    "counted_chars": lambda lines, traffic: counted_char_vocab(
        lines, traffic["vocab_min_count"]),
}


def traffic_lines(traffic: dict) -> List[str]:
    """The traffic's lines: its corpus read by its rule for lines, the
    first ``max_lines`` of them where that is set."""
    lines = LINES[traffic["lines"]](corpus_text(traffic["corpus"]))
    return lines[:traffic["max_lines"]] if traffic.get("max_lines") else lines


def traffic_vocab(traffic: dict, lines: List[str]) -> List[str]:
    """The vocabulary that the traffic's rule builds from its lines."""
    return VOCABULARIES[traffic["vocabulary"]](lines, traffic)


def segments(text: str, pattern: str) -> List[str]:
    """The lossless partition of ``text`` into the pattern's matches and
    the stretches between them."""
    out, pos = [], 0
    for m in re.finditer(pattern, text):
        if m.start() > pos:
            out.append(text[pos:m.start()])
        if m.end() > m.start():
            out.append(m.group())
        pos = max(pos, m.end())
    if pos < len(text):
        out.append(text[pos:])
    return out


def encode_chars(lines: List[str], vocab: List[str], max_tokens: int,
                 pre_split: str = None) -> np.ndarray:
    """Character ids of the lines, a separator after each line (after each
    segment when ``pre_split`` is a pattern), cut at ``max_tokens`` and
    padded to it. A character outside the vocabulary is ``<unk>``."""
    ids_of = {}
    for i, t in enumerate(vocab):
        ids_of.setdefault(t, i)
    ids: List[int] = []
    for ln in lines:
        parts = segments(ln, pre_split) if pre_split else [ln]
        for seg in parts:
            ids.extend(ids_of.get(ch, UNK_ID) for ch in seg)
            ids.append(SEP_ID)
        if len(ids) >= max_tokens:
            break
    ids = ids[:max_tokens]
    out = np.full((max_tokens,), PAD_ID, np.int32)
    out[:len(ids)] = ids
    return out
