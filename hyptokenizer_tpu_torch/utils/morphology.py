"""Copy of ``hyptokenizer_tpu/utils/morphology.py``
(the port imports nothing of the JAX package).

Host-side corpus morphology analysis for the hierarchical curriculum.

Capability parity with the reference's corpus-statistics pass and validity
checks (hierarchical_hyperbolic_merge.py:110-225): word counts, char n-gram
(2-5) counts with 80th/70th-percentile thresholds, common prefix/suffix lists,
optional WordNet lemma sets, and the frequent-substring fallback.

The validity *predicates* are compiled into finite hash sets + per-token
feature bits so the device merge loop can evaluate the morphology of a
*candidate* merged string without host round-trips (see
tokenizer/scoring.py docstring):

  is_morpheme(t) = t in (common_morphemes | prefixes | suffixes
                         | wordnet_lemmas>2 | frequent_substrings)
  is_word(t)     = t in (common_words | wordnet_lemmas)
                   or (len(t) >= 3 and has_vowel(t))   # vowel bit ORs

WordNet requires nltk corpus data; when absent (zero-egress environments) the
sets simply omit those entries — same degradation as the reference's
NLTK_AVAILABLE gate (hierarchical_…:29-39).
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Set

import numpy as np

COMMON_PREFIXES = {"re", "un", "in", "im", "il", "ir", "dis", "en", "em",
                   "non", "de", "pre", "pro", "mis"}
COMMON_SUFFIXES = {"ing", "ed", "er", "est", "ly", "ity", "ment", "ness",
                   "able", "ible", "al", "ial"}
_WORD_RE = re.compile(r"\b\w+\b")
_VOWEL_RE = re.compile(r"[aeiou]")


def _wordnet_lemmas() -> Set[str]:
    try:
        from nltk.corpus import wordnet
        return {l.lower() for l in wordnet.all_lemma_names()}
    except Exception:
        return set()


@dataclass
class MorphologyTables:
    """Finite validity sets + derived hash tables for the device loop."""

    common_morphemes: Set[str] = field(default_factory=set)
    common_words: Set[str] = field(default_factory=set)
    morph_set: Set[str] = field(default_factory=set)
    word_set: Set[str] = field(default_factory=set)
    token_frequencies: dict = field(default_factory=dict)

    def hash_tables(self):
        """(morph_keys_sorted, morph_size, word_keys_sorted, word_size) int32."""
        from hyptokenizer_tpu_torch.tokenizer.scoring import HKEY_SENT, hash_string

        def table(strings):
            keys = sorted({(h1 * 65536 + h2) for h1, h2 in
                           (hash_string(s) for s in strings)})
            arr = np.asarray(keys + [int(HKEY_SENT)], dtype=np.int32)
            return arr, len(keys)

        mk, ms = table(self.morph_set)
        wk, ws = table(self.word_set)
        return mk, ms, wk, ws

    # Reference-parity predicates (host-side; used by tests and the standalone
    # Hierarchical class surface).
    def is_potential_morpheme(self, token: str) -> bool:
        return token in self.morph_set

    def is_valid_word(self, token: str) -> bool:
        if token in self.word_set:
            return True
        return len(token) >= 3 and bool(_VOWEL_RE.search(token))


def analyze_corpus(lines: Iterable[str], use_wordnet: bool = True,
                   substring_word_threshold: int = 5) -> MorphologyTables:
    """Build validity sets from a corpus (hierarchical_…:110-156 semantics)."""
    word_counter: Counter = Counter()
    subword_counter: Counter = Counter()
    for line in lines:
        words = _WORD_RE.findall(line.lower())
        word_counter.update(words)
        for word in words:
            for n in range(2, min(6, len(word) + 1)):
                for i in range(len(word) - n + 1):
                    subword_counter[word[i:i + n]] += 1

    tables = MorphologyTables(token_frequencies=dict(word_counter))
    if subword_counter:
        thr = np.percentile(list(subword_counter.values()), 80)
        tables.common_morphemes = {s for s, c in subword_counter.items()
                                   if c >= thr}
    if word_counter:
        thr = np.percentile(list(word_counter.values()), 70)
        tables.common_words = {w for w, c in word_counter.items() if c >= thr}

    return _finalize_tables(tables, use_wordnet, substring_word_threshold)


def _finalize_tables(tables: MorphologyTables, use_wordnet: bool = True,
                     substring_word_threshold: int = 5) -> MorphologyTables:
    """Derive morph_set/word_set from the common sets (+ static lists)."""
    lemmas = _wordnet_lemmas() if use_wordnet else set()

    # Frequent-substring fallback (hierarchical_…:195-199): 2-5 char strings
    # appearing in >= threshold common words.
    substr_counts: Counter = Counter()
    for word in tables.common_words:
        seen = set()
        for n in range(2, 6):
            for i in range(len(word) - n + 1):
                seen.add(word[i:i + n])
        substr_counts.update(seen)
    frequent_substrings = {s for s, c in substr_counts.items()
                           if c >= substring_word_threshold}

    tables.morph_set = (tables.common_morphemes | COMMON_PREFIXES
                        | COMMON_SUFFIXES
                        | {l for l in lemmas if len(l) > 2}
                        | frequent_substrings)
    tables.word_set = tables.common_words | lemmas
    return tables


def from_common_sets(common_morphemes: Iterable[str],
                     common_words: Iterable[str],
                     use_wordnet: bool = True) -> MorphologyTables:
    """Rebuild full validity tables from persisted common sets.

    The save artifact (``hierarchical_data.json``) stores only the corpus-
    derived ``common_morphemes``/``common_words`` — the reference schema
    (enhanced_fast_hyperbolic_merge.py:1285-1295). The derived sets (prefix/
    suffix lists, lemmas, frequent substrings) are deterministic functions of
    those, recomputed on load exactly as at analysis time."""
    tables = MorphologyTables(common_morphemes=set(common_morphemes),
                              common_words=set(common_words))
    return _finalize_tables(tables, use_wordnet)


def has_vowel(token: str) -> bool:
    return bool(_VOWEL_RE.search(token))
