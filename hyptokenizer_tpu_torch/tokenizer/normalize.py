"""Copy of ``hyptokenizer_tpu/tokenizer/normalize.py``
(the port imports nothing of the JAX package).

Configurable Unicode normalization and regex pre-splitting for the
encode path.

The reference performs text normalization only upstream, in corpus
preprocessing (`scripts/preprocess_wiki.py:30-52` — NFC, lowercase, strip to
`[a-z0-9 .,]`, whitespace collapse); its tokenizer consumes raw characters and
merges may cross any boundary (`tokenizer/hyperbolic_merge.py:414-446`). This
module folds those semantics into the tokenizer itself as *opt-in* features
(SURVEY §7.4): a `NormalizerConfig` attached to an `Encoder` applies Unicode
normalization before the character split, and an optional regex pre-split
partitions the text into segments that merges may not cross (the role the
Whitespace pre-tokenizer plays for the BPE baselines,
`scripts/train_baseline_tokenizers.py:70-364` — except lossless: every
character, including separators, remains part of exactly one segment).

Defaults are all-off: a default-constructed Encoder stays byte-identical to
the reference semantics (tests/test_conformance.py).
"""

from __future__ import annotations

import dataclasses
import re
import unicodedata
from typing import Iterator, List, Optional

from hyptokenizer_tpu_torch.utils.data import clean_text

# Lossless whitespace pre-split: runs of non-space and runs of space are
# separate segments, so merges never bridge a word boundary but spaces are
# still tokenized (and decode reconstructs the text exactly).
WHITESPACE = r"\S+|\s+"
# Word-ish pre-split in the spirit of GPT-2's pattern, losslessly: a leading
# space attaches to the following word (" the" style tokens), punctuation
# runs and residual whitespace are their own segments.
WORDS_WITH_SPACE = r"\s?[^\W\d_]+|\s?\d+|\s?[^\w\s]+|\s+"

_FORMS = ("NFC", "NFD", "NFKC", "NFKD")


@dataclasses.dataclass(frozen=True)
class NormalizerConfig:
    """Opt-in text canonicalization applied before the character split.

    form: Unicode normalization form (NFC/NFD/NFKC/NFKD) or None.
    lowercase: casefold to lowercase after normalization.
    strip_accents: drop combining marks (NFD-decompose first, as the HF
        baseline normalizer chain does — train_baseline_tokenizers.py:80-84).
    clean: the reference's full `clean_text` corpus recipe
        (preprocess_wiki.py:30-52); implies NFC+lowercase and restricts the
        alphabet to `[a-z0-9 .,]`, so it is NOT lossless.
    pre_split: regex whose matches partition the text into segments merges
        cannot cross. Must tile the text completely (see `segments`); gaps
        between matches are kept as their own segments so the partition is
        always lossless.
    """

    form: Optional[str] = None
    lowercase: bool = False
    strip_accents: bool = False
    clean: bool = False
    pre_split: Optional[str] = None

    def __post_init__(self):
        if self.form is not None and self.form not in _FORMS:
            raise ValueError(f"form must be one of {_FORMS}, got {self.form!r}")
        if self.pre_split is not None:
            re.compile(self.pre_split)  # fail fast on bad patterns

    @property
    def is_noop(self) -> bool:
        return not (self.form or self.lowercase or self.strip_accents
                    or self.clean or self.pre_split)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Optional[dict]) -> Optional["NormalizerConfig"]:
        if not d:
            return None
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def normalize(text: str, config: NormalizerConfig) -> str:
    """Apply the configured canonicalization (without pre-splitting)."""
    if config.clean:
        return clean_text(text)
    if config.form:
        text = unicodedata.normalize(config.form, text)
    if config.strip_accents:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if not unicodedata.combining(c))
    if config.lowercase:
        text = text.lower()
    return text


def segments(text: str, pattern: str) -> Iterator[str]:
    """Lossless partition of ``text`` by ``pattern`` matches.

    Every regex match is a segment; any characters between/around matches
    form their own segments. Invariant: ``"".join(segments(t, p)) == t`` for
    every text and pattern (tested property).
    """
    pos = 0
    for m in re.finditer(pattern, text):
        if m.start() > pos:
            yield text[pos:m.start()]
        if m.end() > m.start():  # skip zero-width matches
            yield m.group()
        pos = max(pos, m.end())
    if pos < len(text):
        yield text[pos:]


def segment_starts(text: str, pattern: str) -> List[int]:
    """Character offsets where the segments of ``segments()`` begin.

    Equivalent to accumulating ``len(seg)`` over ``segments(text, pattern)``
    without building the substrings — the zero-allocation form used by the
    native batch encoder (byte offsets == char offsets for ASCII text).
    """
    starts: List[int] = []
    pos = 0
    for m in re.finditer(pattern, text):
        if m.start() > pos:
            starts.append(pos)
        if m.end() > m.start():
            starts.append(m.start())
        pos = max(pos, m.end())
    if pos < len(text):
        starts.append(pos)
    return starts


def apply(text: str, config: Optional[NormalizerConfig]) -> List[str]:
    """Normalize then pre-split: the segment list the encoder tokenizes.

    With no config (or a no-op one) returns ``[text]`` — a single segment,
    i.e. exact reference semantics.
    """
    if config is None:
        return [text]
    text = normalize(text, config)
    if config.pre_split:
        return list(segments(text, config.pre_split))
    return [text]
