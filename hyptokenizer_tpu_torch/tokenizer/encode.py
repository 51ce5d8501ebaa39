"""tokenize/encode/decode: the pure-Python inference path.

Port of ``hyptokenizer_tpu/tokenizer/encode.py`` without its ctypes
binding to ``native/fast_encode.cpp`` (host code, to be ported later; the
Python path gives the same ids). Two merge policies:

* ``"fixpoint"`` — the reference's repeated left-to-right scans applying the
  FIRST adjacent pair found in the rule table (``tokenize_py``);
* ``"priority"`` — classic BPE: always the pair of lowest merge rank
  (``tokenize_priority_py``), which reproduces the training trajectory of
  the rank-ordered corpus replay.

An optional ``NormalizerConfig`` normalizes the text and pre-splits it into
segments that merges never cross.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from hyptokenizer_tpu_torch.tokenizer import normalize as norm_lib
from hyptokenizer_tpu_torch.tokenizer.normalize import NormalizerConfig

UNK_TOKEN = "<unk>"
UNK_FALLBACK_ID = 3  # reference hyperbolic_merge.py:459


def build_merge_rules(merge_history: Sequence[Tuple[str, str, str]]
                      ) -> Dict[Tuple[str, str], str]:
    """{(left, right): merged}; a later duplicate pair overwrites."""
    return {(a, b): m for a, b, m in merge_history}


def tokenize_priority_py(text: str,
                         rule_ranks: Dict[Tuple[str, str], Tuple[int, str]]
                         ) -> List[str]:
    """Repeatedly merge the adjacent pair of LOWEST rank, leftmost first."""
    tokens = list(text)
    while len(tokens) > 1:
        best_rank = None
        best_i = -1
        for i in range(len(tokens) - 1):
            r = rule_ranks.get((tokens[i], tokens[i + 1]))
            if r is not None and (best_rank is None or r[0] < best_rank):
                best_rank = r[0]
                best_i = i
        if best_rank is None:
            break
        tokens[best_i] = rule_ranks[(tokens[best_i], tokens[best_i + 1])][1]
        tokens.pop(best_i + 1)
    return tokens


def tokenize_py(text: str, merge_rules: Dict[Tuple[str, str], str]
                ) -> List[str]:
    """Reference-semantics fixpoint tokenizer (first match per scan)."""
    tokens = list(text)
    changed = True
    while changed:
        changed = False
        i = 0
        while i < len(tokens) - 1:
            merged = merge_rules.get((tokens[i], tokens[i + 1]))
            if merged is not None:
                tokens[i] = merged
                tokens.pop(i + 1)
                changed = True
            else:
                i += 1
    return tokens


class Encoder:
    """tokenize/encode/decode with the reference's semantics."""

    def __init__(self, vocab: Sequence[str],
                 merge_history: Sequence[Tuple[str, str, str]],
                 normalizer: Optional[NormalizerConfig] = None,
                 merge_policy: str = "fixpoint"):
        if merge_policy not in ("fixpoint", "priority"):
            raise ValueError(f"unknown merge_policy {merge_policy!r}")
        self.normalizer = normalizer
        self.merge_policy = merge_policy
        self.vocab = list(vocab)
        self.merge_history = [tuple(m) for m in merge_history]
        self.merge_rules = build_merge_rules(self.merge_history)
        # Priority mode: the first occurrence of a pair holds its rank.
        self.rule_ranks: Dict[Tuple[str, str], Tuple[int, str]] = {}
        for k, (a, b, m) in enumerate(self.merge_history):
            self.rule_ranks.setdefault((a, b), (k, m))
        self.token2idx = {t: i for i, t in enumerate(self.vocab)}
        self.unk_id = self.token2idx.get(UNK_TOKEN, UNK_FALLBACK_ID)

    def _tokenize_seg(self, seg: str) -> List[str]:
        if self.merge_policy == "priority":
            return tokenize_priority_py(seg, self.rule_ranks)
        return tokenize_py(seg, self.merge_rules)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for seg in norm_lib.apply(text, self.normalizer):
            out.extend(self._tokenize_seg(seg))
        return out

    def encode(self, text: str) -> List[int]:
        return [self.token2idx.get(t, self.unk_id)
                for t in self.tokenize(text)]

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.vocab[i] for i in ids)
