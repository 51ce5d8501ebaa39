"""tokenize/encode/decode: the inference path.

Port of ``hyptokenizer_tpu/tokenizer/encode.py``. The repo's C++ encoder
(``native/fast_encode.cpp``, built into ``native/libfast_encode.so`` by
``make -C native`` at first use and loaded through ctypes) encodes when it
is available; the pure-Python path gives the same ids, is what
:meth:`Encoder.encode_py` runs, and takes over when the library cannot be
built. Two merge policies:

* ``"fixpoint"`` — the reference's repeated left-to-right scans applying the
  FIRST adjacent pair found in the rule table (``tokenize_py``);
* ``"priority"`` — classic BPE: always the pair of lowest merge rank
  (``tokenize_priority_py``), which reproduces the training trajectory of
  the rank-ordered corpus replay.

An optional ``NormalizerConfig`` normalizes the text and pre-splits it into
segments that merges never cross.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

from hyptokenizer_tpu_torch.tokenizer import normalize as norm_lib
from hyptokenizer_tpu_torch.tokenizer.normalize import NormalizerConfig

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
_NATIVE_PATH = os.path.join(_NATIVE_DIR, "libfast_encode.so")


def ensure_native_built() -> bool:
    """Build the C++ encoder on demand (``make -C native``); False when it
    cannot be built."""
    if os.path.exists(_NATIVE_PATH):
        return True
    if not os.path.exists(os.path.join(_NATIVE_DIR, "fast_encode.cpp")):
        return False
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_NATIVE_PATH)


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


def _offsets(blobs: Sequence[bytes]):
    """The C ABI's (n + 1) int64 offsets of ``blobs`` joined, and their
    total length."""
    n = len(blobs)
    offsets = (ctypes.c_int64 * (n + 1))()
    pos = 0
    for i, b in enumerate(blobs):
        offsets[i] = pos
        pos += len(b)
    offsets[n] = pos
    return offsets, pos


class _NativeEncoder:
    """ctypes binding of ``native/fast_encode.cpp`` (the ``he_*`` C ABI)."""

    def __init__(self, lib_path: str):
        lib = ctypes.CDLL(lib_path)
        lib.he_create.restype = ctypes.c_void_p
        lib.he_create.argtypes = []
        lib.he_destroy.restype = None
        lib.he_destroy.argtypes = [ctypes.c_void_p]
        lib.he_add_rule.restype = None
        lib.he_add_rule.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_char_p]
        lib.he_add_vocab.restype = None
        lib.he_add_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
        lib.he_set_unk.restype = None
        lib.he_set_unk.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.he_set_policy.restype = None
        lib.he_set_policy.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.he_set_presplit.restype = None
        lib.he_set_presplit.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.he_encode.restype = ctypes.c_int
        lib.he_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_int]
        lib.he_encode_batch.restype = ctypes.c_int64
        lib.he_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.he_encode_batch_seg.restype = ctypes.c_int64
        lib.he_encode_batch_seg.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        self._lib = lib
        self._h = lib.he_create()

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.he_destroy(h)

    def load(self, merge_history, token2idx, unk_id,
             merge_policy: str = "fixpoint", presplit_mode: int = 0) -> None:
        """Rules in merge-history order (the C side derives the fixpoint
        table's overwrites and the priority ranks from it), the vocabulary,
        the unknown id, the policy and the native ASCII segmenter
        (1 whitespace, 2 words with space, 0 none)."""
        for a, b, m in merge_history:
            self._lib.he_add_rule(self._h, a.encode(), b.encode(),
                                  m.encode())
        for tok, idx in token2idx.items():
            self._lib.he_add_vocab(self._h, tok.encode(), idx)
        self._lib.he_set_unk(self._h, unk_id)
        if merge_policy == "priority":
            self._lib.he_set_policy(self._h, 1)
        if presplit_mode:
            self._lib.he_set_presplit(self._h, presplit_mode)

    def encode(self, text: str) -> List[int]:
        data = text.encode()
        cap = max(8, len(text) + 1)
        out = (ctypes.c_int * cap)()
        n = self._lib.he_encode(self._h, data, len(data), out, cap)
        if n < 0:
            raise RuntimeError("native encode failed")
        return list(out[:n])

    def encode_batch(self, texts: Sequence[str],
                     n_threads: int = 0) -> List[List[int]]:
        """One threaded C call for the whole list."""
        if not texts:
            return []
        blobs = [t.encode() for t in texts]
        n = len(blobs)
        offsets, pos = _offsets(blobs)
        cap = max(8, pos)   # tokens <= code points <= bytes
        out = (ctypes.c_int * cap)()
        out_offsets = (ctypes.c_int64 * (n + 1))()
        total = self._lib.he_encode_batch(self._h, b"".join(blobs), offsets,
                                          n, n_threads, out, out_offsets,
                                          cap)
        if total < 0:
            raise RuntimeError("native batch encode failed")
        flat = out[:total]
        return [flat[out_offsets[i]:out_offsets[i + 1]] for i in range(n)]

    def encode_batch_seg(self, texts: Sequence[str],
                         seg_starts_lists: Sequence[Sequence[int]],
                         n_threads: int = 0) -> List[List[int]]:
        """Batch encode in which no merge crosses a segment start (byte
        offsets, so ASCII text: a character offset is a byte offset)."""
        blobs = [t.encode() for t in texts]
        n = len(blobs)
        offsets, pos = _offsets(blobs)
        n_starts = sum(len(st) for st in seg_starts_lists)
        seg_starts = (ctypes.c_int64 * max(1, n_starts))()
        seg_ptr = (ctypes.c_int64 * (n + 1))()
        k = 0
        for i, starts in enumerate(seg_starts_lists):
            seg_ptr[i] = k
            for st in starts:
                seg_starts[k] = st
                k += 1
        seg_ptr[n] = k
        cap = max(8, pos)
        out = (ctypes.c_int * cap)()
        out_offsets = (ctypes.c_int64 * (n + 1))()
        total = self._lib.he_encode_batch_seg(
            self._h, b"".join(blobs), offsets, n, n_threads, seg_starts,
            seg_ptr, out, out_offsets, cap)
        if total < 0:
            raise RuntimeError("native batch encode failed")
        flat = out[:total]
        return [flat[out_offsets[i]:out_offsets[i + 1]] for i in range(n)]


class Encoder:
    """tokenize/encode/decode with the reference's semantics, through the
    native encoder when it is available (``use_native=None`` builds it on
    demand)."""

    def __init__(self, vocab: Sequence[str],
                 merge_history: Sequence[Tuple[str, str, str]],
                 use_native: Optional[bool] = None,
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
        # The two canonical pre-split patterns have a native ASCII
        # segmenter. The primary handle never segments, so that non-ASCII
        # text and other patterns, split here, never reach the ASCII-only
        # segmenter; the presplit handle serves ASCII text only.
        self._native_presplit = 0
        if normalizer is not None and normalizer.pre_split is not None:
            self._native_presplit = {
                norm_lib.WHITESPACE: 1,
                norm_lib.WORDS_WITH_SPACE: 2,
            }.get(normalizer.pre_split, 0)
        self._native = None
        self._native_pre = None
        if use_native is None:
            use_native = ensure_native_built()
        if use_native:
            try:
                native = _NativeEncoder(_NATIVE_PATH)
                native.load(self.merge_history, self.token2idx, self.unk_id,
                            merge_policy=self.merge_policy)
                pre = None
                if self._native_presplit:
                    pre = _NativeEncoder(_NATIVE_PATH)
                    pre.load(self.merge_history, self.token2idx, self.unk_id,
                             merge_policy=self.merge_policy,
                             presplit_mode=self._native_presplit)
                self._native, self._native_pre = native, pre
            except (OSError, AttributeError):
                # No library, or one without the full C ABI: Python path.
                pass

    @property
    def native_available(self) -> bool:
        return self._native is not None

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
        if self._native is None:
            return self.encode_py(text)
        if self.normalizer is None:
            return self._native.encode(text)
        normed = norm_lib.normalize(text, self.normalizer)
        if self._native_pre is not None and normed.isascii():
            return self._native_pre.encode(normed)
        segs = (list(norm_lib.segments(normed, self.normalizer.pre_split))
                if self.normalizer.pre_split else [normed])
        out: List[int] = []
        for seg in segs:
            out.extend(self._native.encode(seg))
        return out

    def encode_batch(self, texts: Sequence[str],
                     n_threads: int = 0) -> List[List[int]]:
        """``[self.encode(t) for t in texts]``, in one native call
        (threaded across texts) when the native encoder is available."""
        if self._native is None:
            return [self.encode_py(t) for t in texts]
        if self.normalizer is None:
            return self._native.encode_batch(texts, n_threads=n_threads)
        normed = [norm_lib.normalize(t, self.normalizer) for t in texts]
        if self.normalizer.pre_split and all(t.isascii() for t in normed):
            # ASCII: the canonical patterns segment in C++; any other
            # pattern hands over its segment boundaries.
            if self._native_pre is not None:
                return self._native_pre.encode_batch(normed,
                                                     n_threads=n_threads)
            starts = [norm_lib.segment_starts(t, self.normalizer.pre_split)
                      for t in normed]
            return self._native.encode_batch_seg(normed, starts,
                                                 n_threads=n_threads)
        seg_lists = [norm_lib.apply(t, self.normalizer) for t in texts]
        enc = self._native.encode_batch([s for segs in seg_lists
                                         for s in segs], n_threads=n_threads)
        out: List[List[int]] = []
        pos = 0
        for segs in seg_lists:
            ids: List[int] = []
            for seg_ids in enc[pos:pos + len(segs)]:
                ids.extend(seg_ids)
            pos += len(segs)
            out.append(ids)
        return out

    def encode_py(self, text: str) -> List[int]:
        """The pure-Python path."""
        return [self.token2idx.get(t, self.unk_id)
                for t in self.tokenize(text)]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.vocab[i] for i in ids)
