"""Tokenizer comparison metrics: throughput, linguistic quality, compression.

Port of ``hyptokenizer_tpu/evals/comparison.py``, the port's own copy of
that pure-Python module (it imports nothing of the JAX package). Works with
any object exposing ``tokenize(text) -> List[str]``: the port's tokenizers,
HF ``tokenizers`` adapters, etc. Tokenizing and encoding run on the host
(the native encoder or the Python path), so the numbers are the host's.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, Iterable, List

MORPHEME_SUFFIXES = ("ing", "ed", "er", "est", "ly", "ity", "ment", "ness",
                     "able", "ible", "al", "ial", "s")


def measure_throughput(tokenize: Callable[[str], List[str]],
                       texts: List[str], runs: int = 3,
                       warmup: int = 1) -> Dict[str, float]:
    """tokens/sec and chars/sec averaged over ``runs`` (3-run protocol of
    compare_tokenizers.py:95-221; warmup iterations as benchmark_efficiency
    .py:58-94)."""
    for _ in range(warmup):
        for t in texts[: min(8, len(texts))]:
            tokenize(t)
    totals = []
    n_tokens = 0
    n_chars = sum(len(t) for t in texts)
    for _ in range(runs):
        t0 = time.perf_counter()
        n_tokens = 0
        for t in texts:
            n_tokens += len(tokenize(t))
        totals.append(time.perf_counter() - t0)
    avg = sum(totals) / len(totals)
    var = sum((t - avg) ** 2 for t in totals) / len(totals)
    return {
        "tokens_per_sec": n_tokens / avg if avg > 0 else float("inf"),
        "chars_per_sec": n_chars / avg if avg > 0 else float("inf"),
        "total_tokens": n_tokens,
        "avg_seconds": avg,
        # Per-run variance surfaced as the reference reports it
        # (compare_tokenizers.py's 3-run protocol averages with spread).
        "std_seconds": var ** 0.5,
        "run_seconds": totals,
    }


def linguistic_quality(tokenize: Callable[[str], List[str]],
                       texts: List[str]) -> Dict[str, float]:
    """Regex-based quality ratios (compare_tokenizers.py:224-289)."""
    n_tokens = 0
    morpheme_like = 0
    word_boundary = 0
    subword = 0
    for text in texts:
        words = set(re.findall(r"\b\w+\b", text.lower()))
        for tok in tokenize(text):
            n_tokens += 1
            stripped = tok.strip()
            if any(stripped.endswith(s) for s in MORPHEME_SUFFIXES) and \
                    len(stripped) > 2:
                morpheme_like += 1
            if stripped in words:
                word_boundary += 1
            elif stripped and any(stripped in w for w in words):
                subword += 1
    n = max(n_tokens, 1)
    return {
        "morpheme_ratio": morpheme_like / n,
        "word_boundary_ratio": word_boundary / n,
        "subword_ratio": subword / n,
        "total_tokens": n_tokens,
    }


def compression_efficiency(tokenize: Callable[[str], List[str]],
                           texts: List[str]) -> Dict[str, float]:
    """chars/token and bytes-per-token estimate (compare_tokenizers.py:292-329)."""
    n_chars = 0
    n_tokens = 0
    for text in texts:
        n_chars += len(text)
        n_tokens += len(tokenize(text))
    n = max(n_tokens, 1)
    return {
        "chars_per_token": n_chars / n,
        "compression_ratio": n_chars / (n * 2),  # :321 formula
        "total_chars": n_chars,
        "total_tokens": n_tokens,
    }


def compare_tokenizers(tokenizers: Dict[str, Callable[[str], List[str]]],
                       texts: List[str], runs: int = 3) -> Dict[str, Dict]:
    """Full comparison grid over named tokenize callables."""
    out = {}
    for name, tok in tokenizers.items():
        out[name] = {
            "throughput": measure_throughput(tok, texts, runs=runs),
            "quality": linguistic_quality(tok, texts),
            "compression": compression_efficiency(tok, texts),
        }
    return out
