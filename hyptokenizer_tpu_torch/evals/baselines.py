"""Baseline tokenizer training (BPE / WordPiece / Unigram / char-level).

Port of ``hyptokenizer_tpu/evals/baselines.py``, the port's own copy: each
baseline uses the HF ``tokenizers`` (Rust, CPU) library with an
NFD+Lowercase+StripAccents normalizer, Whitespace pre-tokenizer and a
CLS/SEP template post-processor; the char-level baseline injects its vocab
directly. ``tokenizers`` and ``sentencepiece`` are imported inside the
functions that use them, so importing this module needs neither;
``sentencepiece_available`` gates the SentencePiece baseline. Baselines
exist for comparison only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional

SPECIALS = ["[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]"]


def _base_tokenizer(model):
    from tokenizers import Tokenizer, normalizers, pre_tokenizers
    tok = Tokenizer(model)
    tok.normalizer = normalizers.Sequence([
        normalizers.NFD(), normalizers.Lowercase(), normalizers.StripAccents()])
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return tok


def _add_template(tok):
    from tokenizers import processors
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]",
        pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", tok.token_to_id("[CLS]")),
                        ("[SEP]", tok.token_to_id("[SEP]"))],
    )


def train_bpe(files: List[str], vocab_size: int):
    from tokenizers import models, trainers
    tok = _base_tokenizer(models.BPE(unk_token="[UNK]"))
    trainer = trainers.BpeTrainer(vocab_size=vocab_size,
                                  special_tokens=SPECIALS)
    tok.train(files, trainer)
    _add_template(tok)
    return tok


def train_bytelevel_bpe(files: List[str], vocab_size: int):
    """GPT-2-style byte-level BPE: LOSSLESS on this corpus (spaces survive
    as U+0120-marked bytes; decode reconstructs the text exactly). The fair
    Rust-library baseline for the framework's lossless tokenizers — the
    Whitespace pre-tokenizer variant above DROPS spaces (18% of corpus
    chars) and its decode cannot reconstruct the input.

    Caveat (ADVICE r3): the shared NFD+Lowercase+StripAccents normalizer
    (kept for comparability with every other baseline here) makes decode
    lossless only up to case folding and accent stripping — exact on the
    benchmark's preprocessed wiki corpus, which is 100% lowercase ASCII,
    but not on arbitrary text.
    """
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, \
        trainers
    from tokenizers import decoders
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.normalizer = normalizers.Sequence([
        normalizers.NFD(), normalizers.Lowercase(), normalizers.StripAccents()])
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train(files, trainer)
    _add_template(tok)
    return tok


def train_wordpiece(files: List[str], vocab_size: int):
    from tokenizers import models, trainers
    tok = _base_tokenizer(models.WordPiece(unk_token="[UNK]"))
    trainer = trainers.WordPieceTrainer(vocab_size=vocab_size,
                                        special_tokens=SPECIALS)
    tok.train(files, trainer)
    _add_template(tok)
    return tok


def train_unigram(files: List[str], vocab_size: int):
    from tokenizers import models, trainers
    tok = _base_tokenizer(models.Unigram())
    trainer = trainers.UnigramTrainer(vocab_size=vocab_size,
                                      special_tokens=SPECIALS,
                                      unk_token="[UNK]")
    tok.train(files, trainer)
    _add_template(tok)
    return tok


def train_char_level(files: List[str], vocab_size: int = 0):
    """Char-level baseline via direct vocab injection
    (train_baseline_tokenizers.py:367-462)."""
    from tokenizers import Tokenizer, models
    chars = set()
    for path in files:
        with open(path, encoding="utf-8") as f:
            for line in f:
                chars.update(line.strip().lower())
    vocab = {tok: i for i, tok in enumerate(SPECIALS)}
    for ch in sorted(chars):
        if ch not in vocab:
            vocab[ch] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    from tokenizers import pre_tokenizers
    # Split into single chars via a regex pre-tokenizer.
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    return tok


TRAINERS = {
    "bpe": train_bpe,
    "bytelevel": train_bytelevel_bpe,
    "wordpiece": train_wordpiece,
    "unigram": train_unigram,
    "char": train_char_level,
}


def sentencepiece_available() -> bool:
    try:
        import sentencepiece  # noqa: F401
        return True
    except ImportError:
        return False


class SentencePieceWrapper:
    """External SentencePiece baseline (reference
    benchmark_efficiency.py:97-123, train_nlp_tasks.py:82-84). Import-gated:
    the package is an optional external baseline, never a framework
    dependency — ``sentencepiece_available()`` reports whether this wrapper
    can be constructed."""

    def __init__(self, model_path: str):
        import sentencepiece as spm
        self.tokenizer = spm.SentencePieceProcessor()
        self.tokenizer.load(model_path)

    def tokenize(self, text: str) -> List[str]:
        return self.tokenizer.encode_as_pieces(text)

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode_as_ids(text)

    def decode(self, ids: List[int]) -> str:
        return self.tokenizer.decode_ids(list(ids))

    def get_vocab_size(self) -> int:
        return self.tokenizer.get_piece_size()


def train_sentencepiece(files: List[str], vocab_size: int, output_dir: str,
                        model_type: str = "bpe") -> Optional[str]:
    """Train a SentencePiece baseline model; None when the package is absent
    (graceful degradation — the comparison harness skips the row)."""
    if not sentencepiece_available():
        return None
    import sentencepiece as spm
    os.makedirs(output_dir, exist_ok=True)
    prefix = os.path.join(output_dir, f"sp_{model_type}_{vocab_size}")
    spm.SentencePieceTrainer.train(
        input=",".join(files), model_prefix=prefix,
        vocab_size=vocab_size, model_type=model_type)
    return prefix + ".model"


def train_all_baselines(files: List[str], output_dir: str,
                        vocab_sizes: Iterable[int] = (10_000, 20_000, 50_000),
                        kinds: Iterable[str] = ("bpe", "wordpiece", "unigram",
                                                "char")) -> Dict[str, Dict]:
    """Grid over tokenizer kinds x vocab sizes with per-tokenizer stats JSON
    (train_baseline_tokenizers.py:514-568)."""
    os.makedirs(output_dir, exist_ok=True)
    results = {}
    sample = []
    with open(files[0], encoding="utf-8") as f:
        for i, line in enumerate(f):
            sample.append(line.strip())
            if i >= 200:
                break
    for kind in kinds:
        sizes = [0] if kind == "char" else vocab_sizes
        for vs in sizes:
            name = f"{kind}_{vs}" if kind != "char" else "char"
            t0 = time.perf_counter()
            tok = TRAINERS[kind](files, vs)
            train_time = time.perf_counter() - t0
            path = os.path.join(output_dir, f"{name}.json")
            tok.save(path)
            n_tokens = sum(len(tok.encode(s).tokens) for s in sample if s)
            n_chars = sum(len(s) for s in sample)
            results[name] = {
                "vocab_size": tok.get_vocab_size(),
                "training_time_sec": train_time,
                "avg_tokens_per_line": n_tokens / max(len(sample), 1),
                "chars_per_token": n_chars / max(n_tokens, 1),
                "path": path,
            }
    with open(os.path.join(output_dir, "baseline_stats.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results
