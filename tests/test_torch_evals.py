"""The port's tokenizer comparison and baselines (hyptokenizer_tpu_torch/
evals/comparison.py, baselines.py) against the JAX package's, mirroring
``tests/test_evals.py``'s comparison, baseline and SentencePiece tests:
the deterministic numbers must be equal."""

import os

import pytest

from hyptokenizer_tpu.evals import baselines as JB
from hyptokenizer_tpu.evals import comparison as JC
from hyptokenizer_tpu_torch.evals import baselines as TB
from hyptokenizer_tpu_torch.evals import comparison as TC
from hyptokenizer_tpu_torch.evals import (
    compression_efficiency, linguistic_quality, measure_throughput)
from tests.torch_port_common import one_torch_thread  # noqa: F401

TEXTS = ["the walking dog", "a cat sitting quietly",
         "quickly walked the happiness of the kindest dogs"]


def tokenize(text):
    return text.split()


def chars(text):
    return list(text)


def test_comparison_metrics():
    th = measure_throughput(tokenize, TEXTS[:2], runs=2)
    assert th["total_tokens"] == 7
    assert len(th["run_seconds"]) == 2 and th["tokens_per_sec"] > 0
    q = linguistic_quality(tokenize, TEXTS[:2])
    assert q["word_boundary_ratio"] == 1.0
    assert 0 <= q["morpheme_ratio"] <= 1
    c = compression_efficiency(tokenize, TEXTS[:2])
    assert c["chars_per_token"] > 1


@pytest.mark.parametrize("fn", [tokenize, chars])
def test_comparison_matches_jax(fn):
    """Quality and compression are equal; throughput's token count too."""
    assert TC.linguistic_quality(fn, TEXTS) == JC.linguistic_quality(fn, TEXTS)
    assert TC.compression_efficiency(fn, TEXTS) == \
        JC.compression_efficiency(fn, TEXTS)
    got = TC.compare_tokenizers({"t": fn}, TEXTS, runs=1)["t"]
    want = JC.compare_tokenizers({"t": fn}, TEXTS, runs=1)["t"]
    assert got["quality"] == want["quality"]
    assert got["compression"] == want["compression"]
    assert got["throughput"]["total_tokens"] == \
        want["throughput"]["total_tokens"]
    assert set(got["throughput"]) == set(want["throughput"])


def test_baseline_tokenizers_match_jax(tmp_path):
    pytest.importorskip("tokenizers")
    corpus = tmp_path / "c.txt"
    corpus.write_text("\n".join(
        ["the quick brown fox jumps over the lazy dog",
         "walking dogs walk quickly through the park"] * 50))
    kinds = ("bpe", "wordpiece", "unigram", "bytelevel", "char")
    got = TB.train_all_baselines([str(corpus)], str(tmp_path / "t"),
                                 vocab_sizes=(200,), kinds=kinds)
    want = JB.train_all_baselines([str(corpus)], str(tmp_path / "j"),
                                  vocab_sizes=(200,), kinds=kinds)
    assert "bpe_200" in got and "char" in got
    assert got["bpe_200"]["vocab_size"] > 5
    assert set(got) == set(want)
    for name in got:
        assert os.path.exists(got[name]["path"])
        for key in ("vocab_size", "avg_tokens_per_line", "chars_per_token"):
            assert got[name][key] == want[name][key], (name, key)
    assert os.path.exists(tmp_path / "t" / "baseline_stats.json")


def test_sentencepiece_gated_wrapper(tmp_path):
    """The SentencePiece baseline is import-gated as in the JAX package."""
    assert TB.sentencepiece_available() == JB.sentencepiece_available()
    if not TB.sentencepiece_available():
        assert TB.train_sentencepiece(["/dev/null"], 100,
                                      str(tmp_path / "sp")) is None
        return
    corpus = tmp_path / "c.txt"
    corpus.write_text("the cat sat on the mat\nthe dog sat on the log\n" * 50)
    model = TB.train_sentencepiece([str(corpus)], 60, str(tmp_path))
    assert model and os.path.exists(model)
    sp = TB.SentencePieceWrapper(model)
    ids = sp.encode("the cat sat")
    assert ids and sp.decode(ids) == "the cat sat"
    assert sp.get_vocab_size() == 60
    assert sp.tokenize("the cat")
