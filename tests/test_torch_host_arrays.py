"""The constructor's host work in array form against its loop oracles, on
the CPU: ``morphology.analyze_corpus`` (n-grams counted once per distinct
word) against ``analyze_corpus_py`` (one count per occurrence), and
``data.shard_align_corpus`` (bucket by bucket) against
``shard_align_corpus_py`` (segment by segment). Every comparison is exact.
"""

import os
import random
from collections import Counter

import numpy as np
import pytest

from hyptokenizer_tpu_torch.tokenizer import normalize as TN
from hyptokenizer_tpu_torch.utils import data as TD
from hyptokenizer_tpu_torch.utils import morphology as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIKI = os.path.join(REPO, "data", "wiki_corpus.txt.bz2")


def _wiki_lines(start: int, count: int):
    lines = TD.read_corpus_lines(WIKI)[start:start + count]
    assert len(lines) == count
    return lines


def _short_words():
    rng = random.Random(7)
    return [" ".join("".join(rng.choice("abcab") for _ in range(
        rng.randrange(1, 8))) for _ in range(rng.randrange(0, 12)))
        for _ in range(300)]


MORPH_CASES = {
    "wiki_500": lambda: _wiki_lines(1000, 500),
    "unicode_digits_underscore": lambda: [
        "Ünïcödé  tabs\tand_underscores 42x", "ΣΟΦΙΑ σοφός ΟΔΟΣ",
        "日本語のテキスト 東京 2024年", "İstanbul naïve_café __init__ x_1",
        "der Straße STRASSE ﬁne ½ ²³ ٣٤٥", "emoji 🙂🙂 ok", "a_b_c 0_0 9"] * 3,
    "empty_lines": lambda: ["", "", "one two", "", "   ", "\t", "two"],
    "only_empty_lines": lambda: ["", "   ", "..."],
    "words_1_to_7": _short_words,
    "heavy_repeats": lambda: (["the the the aaaaaaa aaaa abab ababab"] * 200
                              + ["aa a", "zzzzz zz"] * 50),
    "wide_alphabet": lambda: ["".join(chr(0x4E00 + (i * 7919 + j) % 20000)
                                      for j in range(i % 9 + 1))
                              + " " + chr(0x10000 + i) * 3
                              for i in range(400)],
}


def _subword_counts_py(lines):
    return Counter(w[i:i + n] for line in lines
                   for w in TM._WORD_RE.findall(line.lower())
                   for n in range(2, 6) for i in range(len(w) - n + 1))


@pytest.mark.parametrize("case", sorted(MORPH_CASES))
def test_analyze_corpus_matches_per_occurrence_oracle(case):
    lines = MORPH_CASES[case]()
    got = TM.analyze_corpus(lines, use_wordnet=False)
    want = TM.analyze_corpus_py(lines, use_wordnet=False)
    assert got.token_frequencies == want.token_frequencies
    assert got.common_morphemes == want.common_morphemes
    assert got.common_words == want.common_words
    assert got.morph_set == want.morph_set
    assert got.word_set == want.word_set
    for x, y in zip(got.hash_tables(), want.hash_tables()):
        np.testing.assert_array_equal(x, y)
    # Every count, not only those that cross a percentile.
    assert (TM._subword_counts(Counter(got.token_frequencies))
            == _subword_counts_py(lines))


def _packed(segment_lengths, n, sep=-2, tail=0):
    """A corpus of SEP-terminated segments of the given lengths (and an
    unterminated tail), PAD-filled to ``n``."""
    ids = []
    for k, length in enumerate(segment_lengths):
        ids += [k % 50] * (length - 1) + [sep]
    ids += [7] * tail
    arr = np.full((n,), -1, np.int32)
    arr[:len(ids)] = ids[:n]
    return arr


def _wiki_encoded(n):
    lines = _wiki_lines(0, 200)
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + sorted(
        {c for t in lines for c in t})
    return TD.encode_corpus_chars(lines, vocab, n,
                                  pre_split=TN.WORDS_WITH_SPACE)


SHARD_CASES = {
    **{f"wiki_{k}_shards": (lambda k=k: (_wiki_encoded(8400), k))
       for k in range(1, 9)},
    # A segment longer than a bucket, starting part-way into one.
    "segment_longer_than_bucket": lambda: (_packed([3, 25, 4, 2], 40), 4),
    "segments_fill_buckets_exactly": lambda: (_packed([4, 6, 10, 5, 5], 40), 4),
    # A segment of exactly a bucket's length moves whole, not split.
    "bucket_long_segment_moves": lambda: (_packed([4, 10, 3], 40), 4),
    "no_sep": lambda: (_packed([], 64, tail=50), 8),
    "no_sep_full": lambda: (_packed([], 64, tail=64), 8),
    "runs_out_of_buckets": lambda: (_packed([7] * 12, 48), 6),
    "long_segment_runs_out": lambda: (_packed([2, 60], 48), 4),
    "length_not_divisible": lambda: (_packed([3, 4, 5], 30), 4),
    "empty": lambda: (np.full((32,), -1, np.int32), 4),
    "only_seps": lambda: (_packed([1] * 20, 32), 4),
}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shard_align_corpus_matches_segment_loop(case):
    arr, n_shards = SHARD_CASES[case]()
    got = TD.shard_align_corpus(arr, n_shards, pad_id=-1, sep_id=-2)
    want = TD.shard_align_corpus_py(arr, n_shards, pad_id=-1, sep_id=-2)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_shard_align_corpus_matches_segment_loop_fuzzed():
    rng = np.random.default_rng(3)
    for _ in range(2000):
        n_shards = int(rng.integers(1, 9))
        n = n_shards * int(rng.integers(1, 12)) + int(rng.random() < 0.1)
        used = int(rng.integers(0, n + 1))
        arr = np.full((n,), -1, np.int32)
        arr[:used] = np.where(rng.random(used) < rng.random() * 0.6, -2,
                              rng.integers(0, 9, used))
        np.testing.assert_array_equal(
            TD.shard_align_corpus(arr, n_shards),
            TD.shard_align_corpus_py(arr, n_shards), err_msg=str(arr))
