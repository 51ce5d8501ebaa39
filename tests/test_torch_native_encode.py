"""The port's native encoder (``tokenizer/encode.py``'s ctypes binding of
``native/fast_encode.cpp``) against its pure-Python path and against the
JAX package's ``Encoder``.

The cases of ``tests/test_native_encode.py``, parametrised, on the port's
``Encoder``, each also held to the JAX package's ``Encoder`` on the same
rules and texts; then the committed 50k artifacts of ``work_r5/``: loaded
into the port (``device="cpu"``), their encodes of ``work_r5/val.txt`` are
identical on the port's native path, its Python path, and the JAX
package's native and Python paths. Ids are compared exactly.
"""

import os
import random
import string

import pytest

from hyptokenizer_tpu.tokenizer import encode as JE
from hyptokenizer_tpu.tokenizer.normalize import NormalizerConfig as JNC
from hyptokenizer_tpu_torch.tokenizer import encode as TE
from hyptokenizer_tpu_torch.tokenizer import normalize as TN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, "work_r5")


@pytest.fixture(scope="module")
def native():
    """Builds the library when it is missing (``make -C native``)."""
    if not TE.ensure_native_built():
        pytest.skip("the native encoder cannot be built here")


def build_random_tokenizer(rng, n_chars=8, n_merges=30):
    chars = list(string.ascii_lowercase[:n_chars]) + [" "]
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    merges = []
    for _ in range(n_merges):
        a = rng.choice(vocab[4:])
        b = rng.choice(vocab[4:])
        merges.append((a, b, a + b))
        vocab.append(a + b)
    return vocab, merges


def pair(vocab, merges, policy="fixpoint", pattern=None, **norm):
    """The port's native encoder and the JAX package's, same rules."""
    tn = jn = None
    if pattern is not None or norm:
        tn = TN.NormalizerConfig(pre_split=pattern, **norm)
        jn = JNC(pre_split=pattern, **norm)
    t = TE.Encoder(vocab, merges, use_native=True, normalizer=tn,
                   merge_policy=policy)
    j = JE.Encoder(vocab, merges, use_native=True, normalizer=jn,
                   merge_policy=policy)
    assert t.native_available and j.native_available
    return t, j


@pytest.mark.parametrize("policy", ["fixpoint", "priority"])
@pytest.mark.parametrize("seed", [7, 23])
def test_fuzz_native_matches_python_and_jax(native, policy, seed):
    rng = random.Random(seed)
    for trial in range(8):
        vocab, merges = build_random_tokenizer(rng, n_merges=40)
        t, j = pair(vocab, merges, policy)
        for _ in range(20):
            text = "".join(rng.choice("abcdefgh xyz")
                           for _ in range(rng.randint(0, 60)))
            assert t.encode(text) == t.encode_py(text) == j.encode(text), \
                (trial, text)


def test_native_unicode(native):
    vocab = ["<unk>", "é", "ü", "éü", "a"]
    t, j = pair(vocab, [("é", "ü", "éü")])
    assert t.encode("éüa") == t.encode_py("éüa") == j.encode("éüa") \
        == [3, 4]
    assert t.encode("日本") == t.encode_py("日本") == [0, 0]


def test_native_multipass_semantics(native):
    vocab = ["a", "b", "c", "d", "bc", "abc", "bcd", "<unk>"]
    merges = [("b", "c", "bc"), ("a", "bc", "abc"), ("bc", "d", "bcd")]
    t, _ = pair(vocab, merges)
    assert t.tokenize("abcd") == ["a", "bcd"]
    assert t.encode("abcd") == t.encode_py("abcd") == [0, 6]


def test_native_empty_and_long(native):
    t, _ = pair(["a", "b", "ab", "<unk>"], [("a", "b", "ab")])
    assert t.encode("") == []
    assert t.encode("ab" * 50_000) == [2] * 50_000


@pytest.mark.parametrize("policy", ["fixpoint", "priority"])
def test_batch_matches_single(native, policy):
    rng = random.Random(11)
    vocab, merges = build_random_tokenizer(rng, n_merges=60)
    t, j = pair(vocab, merges, policy)
    texts = ["".join(rng.choice("abcdefgh xyz")
                     for _ in range(rng.randint(0, 80)))
             for _ in range(200)] + ["", "日本 ab"]
    expect = [t.encode_py(x) for x in texts]
    assert [t.encode(x) for x in texts] == expect
    for n_threads in (0, 1, 4):
        assert t.encode_batch(texts, n_threads=n_threads) == expect
    assert j.encode_batch(texts) == expect
    assert t.encode_batch([]) == []


def test_batch_with_normalizer(native):
    vocab, merges = build_random_tokenizer(random.Random(3), n_merges=40)
    t, j = pair(vocab, merges, pattern=TN.WHITESPACE, lowercase=True)
    texts = ["AB cd  EF", "", "gh", "  a  "]
    expect = [t.encode_py(x) for x in texts]
    assert t.encode_batch(texts) == [t.encode(x) for x in texts] == expect
    assert j.encode_batch(texts) == expect


def test_native_throughput_exceeds_python(native):
    import time
    vocab, merges = build_random_tokenizer(random.Random(1), n_merges=100)
    t, _ = pair(vocab, merges)
    text = "".join(random.Random(2).choice("abcdefgh ")
                   for _ in range(200_000))
    t0 = time.perf_counter()
    ids_n = t.encode(text)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids_p = t.encode_py(text)
    t_py = time.perf_counter() - t0
    assert ids_n == ids_p
    assert t_native < t_py


def test_priority_mode_differs_and_matches_ranks(native):
    vocab = [" ", "t", "h", "e", " t", "he", " th", " the", "<unk>"]
    merges = [(" ", "t", " t"), ("h", "e", "he"), (" t", "h", " th"),
              (" t", "he", " the")]
    fix, _ = pair(vocab, merges)
    pri, _ = pair(vocab, merges, "priority")
    assert fix.tokenize(" the") == [" th", "e"]
    assert pri.tokenize(" the") == [" the"]
    assert pri.encode(" the") == pri.encode_py(" the")
    assert fix.encode(" the") == fix.encode_py(" the")


@pytest.mark.parametrize("policy", ["fixpoint", "priority"])
@pytest.mark.parametrize("pattern", ["whitespace", "words", "other"])
def test_presplit_matches_python_segments(native, policy, pattern):
    """The native ASCII segmenters (whitespace, words with space) and the
    boundaries handed over for any other pattern agree with the Python
    segments, in ``encode`` and ``encode_batch``, also on non-ASCII
    text."""
    pat = {"whitespace": TN.WHITESPACE, "words": TN.WORDS_WITH_SPACE,
           "other": r"\w+|\W+"}[pattern]
    rng = random.Random(17)
    alphabet = "abcDEF 019 ..,!?_-  \t"
    vocab, merges = build_random_tokenizer(rng, n_merges=40)
    t, j = pair(vocab, merges, policy, pattern=pat)
    assert bool(t._native_presplit) == (pattern != "other")
    texts = ["".join(rng.choice(alphabet)
                     for _ in range(rng.randint(0, 80))) for _ in range(120)]
    texts += ["", " ", "__", " _a", "a_ b", "  a", "1a,b2  _"]
    expect = [t.encode_py(x) for x in texts]
    assert t.encode_batch(texts) == expect
    assert j.encode_batch(texts) == expect
    for x in texts[:30]:
        assert t.encode(x) == t.encode_py(x), (policy, x)
    mixed = ["é ab cd", "ab  日本 c"]
    assert t.encode_batch(mixed) == [t.encode_py(x) for x in mixed] == \
        j.encode_batch(mixed)


def test_python_path_without_the_library():
    vocab, merges = build_random_tokenizer(random.Random(5))
    t = TE.Encoder(vocab, merges, use_native=False)
    assert not t.native_available
    assert t.encode("abc fed") == t.encode_py("abc fed")
    assert t.encode_batch(["ab", ""]) == [t.encode_py("ab"), []]


# ------------------------------------------- the committed 50k artifacts

def val_lines():
    with open(os.path.join(WORK, "val.txt"), encoding="utf-8") as f:
        return [ln.rstrip("\n") for ln in f]


def jax_encoder(path):
    """The JAX package's ``Encoder`` over the artifact's vocabulary, merge
    history, normalizer and policy (what its tokenizer's ``encode`` uses)."""
    from hyptokenizer_tpu.tokenizer.core import HyperbolicTokenizer

    vocab, _, merges, cfg = HyperbolicTokenizer._parse_artifacts(path)
    return JE.Encoder(vocab, merges, normalizer=JNC.from_json(
        cfg.get("normalizer")), merge_policy=cfg.get("merge_policy",
                                                     "fixpoint"))


@pytest.fixture(scope="module", params=["flagship50k_unsup",
                                        "flagship50k_sup"])
def artifact(request, native):
    path = os.path.join(WORK, request.param)
    if not os.path.isdir(path):
        pytest.skip(f"{path} is not in this checkout")
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    tok = EnhancedHyperbolicTokenizer.load(path, device="cpu")
    return path, tok, jax_encoder(path)


def test_artifact_loads_into_the_port(artifact):
    path, tok, jenc = artifact
    assert tok.vocab == jenc.vocab
    assert [tuple(m) for m in tok.merge_history] == jenc.merge_history
    assert tok.merge_policy == jenc.merge_policy == "priority"
    assert tok.normalizer.pre_split == jenc.normalizer.pre_split
    assert len(tok.vocab) > 40_000


def test_artifact_encodes_match_jax(artifact):
    """All of ``val.txt`` through the port's native path and the JAX
    package's native and Python paths, and through the port's Python path:
    identical ids."""
    _, tok, jenc = artifact
    lines = val_lines()
    enc = tok._get_encoder()
    assert enc.native_available
    ids = tok.encode_batch(lines)
    assert ids == jenc.encode_batch(lines)
    assert [enc.encode_py(x) for x in lines] == ids
    assert [jenc.encode_py(x) for x in lines] == ids
    assert [tok.encode(x) for x in lines[:100]] == ids[:100]
    assert all(tok.decode(s) == x for s, x in zip(ids, lines))
