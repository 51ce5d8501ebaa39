"""Port host layer == the JAX package's: artifacts in both directions,
encode streams, the copied host modules, and the port's isolation rules
(no JAX import, no silent CPU fallback)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hyptokenizer_tpu.tokenizer import EnhancedHyperbolicTokenizer as JaxTok
from hyptokenizer_tpu.tokenizer import encode as JEnc
from hyptokenizer_tpu.tokenizer import normalize as JN
from hyptokenizer_tpu.utils import data as JD
from hyptokenizer_tpu.utils import morphology as JM
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer as TorchTok
from hyptokenizer_tpu_torch.tokenizer import encode as TEnc
from hyptokenizer_tpu_torch.tokenizer import normalize as TN
from hyptokenizer_tpu_torch.utils import data as TD
from hyptokenizer_tpu_torch.utils import morphology as TM
from tests.torch_port_common import (
    CORPUS, SMALL, ReplaySampler, make_pair, small_vocab_and_emb)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIKI = os.path.join(REPO, "data", "wiki_corpus.txt.bz2")

# tests/test_conformance.py's TEXTS (that module needs the reference
# implementation checked out, so it is not imported here).
TEXTS = [
    "",
    "a",
    "abcde",
    "aaabbbccc",
    "the quick brown fox jumps over the lazy dog",
    "abababab",
    "aabbaabb",
    "mississippi",
    "banana bandana",
    "xyz unknown chars",
    "a b a b",
]


def trained(pre_split=True):
    """Both packages trained alike (same draws) for three chunks."""
    kw = dict(SMALL)
    vocab, emb = small_vocab_and_emb()
    jt = JaxTok(vocab, emb, normalizer=JN.NormalizerConfig(
        pre_split=JN.WORDS_WITH_SPACE) if pre_split else None, **kw)
    tt = TorchTok(vocab, emb, device="cpu", normalizer=TN.NormalizerConfig(
        pre_split=TN.WORDS_WITH_SPACE) if pre_split else None, **kw)
    tt.sampler = ReplaySampler(jt.enh_state.key)
    jt.optimize_merges(steps=60, log_every=20)
    tt.optimize_merges(steps=60, log_every=20)
    assert tt.merge_history == jt.merge_history
    return jt, tt


@pytest.fixture(scope="module", params=[True, False],
                ids=["pre-split", "raw"])
def pair(request):
    """(JAX, port) tokenizers trained alike; tests only read and save them."""
    return trained(request.param)


def test_port_save_loads_in_jax(tmp_path, pair):
    jt, tt = pair
    tt.save(str(tmp_path))
    back = JaxTok.load(str(tmp_path))
    assert back.vocab == tt.vocab
    assert back.merge_history == tt.merge_history
    for text in TEXTS + CORPUS[:5]:
        assert back.encode(text) == tt.encode(text) == jt.encode(text)
    np.testing.assert_allclose(back.embeddings, tt.embeddings, atol=0)


def test_jax_save_loads_in_port(tmp_path, pair):
    jt, tt = pair
    jt.save(str(tmp_path))
    back = TorchTok.load(str(tmp_path), device="cpu")
    assert back.vocab == jt.vocab
    assert back.merge_history == jt.merge_history
    assert back.enh_config.frozen_freqs
    for text in TEXTS + CORPUS[:5]:
        assert back.encode(text) == jt.encode(text)
    np.testing.assert_allclose(back.embeddings, jt.embeddings, atol=0)
    assert float(back.state.curvature) == float(jt.state.curvature)


def test_artifact_bytes_match(tmp_path, pair):
    """The same trained tokenizer writes the same JSON artifacts."""
    jt, tt = pair
    jt.save(str(tmp_path / "jax"))
    tt.save(str(tmp_path / "port"))
    for name in ("vocab.json", "merges.json", "enhanced_config.json",
                 "frequencies.json", "freq_hyperparams.json"):
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b, name
    ja = json.loads((tmp_path / "jax" / "config.json").read_text())
    pa = json.loads((tmp_path / "port" / "config.json").read_text())
    assert ja.keys() == pa.keys()
    assert ja.get("normalizer") == pa.get("normalizer")
    assert ja["curvature"] == pytest.approx(pa["curvature"], rel=1e-5)
    assert (tmp_path / "port" / "embeddings.pt").exists()


def test_loaded_tokenizers_continue_alike(tmp_path, pair):
    """Both packages load the same artifact and continue training alike:
    on the frozen restored frequencies, then re-grounded on a live
    corpus."""
    jt, _ = pair
    jt.save(str(tmp_path))
    jb = JaxTok.load(str(tmp_path))
    tb = TorchTok.load(str(tmp_path), device="cpu")
    tb.sampler = ReplaySampler(jb.enh_state.key)
    n = len(jb.merge_history)
    for kw in (dict(), dict(corpus_sample=CORPUS)):
        jb.optimize_merges(steps=16, log_every=8, **kw)
        tb.optimize_merges(steps=16, log_every=8, **kw)
        assert tb.merge_history == jb.merge_history
        assert tb.training_stats[-1]["step"] == jb.training_stats[-1]["step"]
    assert len(tb.merge_history) > n


@pytest.mark.parametrize("policy", ["fixpoint", "priority"])
@pytest.mark.parametrize("merges", [
    [],
    [("a", "b", "ab"), ("ab", "a", "aba"), ("b", "a", "ba")],
    [("t", "h", "th"), ("th", "e", "the"), ("a", "n", "an"),
     ("an", "a", "ana")],
    [("s", "s", "ss"), ("i", "ss", "iss"), ("iss", "iss", "ississ")],
])
def test_encoder_matches(policy, merges):
    base = ["<pad>", "<bos>", "<eos>", "<unk>"] + list(
        "abcdefghijklmnopqrstuvwxyz ")
    vocab = base + [m[2] for m in merges]
    for norm in (None, "words"):
        tn = jn = None
        if norm:
            tn = TN.NormalizerConfig(pre_split=TN.WORDS_WITH_SPACE)
            jn = JN.NormalizerConfig(pre_split=JN.WORDS_WITH_SPACE)
        mine = TEnc.Encoder(vocab, merges, normalizer=tn, merge_policy=policy)
        ref = JEnc.Encoder(vocab, merges, normalizer=jn, merge_policy=policy,
                           use_native=False)
        for text in TEXTS:
            assert mine.tokenize(text) == ref.tokenize(text)
            assert mine.encode(text) == ref.encode_py(text)
            assert mine.decode(mine.encode(text)) == ref.decode(
                ref.encode_py(text))


def test_copied_host_modules_match():
    lines = TD.read_corpus_lines(WIKI)[:400]
    assert len(lines) == 400
    texts = lines + ["Ünïcödé  tabs\tand_underscores 42x", ""]
    for pat in (None, TN.WHITESPACE, TN.WORDS_WITH_SPACE, r"\w+"):
        vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + sorted(
            {c for t in texts for c in t})[:50]
        a = TD.encode_corpus_chars(texts, vocab, 30_000, pre_split=pat)
        b = JD.encode_corpus_chars(texts, vocab, 30_000, pre_split=pat)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(TD.shard_align_corpus(a, 4),
                                      JD.shard_align_corpus(b, 4))
        if pat:
            for t in texts[:50]:
                assert list(TN.segments(t, pat)) == list(JN.segments(t, pat))
    for t in texts[:50]:
        assert TD.clean_text(t) == JD.clean_text(t)
    tm = TM.analyze_corpus(lines[:200], use_wordnet=False)
    jm = JM.analyze_corpus(lines[:200], use_wordnet=False)
    for x, y in zip(tm.hash_tables(), jm.hash_tables()):
        np.testing.assert_array_equal(x, y)
    assert [TM.has_vowel(t) for t in texts] == [JM.has_vowel(t)
                                                for t in texts]


def test_import_leaves_jax_out():
    """Importing the port (all its modules) loads neither jax nor the JAX
    package."""
    code = (
        "import sys\n"
        "import hyptokenizer_tpu_torch\n"
        "import hyptokenizer_tpu_torch.convert\n"
        "import hyptokenizer_tpu_torch.tokenizer\n"
        "import hyptokenizer_tpu_torch.ops.cuda.enhanced_loop\n"
        "import hyptokenizer_tpu_torch.ops.cuda.pairwise\n"
        "import hyptokenizer_tpu_torch.ops.cuda.merge_loop\n"
        "import hyptokenizer_tpu_torch.ops.cuda._build\n"
        "import hyptokenizer_tpu_torch.tokenizer.search\n"
        "import hyptokenizer_tpu_torch.tokenizer.state\n"
        "import hyptokenizer_tpu_torch.tokenizer.core\n"
        "import hyptokenizer_tpu_torch.evals.selfcheck\n"
        "import hyptokenizer_tpu_torch.bench\n"
        "import hyptokenizer_tpu_torch.cli.test_torch\n"
        "import hyptokenizer_tpu_torch.ops.poincare\n"
        "import hyptokenizer_tpu_torch.tokenizer.encode\n"
        "import hyptokenizer_tpu_torch.tokenizer.enhanced\n"
        "import hyptokenizer_tpu_torch.tokenizer.embed_train\n"
        "import hyptokenizer_tpu_torch.utils.data\n"
        "import hyptokenizer_tpu_torch.utils.config\n"
        "import hyptokenizer_tpu_torch.utils.metrics\n"
        "import hyptokenizer_tpu_torch.utils.checkpoint\n"
        "import hyptokenizer_tpu_torch.evals\n"
        "import hyptokenizer_tpu_torch.evals.hierarchy\n"
        "import hyptokenizer_tpu_torch.cli._common\n"
        "import hyptokenizer_tpu_torch.cli.preprocess_wiki\n"
        "import hyptokenizer_tpu_torch.cli.train_tokenizer\n"
        "import hyptokenizer_tpu_torch.cli.train_enhanced_tokenizer\n"
        "import hyptokenizer_tpu_torch.cli.train_graph_embeddings\n"
        "import hyptokenizer_tpu_torch.cli.eval_hierarchy\n"
        "import hyptokenizer_tpu_torch.cli.bench_scaling\n"
        "import hyptokenizer_tpu_torch.parallel\n"
        "import hyptokenizer_tpu_torch.parallel.mesh\n"
        "import hyptokenizer_tpu_torch.parallel.multihost\n"
        "import hyptokenizer_tpu_torch.parallel.sharded\n"
        "import hyptokenizer_tpu_torch.models\n"
        "import hyptokenizer_tpu_torch.models.nlp\n"
        "import hyptokenizer_tpu_torch.models.retrieval\n"
        "import hyptokenizer_tpu_torch.evals.baselines\n"
        "import hyptokenizer_tpu_torch.cli.train_nlp_tasks\n"
        "import hyptokenizer_tpu_torch.cli.train_retrieval\n"
        "import hyptokenizer_tpu_torch.cli.analysis\n"
        "import hyptokenizer_tpu_torch.cli.benchmark_efficiency\n"
        "import hyptokenizer_tpu_torch.cli.compare_tokenizers\n"
        "import hyptokenizer_tpu_torch.cli.train_baseline_tokenizers\n"
        "import hyptokenizer_tpu_torch.cli.build_wordnet_graph\n"
        "import hyptokenizer_tpu_torch.cli.download_data\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'hyptokenizer_tpu.')) or m == 'hyptokenizer_tpu'"
        " or m.split('.')[0] in ('flax', 'orbax', 'networkx', 'nltk',"
        " 'optax', 'transformers', 'tokenizers', 'sentencepiece',"
        " 'matplotlib')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_a_card():
    """The default device is the card: without one the constructor raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    jt, _ = make_pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchTok(jt.vocab[:jt.enh_config.n_init], np.asarray(jt.embeddings),
                 corpus_sample=CORPUS, use_dense_channel=False)


def test_cuda_wrapper_refuses_cpu_state():
    """The kernel wrapper launches on CUDA tensors only; it does not take a
    CPU state (the CPU path is run_segment's plain version)."""
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as TK
    _, tt = make_pair()
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.run_segment_cuda(tt.enh_state, tt.enh_config, 10, 10, 10)
