"""The rest of the port's ``tokenizer/enhanced.py`` against the JAX
package's: the four configurations of the enhanced engine
(``FrequencyAwareHyperbolicTokenizer``, ``HierarchicalHyperbolicTokenizer``,
``AdaptiveCurvatureTokenizer``, ``CompressionAwareTokenizer``), the
``EnhancedFastHyperbolicTokenizer`` alias and ``corpus_shrink``.

Both packages build the same class from the same inputs (the small corpus
and embeddings of ``tests/torch_port_common.py``), the port on the CPU
with the JAX package's own draws replayed (``ReplaySampler``). The merge
history must be exactly equal, as in ``tests/test_torch_slice.py``; for
``HierarchicalHyperbolicTokenizer`` alone, whose morphology-only scores
let the dense channel chain a token with its own copies down to the acosh
clamp floor, equal while the merge distances stay above that floor, where
ties are exact and either pick is right (the rule of
``tests/test_torch_merge_loop.py``).
"""

import numpy as np
import pytest

import hyptokenizer_tpu.tokenizer as J
import hyptokenizer_tpu_torch.tokenizer as T
from hyptokenizer_tpu_torch.tokenizer import enhanced as TE
from tests.torch_port_common import CORPUS, ReplaySampler, small_vocab_and_emb

NOISE = 1e-3   # above the acosh clamp floor (~5e-4)

# The sizes of torch_port_common.SMALL, without its feature flags, so that
# each class's own defaults decide them.
SIZES = dict(corpus_sample=CORPUS, max_vocab_size=256, merge_threshold=5.0,
             search_block=64, corpus_max_tokens=1024, freq_table_size=1024,
             queue_size=128, seed=0, merge_batch=4)

FLAGS = ("use_frequency", "use_hierarchical", "use_adaptive_curvature",
         "use_compression", "use_dense_channel", "alpha", "beta", "gamma",
         "compression_weight", "curvature_freq", "curvature_lr",
         "hierarchy_weight", "distortion_weight", "needs_corpus")

VARIANTS = {
    "frequency": ("FrequencyAwareHyperbolicTokenizer",
                  dict(alpha=0.3, beta=0.5, gamma=0.2)),
    "hierarchical": ("HierarchicalHyperbolicTokenizer", {}),
    "adaptive": ("AdaptiveCurvatureTokenizer",
                 dict(optimize_curvature_freq=7, curvature_lr=0.05)),
    "compression": ("CompressionAwareTokenizer",
                    dict(compression_weight=0.6)),
    "alias": ("EnhancedFastHyperbolicTokenizer",
              dict(use_dense_channel=False, use_hierarchical=False,
                   use_compression_aware=False, optimize_curvature_freq=7,
                   alpha=0.05, beta=0.9, gamma=0.05,
                   merge_policy="priority")),
}


def build(name, **extra):
    cls_name, kw = VARIANTS[name]
    kw = dict(SIZES, **kw, **extra)
    vocab, emb = small_vocab_and_emb()
    jt = getattr(J, cls_name)(vocab, emb, **kw)
    tt = getattr(T, cls_name)(vocab, emb, device="cpu", **kw)
    return jt, tt


def test_exports_match_jax():
    names = ("EnhancedHyperbolicTokenizer", "EnhancedFastHyperbolicTokenizer",
             "FrequencyAwareHyperbolicTokenizer",
             "HierarchicalHyperbolicTokenizer", "AdaptiveCurvatureTokenizer",
             "CompressionAwareTokenizer")
    for n in names:
        assert hasattr(J, n) and hasattr(T, n), n
    assert T.EnhancedFastHyperbolicTokenizer is T.EnhancedHyperbolicTokenizer
    for n in names[2:]:
        assert issubclass(getattr(T, n), T.EnhancedHyperbolicTokenizer)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_jax(name):
    """Same configuration flags, same merge history and vocabulary, same
    phase and curvature (float32 rounding, 1e-5 relative) after training
    through ``optimize_merges`` across chunks, the curriculum's phase
    switches and curvature events."""
    jt, tt = build(name)
    for f in FLAGS:
        assert getattr(tt.enh_config, f) == getattr(jt.enh_config, f), f
    tt.sampler = ReplaySampler(jt.enh_state.key)
    train = dict(steps=24, log_every=8)
    if tt.enh_config.use_hierarchical:
        train["phase_transition_steps"] = {2: 6, 3: 14}
    jt.optimize_merges(**train)
    tt.optimize_merges(**train)
    assert len(tt.merge_history) >= 16
    assert tt.current_phase == jt.current_phase
    if name == "hierarchical":
        n = min(len(tt.merge_history), len(jt.merge_history))
        dj = np.asarray(jt.state.merge_dists[:n])
        comparable = next((k for k in range(n) if dj[k] <= NOISE), n)
        assert comparable >= 8          # the comparison has teeth
        assert tt.merge_history[:comparable] == jt.merge_history[:comparable]
        return
    assert tt.merge_history == jt.merge_history
    assert tt.vocab == jt.vocab
    np.testing.assert_allclose(tt.curvature, jt.curvature, rtol=1e-5)
    if tt.enh_config.use_hierarchical:
        assert tt.current_phase == 3
    if tt.enh_config.use_adaptive_curvature:
        assert int(tt.enh_state.curv_t) > 0


def test_hierarchical_morphology_predicates_match_jax():
    jt, tt = build("hierarchical")
    tokens = sorted({w for ln in CORPUS for w in ln.split()}) + [
        "s", "ed", "ing", "the", "xq", "and", "at", " ", "ca"]
    for tok in tokens:
        assert tt._is_potential_morpheme(tok) == \
            jt._is_potential_morpheme(tok), tok
        assert tt._is_valid_word(tok) == jt._is_valid_word(tok), tok


def test_live_count_matches_jax():
    from hyptokenizer_tpu.tokenizer import enhanced as JEnh
    import torch
    rng = np.random.default_rng(0)
    corpus = rng.integers(-2, 40, 300).astype(np.int32)
    corpus[200:] = -1
    assert int(TE._live_count(torch.from_numpy(corpus))) == \
        int(JEnh._live_count(corpus))


def shrink_pair(shrink, min_buf):
    """The JAX package's ``test_corpus_shrinking_is_semantically_inert``
    configuration, in both packages, with ``MIN_CORPUS_BUFFER`` set."""
    import jax
    from hyptokenizer_tpu.ops import lorentz as JL

    corpus = ["aa bb cc dd ee", "bb cc dd aa ff", "cc dd aa bb gg"] * 6
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + sorted(
        {c for ln in corpus for c in ln})
    emb = np.asarray(JL.random_points(jax.random.PRNGKey(1), len(vocab), 8,
                                      sigma=0.5))
    kw = dict(merge_threshold=50.0, max_vocab_size=128, search_block=32,
              corpus_sample=corpus, corpus_max_tokens=512,
              use_hierarchical=False, use_adaptive_curvature=False,
              use_compression_aware=False, use_dense_channel=False,
              min_pair_freq=1, merge_batch=4, seed=1, corpus_shrink=shrink)
    jt = J.EnhancedHyperbolicTokenizer(vocab, emb, **kw)
    tt = T.EnhancedHyperbolicTokenizer(vocab, emb, device="cpu", **kw)
    jt.MIN_CORPUS_BUFFER = tt.MIN_CORPUS_BUFFER = min_buf
    tt.sampler = ReplaySampler(jt.enh_state.key)
    return jt, tt


def test_corpus_shrink_is_inert_and_halves_the_buffer():
    """With ``corpus_shrink`` the buffer shrinks by powers of two while the
    live prefix fits, to the buffer the JAX package shrinks to, and the
    merges are those of the same run without it (the JAX package's own
    test). The two packages' histories are not compared here: this corpus's
    doubled letters make self-pairs, whose grams are 1 up to rounding, so
    their order sits below the acosh clamp floor."""
    jt, tt = shrink_pair(True, 16)
    sizes = []
    tt.register_callback(
        lambda _: sizes.append(int(tt.enh_state.corpus.shape[0])))
    jt.optimize_merges(steps=40, log_every=8)
    tt.optimize_merges(steps=40, log_every=8)
    assert sizes[-1] < 512
    assert sizes == sorted(sizes, reverse=True)
    assert all(s & (s - 1) == 0 for s in sizes)       # powers of two
    assert tt.enh_state.corpus.shape == jt.enh_state.corpus.shape

    _, plain = shrink_pair(False, 16)
    plain.optimize_merges(steps=40, log_every=8)
    assert plain.enh_state.corpus.shape[0] == 512
    assert plain.merge_history == tt.merge_history
    assert tt.merge_history


def test_corpus_shrink_default_off_and_sharded_corpus_kept():
    _, tt = shrink_pair(False, 16)
    assert tt.corpus_shrink is False
    _, ts = shrink_pair(True, 16)
    ts.corpus_shards = 2
    before = ts.enh_state.corpus.shape[0]
    ts._maybe_shrink_corpus()
    assert ts.enh_state.corpus.shape[0] == before
