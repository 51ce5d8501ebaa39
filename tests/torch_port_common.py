"""Shared inputs for the tests that hold the PyTorch port to the JAX package.

Both packages get the same inputs: the small corpus and sizes of
``tests/test_enhanced_loop_kernel.py``, embeddings made once with the JAX
package's ``random_points`` and handed to both as numpy, and the same
random draws (:class:`ReplaySampler` follows the JAX state's key chain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.ops import lorentz as JL
from hyptokenizer_tpu.tokenizer import EnhancedHyperbolicTokenizer as JaxTok
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer as TorchTok

CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "a cat and a dog and a rat",
    "the rat sat and the cat sat",
    "dogs and cats and rats ran fast",
] * 6

# The flagship's corpus-only recipe (bench.py bench_enhanced) at the small
# sizes of test_enhanced_loop_kernel.py, with events that a short run
# crosses: a curvature update every 7 merges and a queue (K=128) that
# truncates and drains mid-chunk.
SMALL = dict(
    corpus_sample=CORPUS, max_vocab_size=256, merge_threshold=5.0,
    search_block=64, corpus_max_tokens=1024, freq_table_size=1024,
    queue_size=128, seed=0, use_dense_channel=False,
    use_hierarchical=False, use_compression_aware=False,
    use_adaptive_curvature=True, optimize_curvature_freq=7,
    alpha=0.05, beta=0.9, gamma=0.05, merge_batch=4,
    merge_policy="priority")


def small_vocab_and_emb(d: int = 8, sigma: float = 0.6):
    chars = sorted({ch for line in CORPUS for ch in line})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    emb = np.asarray(JL.random_points(jax.random.PRNGKey(0), len(vocab), d,
                                      sigma=sigma))
    return vocab, emb


def make_pair(**overrides):
    """The same tokenizer built by both packages (the port on the CPU)."""
    kw = dict(SMALL)
    kw.update(overrides)
    vocab, emb = small_vocab_and_emb()
    return JaxTok(vocab, emb, **kw), TorchTok(vocab, emb, device="cpu", **kw)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op threads for a module's tests: one. Their tensors are
    tiny, and under the test workers' parallel run a pool per worker spends
    its time spinning against the other workers' (a 0.3 s test took 27 s).
    Imported by name into a test module, it applies to that module only."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class ReplaySampler:
    """Hands the port the draws the JAX package makes from ``key``: the
    same splits, in the same order (enhanced_state.py:442, :386-415 and
    :718-720). The distance statistics' draws (:meth:`stats`) follow the
    tokenizer's own chain instead: ``PRNGKey(k)`` for its k-th call, split
    in two, one ``randint`` each (core.py:149-158, state.py:196-214)."""

    def __init__(self, key=None):
        # A copy: the JAX loop donates its state, key included.
        self.key = None if key is None else jnp.array(np.asarray(key))
        self.stats_key = 0

    def stats(self, sample_size, n):
        self.stats_key += 1
        k1, k2 = jax.random.split(jax.random.PRNGKey(self.stats_key))
        return tuple(torch.from_numpy(np.array(x)) for x in (
            jax.random.randint(k1, (sample_size,), 0, jnp.int32(n)),
            jax.random.randint(k2, (sample_size,), 0, jnp.int32(n - 1))))

    def coherence(self, n, high):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(
            jax.random.randint(sub, (n,), 0, jnp.int32(high))))

    def curvature(self, hp, hn, ds, high):
        self.key, sub = jax.random.split(self.key)
        k1, k2, k3 = jax.random.split(sub, 3)
        h = jnp.int32(high)
        return tuple(torch.from_numpy(np.array(x)) for x in (
            jax.random.randint(k1, (hp, hn), 0, h),
            jax.random.randint(k2, (ds,), 0, h),
            jax.random.randint(k3, (ds,), 0, h)))

    def get_state(self):
        """Key words and stats counter, as a checkpoint keeps a sampler's
        state (utils/checkpoint.py)."""
        key = [0, 0] if self.key is None else np.asarray(self.key).tolist()
        return torch.tensor(key + [self.stats_key], dtype=torch.int64)

    def set_state(self, state):
        vals = state.tolist()
        self.key = jnp.asarray(np.asarray(vals[:2], np.uint32))
        self.stats_key = int(vals[2])


class ReplayDraws:
    """The embedding trainers' draws as the JAX trainers make them: each
    step splits ``key`` in ``n_split`` (tokenizer/embed_train.py: 3 for
    the ranking and ordinal trainers, 2 for stress) and draws once from
    each subkey after the first, in order."""

    def __init__(self, key, n_split=3):
        self.key = key
        self.n_split = n_split
        self.pending = []

    def _sub(self):
        if not self.pending:
            parts = jax.random.split(self.key, self.n_split)
            self.key = parts[0]
            self.pending = list(parts[1:])
        return self.pending.pop(0)

    def randint(self, shape, high):
        return torch.from_numpy(np.array(jax.random.randint(
            self._sub(), tuple(shape), 0, jnp.int32(high))))

    def uniform(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self._sub(), tuple(shape))))


def history(st):
    """Merge history (n, 2) of a JAX or a port state, as numpy."""
    n = int(st.base.num_merges)
    m = st.base.merges[:n]
    return m.numpy() if torch.is_tensor(m) else np.asarray(m)
