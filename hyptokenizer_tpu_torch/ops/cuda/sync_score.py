"""The corpus sync's candidate scoring on the card: every row of a fresh
pair table scored in one kernel launch (kernel S1).

Replaces no ``pl.pallas_call``: the JAX package scores the table with XLA
ops in ``_sync_finish`` (``hyptokenizer_tpu/tokenizer/enhanced_state.py``).
The kernel is ``csrc/sync_score.cu`` (see the note at its top for its
design and its bound); its plain version is
``tokenizer/enhanced_state.score_candidates_plain``.

:func:`score` launches the kernel for CUDA tensors, or raises; it never
falls back (``enhanced_state.score_candidates`` takes the plain version
for CPU tensors). ``launches`` counts kernel launches; while a profiler
records, each launch also counts ``sync.score_launches``
(``utils/metrics.py``).
"""

from __future__ import annotations

import ctypes

import torch

from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.utils import metrics

SOURCE = "sync_score"

launches = 0            # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _launcher():
    lib = _build.load(SOURCE)
    if lib.sync_score_launch.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sync_score_launch.argtypes = ([ptr] * 19 + [i] * 11 + [f] * 5
                                          + [ptr])
        lib.sync_score_launch.restype = ctypes.c_int
    return lib


def _launched(rc: int) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"sync_score kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    metrics.count("sync.score_launches")


def score(keys, counts, emb, lengths, token_hash, byte_lengths, has_vowel,
          hash_powers, morph_table, morph_size, word_table, word_size,
          samples, curvature, threshold, max_count, corpus_tokens, *,
          use_frequency: bool, use_compression: bool,
          use_hierarchical: bool, weights, min_pair_freq: int,
          max_token_len: int) -> tuple:
    """Scores ``(P, n)`` and distances ``(n,)`` of the ``n`` rows of the
    pair table ``keys`` (n, 2) / ``counts`` (n,), in one launch: P = 3 with
    the curriculum (``use_hierarchical``), else 1; a row that fails the
    candidate gate scores -inf in every phase, a sentinel row has distance
    inf. ``weights`` is ``EnhancedConfig.weights()``. The scalars
    (``curvature``, ``threshold``: float32; ``max_count``,
    ``corpus_tokens``, ``morph_size``, ``word_size``: int32) are
    one-element tensors on the card, read there."""
    _build.check("keys", keys, torch.int32, (None, 2))
    _build.check("emb", emb, torch.float32, (None, None))
    n = keys.shape[0]
    v, d1 = emb.shape
    tensors = (("keys", keys, None, None),
               ("counts", counts, torch.int32, (n,)),
               ("emb", emb, None, None),
               ("lengths", lengths, torch.int32, (v,)),
               ("token_hash", token_hash, torch.int32, (v, 2)),
               ("byte_lengths", byte_lengths, torch.int32, (v,)),
               ("has_vowel", has_vowel, torch.bool, (v,)),
               ("hash_powers", hash_powers, torch.int32, (2, None)),
               ("morph_table", morph_table, torch.int32, (None,)),
               ("word_table", word_table, torch.int32, (None,)),
               ("samples", samples, torch.int32, (None,)),
               ("curvature", curvature, torch.float32, None),
               ("threshold", threshold, torch.float32, None),
               ("max_count", max_count, torch.int32, None),
               ("corpus_tokens", corpus_tokens, torch.int32, None),
               ("morph_size", morph_size, torch.int32, None),
               ("word_size", word_size, torch.int32, None))
    for name, t, dtype, shape in tensors:
        if dtype is not None:
            _build.check(name, t, dtype, shape)
    dev = keys.device
    _build.check_devices([(name, t) for name, t, _, _ in tensors], dev)
    if d1 < 1 or hash_powers.shape[1] < 1 or morph_table.shape[0] < 1 or \
            word_table.shape[0] < 1:
        raise ValueError("sync_score: empty embedding rows, hash powers or "
                         "morphology tables")
    n_phases = 3 if use_hierarchical else 1
    dists = torch.empty((n,), dtype=torch.float32, device=dev)
    scores = torch.empty((n_phases, n), dtype=torch.float32, device=dev)
    if n == 0:
        return scores, dists
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _launcher().sync_score_launch(
            *(t.data_ptr() for t in (
                keys, counts, emb, lengths, token_hash, byte_lengths,
                has_vowel, hash_powers, morph_table, word_table, samples,
                curvature, threshold, max_count, corpus_tokens, morph_size,
                word_size, dists, scores)),
            n, d1, hash_powers.shape[1], morph_table.shape[0],
            word_table.shape[0], samples.shape[0], int(use_frequency),
            int(use_compression), int(use_hierarchical), int(min_pair_freq),
            int(max_token_len), *(float(w) for w in weights), stream)
    _launched(rc)
    return scores, dists
