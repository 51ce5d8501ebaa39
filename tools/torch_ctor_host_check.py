#!/usr/bin/env python3
"""The Quick start constructor's host work on the benchmark's whole
``quickstart.merge`` traffic: each array-form function against its loop
oracle, element for element, with the seconds of each.

    python3 tools/torch_ctor_host_check.py

Reads the traffic as ``portbench`` does (``portbench/traffic/merge.json``,
``portbench/configs/quickstart.json``), normalises and encodes the lines as
the constructor does, then times ``morphology.analyze_corpus`` against
``analyze_corpus_py`` and ``data.shard_align_corpus`` against
``shard_align_corpus_py`` (each after one untimed call, so that imports and
first-call costs stay out). Host code only: needs no card. Prints one JSON
object and exits nonzero on any difference.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hyptokenizer_tpu_torch.tokenizer import normalize as N  # noqa: E402
from hyptokenizer_tpu_torch.tokenizer import scoring  # noqa: E402
from hyptokenizer_tpu_torch.utils import data, morphology  # noqa: E402
from portbench.jobs import enhanced_training as E  # noqa: E402
from portbench.reference import corpus as C  # noqa: E402


def _timed(fn, *args, **kw):
    fn(*args, **kw)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _tables(m):
    return (m.token_frequencies, m.common_morphemes, m.common_words,
            m.morph_set, m.word_set)


def main() -> int:
    with open(os.path.join(ROOT, "portbench/traffic/merge.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(ROOT, "portbench/configs/quickstart.json")) as f:
        cfg = json.load(f)
    lines = C.traffic_lines(traffic)
    vocab = C.traffic_vocab(traffic, lines)
    texts = [ln.rstrip("\n") for ln in lines]
    norm = N.NormalizerConfig(pre_split=E.PRE_SPLIT[cfg["pre_split"]])
    ids = data.encode_corpus_chars(
        [N.normalize(t, norm) for t in texts], vocab,
        cfg["corpus_max_tokens"], sep_id=scoring.SEP_ID,
        pad_id=scoring.PAD_ID, pre_split=norm.pre_split)
    shards = cfg["corpus_shards"]

    got, morph_s = _timed(morphology.analyze_corpus, texts)
    want, morph_py_s = _timed(morphology.analyze_corpus_py, texts)
    morph_equal = (_tables(got) == _tables(want) and all(
        np.array_equal(x, y)
        for x, y in zip(got.hash_tables(), want.hash_tables())))
    packed, shard_s = _timed(data.shard_align_corpus, ids, shards,
                             scoring.PAD_ID, scoring.SEP_ID)
    packed_py, shard_py_s = _timed(data.shard_align_corpus_py, ids, shards,
                                   scoring.PAD_ID, scoring.SEP_ID)
    shard_equal = (packed.dtype == packed_py.dtype
                   and np.array_equal(packed, packed_py))
    print(json.dumps({
        "lines": len(texts), "chars": sum(map(len, texts)),
        "distinct_words": len(got.token_frequencies),
        "corpus_ids": int((ids != scoring.PAD_ID).sum()),
        "n_shards": shards,
        "analyze_corpus_s": round(morph_s, 4),
        "analyze_corpus_py_s": round(morph_py_s, 4),
        "morphology_equal": morph_equal,
        "shard_align_corpus_s": round(shard_s, 4),
        "shard_align_corpus_py_s": round(shard_py_s, 4),
        "shard_equal": shard_equal,
    }))
    return 0 if morph_equal and shard_equal else 1


if __name__ == "__main__":
    sys.exit(main())
