"""The port's data helpers, TrainConfig and metrics (hyptokenizer_tpu_torch/
utils/) against the JAX package's, on the CPU.

Every comparison here is exact: the helpers are host code (strings, numpy)
copied from the JAX package, and ``initialize_embeddings`` is held to its
distribution (on the sheet; tangent spread sigma), since its numbers come
from a ``torch.Generator`` and not from ``jax.random``.
"""

import bz2
import json

import numpy as np
import pytest
import torch

from hyptokenizer_tpu.utils import config as JC
from hyptokenizer_tpu.utils import data as JD
from hyptokenizer_tpu.utils import metrics as JM
from hyptokenizer_tpu_torch.ops import lorentz as TL
from hyptokenizer_tpu_torch.utils import config as TC
from hyptokenizer_tpu_torch.utils import data as TD
from hyptokenizer_tpu_torch.utils import metrics as TM
from tests.torch_port_common import one_torch_thread  # noqa: F401

LINES = ["The Cat sat on the mat!!  ", "", "a dog, a rat. 42 rats",
         "Café déjà vu — naïve", "x", "the   end\tof it"] * 3


def test_preprocess_lines_matches_jax():
    for min_length in (0, 5):
        assert list(TD.preprocess_lines(LINES, min_length)) == \
            list(JD.preprocess_lines(LINES, min_length))


@pytest.mark.parametrize("min_count", [1, 3, 5])
def test_build_initial_vocab_matches_jax(min_count):
    got = TD.build_initial_vocab(LINES, min_count=min_count)
    assert got == JD.build_initial_vocab(LINES, min_count=min_count)
    assert got[:4] == ["<pad>", "<bos>", "<eos>", "<unk>"]


def test_open_text_bz2_and_vocab_files_match_jax(tmp_path):
    text = "\n".join(LINES) + "\n"
    path = str(tmp_path / "c.txt.bz2")
    with bz2.open(path, "wt", encoding="utf-8") as f:
        f.write(text)
    with TD.open_text(path) as f:
        got = f.read()
    with JD.open_text(path) as f:
        assert got == f.read() == text
    with TD.open_text(path) as f:
        vocab = TD.build_initial_vocab(TD.preprocess_lines(f), min_count=2)
    TD.save_vocab(vocab, str(tmp_path / "v.txt"))
    assert TD.load_vocab(str(tmp_path / "v.txt")) == \
        JD.load_vocab(str(tmp_path / "v.txt")) == vocab
    plain = str(tmp_path / "c.txt")
    with TD.open_text(plain, "w") as f:
        f.write(text)
    with TD.open_text(plain) as f:
        assert f.read() == text


def test_initialize_embeddings_distribution():
    a = TD.initialize_embeddings(512, 16, curvature=1.0, sigma=0.01, seed=3,
                                 device="cpu")
    b = TD.initialize_embeddings(512, 16, curvature=1.0, sigma=0.01, seed=3,
                                 device="cpu")
    gen = torch.Generator().manual_seed(3)
    c = TD.initialize_embeddings(512, 16, sigma=0.01, seed=gen, device="cpu")
    assert a.shape == (512, 17) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    np.testing.assert_allclose(TL.minkowski_dot(a, a).numpy(), 1.0,
                               atol=1e-5)
    ja = JD.initialize_embeddings(512, 16, sigma=0.01, seed=3)
    for x in (a.numpy(), ja):
        assert abs(float(np.std(x[:, 1:])) - 0.01) < 1e-3
        assert abs(float(np.mean(x[:, 1:]))) < 1e-3


def test_initialize_embeddings_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.initialize_embeddings(4, 2)


def test_train_config_json_round_trip_matches_jax(tmp_path):
    cfg = TC.TrainConfig(embedding_dim=8, steps=20, use_hierarchical=False,
                         phase_transition_steps={2: 10, 3: 30},
                         target_vocab_size=77)
    jcfg = JC.TrainConfig(embedding_dim=8, steps=20, use_hierarchical=False,
                          phase_transition_steps={2: 10, 3: 30},
                          target_vocab_size=77)
    assert cfg.to_json() == jcfg.to_json()
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    back = TC.TrainConfig.from_json(path)
    assert back == cfg
    assert TC.TrainConfig.from_json(cfg.to_json()) == cfg
    assert JC.TrainConfig.from_json(path) == jcfg
    assert back.tokenizer_kwargs() == jcfg.tokenizer_kwargs()
    # Unknown keys are dropped, as in the JAX package.
    extra = json.dumps({"steps": 5, "not_a_field": 1})
    assert TC.TrainConfig.from_json(extra).steps == 5


def test_metrics_writer_and_span_match_jax(tmp_path):
    tw = TM.MetricsWriter(str(tmp_path / "a" / "t.jsonl"))
    jw = JM.MetricsWriter(str(tmp_path / "b" / "j.jsonl"))
    for w, mod in ((tw, TM), (jw, JM)):
        w.log({"step": 1, "x": 2.5})
        with mod.span("phase", w):
            pass
    with open(tmp_path / "a" / "t.jsonl") as f:
        trec = [json.loads(ln) for ln in f]
    with open(tmp_path / "b" / "j.jsonl") as f:
        jrec = [json.loads(ln) for ln in f]
    assert [sorted(r) for r in trec] == [sorted(r) for r in jrec]
    assert tw.summary().keys() == jw.summary().keys()
    assert TM.MetricsWriter().summary() == {}


def test_nan_checks_and_build_counters():
    from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer
    gen = torch.Generator().manual_seed(0)
    emb = TL.random_points(gen, 8, 4, sigma=0.5, device="cpu")
    tok = HyperbolicTokenizer([chr(97 + i) for i in range(8)], emb,
                              max_vocab_size=16, device="cpu")
    TM.check_finite(tok.state, "construction")
    tok.state.emb[2, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="emb"):
        TM.check_finite(tok.state, "a chunk")
    try:
        TM.enable_nan_checks(True)
        assert TM.nan_checks_enabled() and torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError):
            tok.optimize_merges(steps=2, log_every=2)
    finally:
        TM.enable_nan_checks(False)
    assert not TM.nan_checks_enabled() and not torch.is_anomaly_enabled()
    assert TM.compile_seconds() >= 0.0
    counts = TM.cache_hit_counts()
    assert set(counts) == {"hits", "requests"}
    assert 0 <= counts["hits"] <= counts["requests"]


def test_profile_trace_writes_a_trace(tmp_path):
    with TM.profile_trace(str(tmp_path / "trace")):
        torch.ones(4) @ torch.ones(4)
    assert (tmp_path / "trace" / "trace.json").exists()
