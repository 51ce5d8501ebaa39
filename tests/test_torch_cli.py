"""The port's training CLIs (hyptokenizer_tpu_torch/cli/) against the JAX
package's, with ``--device cpu``, on ``tests/test_cli.py``'s tiny corpus.

For the comparison only, this file makes the port's initial embeddings and
draws the JAX package's, by monkeypatching (nothing in either package
changes for it): ``utils.data.initialize_embeddings`` returns the JAX
package's points, the enhanced loop's sampler replays the JAX state's key
chain (``PRNGKey(seed)``), the statistics sampler replays the JAX
tokenizer's, and the embedding pretraining replays ``PRNGKey(seed)``'s
splits. The merges then equal the JAX CLIs' exactly: the whole history of
the corpus-only recipe, and a geometric channel's history up to the acosh
clamp floor (``comparable_merges``). The embeddings agree within
``rtol=1e-4, atol=1e-5``, or ``atol=1e-4`` after the pretraining
(``PRETRAINED_ATOL``), and the port's artifacts load in the JAX package and
encode to the same ids.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from hyptokenizer_tpu.cli import train_enhanced_tokenizer as JE
from hyptokenizer_tpu.cli import train_tokenizer as JB
from hyptokenizer_tpu.tokenizer import EnhancedHyperbolicTokenizer as JaxEnh
from hyptokenizer_tpu.tokenizer import HyperbolicTokenizer as JaxTok
from hyptokenizer_tpu.utils import data as JD
from hyptokenizer_tpu_torch.cli import train_enhanced_tokenizer as TE
from hyptokenizer_tpu_torch.cli import train_tokenizer as TB
from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer
from hyptokenizer_tpu_torch.tokenizer import embed_train as TET
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as TES
from hyptokenizer_tpu_torch.tokenizer import state as TS
from hyptokenizer_tpu_torch.utils import data as TD
from tests.torch_port_common import (
    one_torch_thread, ReplayDraws, ReplaySampler)  # noqa: F401

LINES = ["the cat sat on the mat and the dog sat on the log",
         "a cat and a dog and a rat sat together",
         "the rat ran to the mat and the cat ran after it"] * 5
# The Quick start's flags at the tiny size: the dense channel (all
# features), and the corpus-only flagship recipe after RSGD pretraining.
ENH_ARGS = ["--embedding-dim", "8", "--steps", "30", "--log-every", "15",
            "--init-sigma", "0.6",
            "--merge-threshold", "2.0", "--max-vocab-size", "128",
            "--corpus-max-tokens", "2048",
            "--pre-split", "words", "--merge-policy", "priority"]
CORPUS_ARGS = ENH_ARGS[:4] + [
    "--merge-threshold", "2.0", "--max-vocab-size", "128",
    "--corpus-max-tokens", "2048", "--pre-split", "words",
    "--merge-policy", "priority", "--no-use-dense-channel",
    "--embed-steps", "50"]
BASE_ARGS = ["--embedding-dim", "8", "--steps", "40", "--log-every", "20",
             "--init-sigma", "0.3",
             "--merge-threshold", "2.0", "--max-vocab-size", "128"]
CLAMP_FLOOR = 1e-3   # tests/test_torch_dense.py's rule for exact ties
# How many merges of each recipe lie above the clamp floor, and so are held
# to the JAX CLI's (measured on the JAX CLI's artifacts): the corpus-only
# history whole; the geometric channels start chaining a token with its own
# midpoints at once, so their distances halve to the floor in a few merges.
ABOVE_FLOOR = {"enhanced": 9, "corpus_only": 31, "base": 7}
# Rows after 50 pretraining steps at batch 1024: each step's gradient sums
# ~1000 pair terms per row in another order than XLA's, compounded by the
# RSGD retraction (tests/test_torch_embed_train.py holds the trainer itself
# to 1e-5 at batch 64).
PRETRAINED_ATOL = 1e-4


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "corpus.txt"
    p.write_text("\n".join(LINES))
    return str(p)


def jax_draws(mp):
    """The port's initial points and draws made the JAX package's."""
    mp.setattr(TD, "initialize_embeddings",
               lambda n, dim, curvature=1.0, sigma=0.01, seed=42, device=None:
               torch.from_numpy(np.array(JD.initialize_embeddings(
                   n, dim, curvature, sigma, seed))).to(device))
    mp.setattr(TES, "TorchSampler",
               lambda seed, device: ReplaySampler(jax.random.PRNGKey(seed)))
    mp.setattr(TS, "StatsSampler", lambda seed, device: ReplaySampler())
    mp.setattr(TET, "GeneratorSampler",
               lambda seed, device=None: ReplayDraws(
                   jax.random.PRNGKey(seed), 3))


def _run_both(jax_main, port_main, args, root):
    jax_main(args + ["--output-dir", str(root / "jax")])
    with pytest.MonkeyPatch.context() as mp:
        jax_draws(mp)
        port_main(args + ["--output-dir", str(root / "port"),
                          "--device", "cpu"])
    return str(root / "jax"), str(root / "port")


@pytest.fixture(scope="module")
def enhanced_dirs(corpus_file, tmp_path_factory):
    return _run_both(JE.main, TE.main, ["--corpus-path", corpus_file]
                     + ENH_ARGS, tmp_path_factory.mktemp("enh"))


@pytest.fixture(scope="module")
def corpus_only_dirs(corpus_file, tmp_path_factory):
    return _run_both(JE.main, TE.main, ["--corpus-path", corpus_file]
                     + CORPUS_ARGS, tmp_path_factory.mktemp("corpus"))


@pytest.fixture(scope="module")
def base_dirs(corpus_file, tmp_path_factory):
    return _run_both(JB.main, TB.main, ["--corpus-path", corpus_file]
                     + BASE_ARGS, tmp_path_factory.mktemp("base"))


def _read(path, name):
    with open(os.path.join(path, name)) as f:
        return json.load(f)


def comparable_merges(path):
    """How many merges of an artifact directory lie above the acosh clamp
    floor: the geometric channels chain a token with its own midpoints,
    halving the distance each time, and below the floor every candidate
    distance ties at 0, so either package may pick any of them. Distances
    from the saved rows (a merged row never moves), in float64."""
    merges = _read(path, "merges.json")
    emb = np.load(os.path.join(path, "embeddings.npy")).astype(np.float64)
    t2i = {}
    for i, t in enumerate(_read(path, "vocab.json")):
        t2i.setdefault(t, i)
    sig = np.ones(emb.shape[1])
    sig[0] = -1.0
    for k, (a, b, _) in enumerate(merges):
        gram = -float(np.sum(emb[t2i[a]] * sig * emb[t2i[b]]))
        if np.arccosh(max(gram, 1.0)) <= CLAMP_FLOOR:
            return k
    return len(merges)


@pytest.mark.parametrize("which", ["enhanced", "corpus_only", "base"])
def test_cli_merges_match_jax(which, request):
    """The whole history for the corpus-only recipe (31 merges); up to the
    clamp floor where a geometric channel reaches it: the first 9 of the
    enhanced recipe's 30 merges and 7 of the base recipe's 40
    (``ABOVE_FLOOR``)."""
    jdir, tdir = request.getfixturevalue(f"{which}_dirs")
    merges, jmerges = _read(tdir, "merges.json"), _read(jdir, "merges.json")
    n = comparable_merges(jdir)
    assert n == ABOVE_FLOOR[which] and len(merges) == len(jmerges)
    if which == "corpus_only":
        assert n == len(jmerges)
    assert merges[:n] == jmerges[:n]
    n_init = len(jmerges) and len(_read(jdir, "vocab.json")) - len(jmerges)
    assert _read(tdir, "vocab.json")[:n_init + n] == \
        _read(jdir, "vocab.json")[:n_init + n]
    np.testing.assert_allclose(
        np.load(os.path.join(tdir, "embeddings.npy"))[:n_init + n],
        np.load(os.path.join(jdir, "embeddings.npy"))[:n_init + n],
        rtol=1e-4, atol=PRETRAINED_ATOL if which == "corpus_only" else 1e-5)
    tcfg, jcfg = _read(tdir, "config.json"), _read(jdir, "config.json")
    assert tcfg.keys() == jcfg.keys()
    assert _read(tdir, "train_config.json") == _read(jdir,
                                                     "train_config.json")


@pytest.mark.parametrize("which", ["enhanced", "corpus_only", "base"])
def test_cli_artifacts_load_in_jax(which, request):
    jdir, tdir = request.getfixturevalue(f"{which}_dirs")
    jcls, tcls = ((JaxTok, HyperbolicTokenizer) if which == "base"
                  else (JaxEnh, EnhancedHyperbolicTokenizer))
    in_jax = jcls.load(tdir)
    port = tcls.load(tdir, device="cpu")
    ref = jcls.load(jdir)
    for text in LINES[:3] + ["the dog ran after the cat"]:
        ids = port.encode(text)
        assert in_jax.encode(text) == ids
        assert port.decode(ids) == text
        if which == "corpus_only":
            assert ref.encode(text) == ids


def test_enhanced_cli_flags_and_stages(corpus_file, tmp_path):
    """--config sets defaults and explicit flags win; metrics stream as
    JSONL with one record per chunk, the stage records and the summary; a
    profiler trace is written; --debug-nans turns on the NaN checks; the
    merge-tree supervision moves the saved embeddings."""
    from hyptokenizer_tpu_torch.utils import metrics
    from hyptokenizer_tpu_torch.utils.config import TrainConfig

    cfg_path = str(tmp_path / "cfg.json")
    TrainConfig(embedding_dim=8, steps=20, log_every=10,
                merge_threshold=2.0, max_vocab_size=128,
                use_hierarchical=False, use_adaptive_curvature=False,
                use_compression_aware=False, embed_steps=20,
                corpus_max_tokens=2048).to_json(cfg_path)
    out = str(tmp_path / "enh")
    mpath = str(tmp_path / "metrics.jsonl")
    try:
        TE.main(["--corpus-path", corpus_file, "--output-dir", out,
                 "--config", cfg_path, "--steps", "16",
                 "--metrics-path", mpath, "--profile",
                 str(tmp_path / "trace"), "--debug-nans", "--device", "cpu",
                 "--hierarchy-supervision", "merge-tree",
                 "--hs-ranking-steps", "30"])
        assert metrics.nan_checks_enabled() and torch.is_anomaly_enabled()
    finally:
        metrics.enable_nan_checks(False)
    with open(mpath) as f:
        records = [json.loads(ln) for ln in f]
    assert len([r for r in records if "step" in r]) == 2  # 16 / 10 -> 2
    assert all("time" in r for r in records)
    assert any("merges_per_sec" in r for r in records)
    stages = {r["stage"]: r for r in records if "stage" in r}
    assert set(stages) == {"embed_pretrain", "train",
                           "hierarchy_supervision"}
    assert stages["embed_pretrain"]["steps"] == 20
    assert all(r["seconds"] >= 0 for r in stages.values())
    assert (tmp_path / "trace" / "trace.json").exists()
    eff = _read(out, "train_config.json")
    assert eff["steps"] == 16 and eff["embedding_dim"] == 8
    assert eff["use_hierarchical"] is False
    cfg2 = TrainConfig.from_json(os.path.join(out, "train_config.json"))
    assert cfg2.tokenizer_kwargs()["max_vocab_size"] == 128
    emb = np.load(os.path.join(out, "embeddings.npy"))
    assert emb.shape[1] == 9 and np.isfinite(emb).all()


def test_base_cli_resume_and_metrics(corpus_file, tmp_path):
    """train_tokenizer: 40 steps in one run equal 20 steps, a checkpoint,
    and 20 more after --resume in a fresh process state."""
    args = ["--corpus-path", corpus_file, "--device", "cpu"] + BASE_ARGS
    whole = str(tmp_path / "whole")
    TB.main(args + ["--output-dir", whole,
                    "--metrics-path", str(tmp_path / "m.jsonl")])
    with open(tmp_path / "m.jsonl") as f:
        records = [json.loads(ln) for ln in f]
    assert len(records) == 2 and all("vocab_size" in r for r in records)
    ck = str(tmp_path / "ck")
    part = args[:] + ["--checkpoint-dir", ck, "--checkpoint-every", "1"]
    part[part.index("--steps") + 1] = "20"
    TB.main(part + ["--output-dir", str(tmp_path / "half")])
    TB.main(part + ["--output-dir", str(tmp_path / "resumed"), "--resume"])
    assert _read(str(tmp_path / "resumed"), "merges.json") == \
        _read(whole, "merges.json")
    np.testing.assert_array_equal(
        np.load(os.path.join(tmp_path, "resumed", "embeddings.npy")),
        np.load(os.path.join(whole, "embeddings.npy")))


@pytest.fixture
def no_process_group():
    """A test that makes a world of one in this process leaves none."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("flag", ["--mesh", "--multihost"])
def test_sharded_flags_refuse(corpus_file, enhanced_dirs, tmp_path, flag,
                              no_process_group):
    """``--mesh`` (a CPU world of one) and ``--multihost`` with no
    coordinator (one process, as in JAX) train through the sharded path
    (the v3 sync at D = 1, the corpus aligned by --corpus-shards' default
    8) and give the unsharded CLI's merges and rows, bit for bit. (The
    name is kept from when these flags refused to run.)"""
    out = str(tmp_path / "o")
    with pytest.MonkeyPatch.context() as mp:
        jax_draws(mp)
        tok = TE.main(["--corpus-path", corpus_file] + ENH_ARGS
                      + ["--output-dir", out, "--device", "cpu", flag])
    assert tok.mesh is not None and tok.mesh.size == 1
    from hyptokenizer_tpu_torch.parallel.sharded import select_sync_path
    assert select_sync_path(tok.enh_state, tok.enh_config, tok.mesh) == "v3"
    ref = enhanced_dirs[1]
    assert _read(out, "merges.json") == _read(ref, "merges.json")
    assert len(_read(out, "merges.json")) > 10
    np.testing.assert_array_equal(
        np.load(os.path.join(out, "embeddings.npy")),
        np.load(os.path.join(ref, "embeddings.npy")))


def test_bench_scaling_cli(capsys, no_process_group):
    """The port's bench_scaling (a world of one) prints the JAX CLI's
    JSON line (tests/test_cli.py's test_bench_scaling_cli)."""
    from hyptokenizer_tpu_torch.cli import bench_scaling
    res = bench_scaling.main(["--max-vocab-size", "256", "--n-init", "64",
                              "--embedding-dim", "8", "--steps", "32",
                              "--warmup", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    data = json.loads(out.strip().splitlines()[-1])
    assert set(data) == {"process", "n_processes", "loop",
                         "steps_per_sec_by_devices"}
    assert data["n_processes"] == 1 and data["process"] == 0
    assert all(v > 0 for v in data["steps_per_sec_by_devices"].values())
    assert int(res["states"][1].step) == 40


def test_preprocess_wiki_matches_jax(corpus_file, tmp_path):
    from hyptokenizer_tpu.cli import preprocess_wiki as JP
    from hyptokenizer_tpu_torch.cli import preprocess_wiki as TP
    for mod, name in ((JP, "j"), (TP, "t")):
        mod.main(["--input-path", corpus_file, "--output-dir",
                  str(tmp_path / name), "--min-line-length", "5",
                  "--min-count", "2"])
    for f in ("wiki_processed.txt", "vocab_initial.txt"):
        assert (tmp_path / "t" / f).read_text() == \
            (tmp_path / "j" / f).read_text()


def test_cli_default_device_raises_without_a_card(corpus_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.main(["--corpus-path", corpus_file,
                 "--output-dir", str(tmp_path / "o")])
