"""The port's evaluation and downstream CLIs (hyptokenizer_tpu_torch/cli/)
with ``--device cpu``, mirroring ``tests/test_cli.py``'s tests of the JAX
CLIs with the same flags, on its tiny corpus. Where both CLIs are
deterministic (token counts, quality and compression ratios, baseline
statistics, relative differences, the WordNet graph from a stub, the
download messages), the outputs must be equal; the tokenizer both load is
the one the port's ``train_tokenizer`` CLI trained. Nothing is fetched:
``download_data`` runs with ``urllib.request.urlretrieve`` replaced, and
``build_wordnet_graph`` with a stub of nltk's WordNet.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from hyptokenizer_tpu.cli import analysis as JA
from hyptokenizer_tpu.cli import benchmark_efficiency as JBE
from hyptokenizer_tpu.cli import build_wordnet_graph as JW
from hyptokenizer_tpu.cli import compare_tokenizers as JCT
from hyptokenizer_tpu.cli import download_data as JD
from hyptokenizer_tpu.cli import train_baseline_tokenizers as JTB
from hyptokenizer_tpu_torch.cli import analysis as TA
from hyptokenizer_tpu_torch.cli import benchmark_efficiency as TBE
from hyptokenizer_tpu_torch.cli import build_wordnet_graph as TW
from hyptokenizer_tpu_torch.cli import compare_tokenizers as TCT
from hyptokenizer_tpu_torch.cli import download_data as TD
from hyptokenizer_tpu_torch.cli import train_baseline_tokenizers as TTB
from hyptokenizer_tpu_torch.cli import train_nlp_tasks as TN
from hyptokenizer_tpu_torch.cli import train_retrieval as TR
from tests.torch_port_common import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "corpus.txt"
    lines = ["the cat sat on the mat and the dog sat on the log",
             "a cat and a dog and a rat sat together",
             "the rat ran to the mat and the cat ran after it"] * 5
    p.write_text("\n".join(lines))
    return str(p)


@pytest.fixture(scope="module")
def trained_dir(corpus_file, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tok") / "t")
    from hyptokenizer_tpu_torch.cli import train_tokenizer
    train_tokenizer.main([
        "--corpus-path", corpus_file, "--output-dir", out,
        "--embedding-dim", "8", "--steps", "40", "--log-every", "40",
        "--merge-threshold", "2.0", "--max-vocab-size", "128"] + CPU)
    return out


def test_benchmark_efficiency(trained_dir, corpus_file, tmp_path):
    args = ["--tokenizer-dir", trained_dir, "--text-path", corpus_file,
            "--max-lines", "10", "--runs", "1"]
    got = TBE.main(args + ["--output-path", str(tmp_path / "t.json")] + CPU)
    with open(tmp_path / "t.json") as f:
        assert json.load(f)["tokenize"]["tokens_per_sec"] > 0
    JBE.main(args + ["--output-path", str(tmp_path / "j.json")])
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    for path in ("tokenize", "encode"):
        assert got[path]["total_tokens"] == want[path]["total_tokens"] > 0
        assert got[path]["tokens_per_sec"] > 0
    assert got["training"] == want["training"]
    assert got.get("training_summary") == want.get("training_summary")


def test_compare_tokenizers(trained_dir, corpus_file, tmp_path):
    pytest.importorskip("tokenizers")
    TTB.main(["--input-file", corpus_file, "--output-dir",
              str(tmp_path / "base"), "--vocab-size", "100", "--kinds", "bpe"])
    specs = ["--tokenizer", f"hyp={trained_dir}", "--tokenizer",
             f"bpe={tmp_path / 'base' / 'bpe_100.json'}"]
    common = specs + ["--text-path", corpus_file, "--max-lines", "10",
                      "--runs", "1", "--no-plot"]
    TCT.main(common + ["--output-dir", str(tmp_path / "t")] + CPU)
    JCT.main(common + ["--output-dir", str(tmp_path / "j")])
    got, want = (json.load(open(tmp_path / d / "comparison.json"))
                 for d in ("t", "j"))
    assert set(got) == {"hyp", "bpe"}
    for name in got:
        assert got[name]["quality"] == want[name]["quality"]
        assert got[name]["compression"] == want[name]["compression"]
        assert got[name]["throughput"]["total_tokens"] == \
            want[name]["throughput"]["total_tokens"]


def test_compare_tokenizers_plots(trained_dir, corpus_file, tmp_path):
    TCT.main(["--tokenizer", f"hyp={trained_dir}", "--text-path",
              corpus_file, "--output-dir", str(tmp_path), "--max-lines",
              "10", "--runs", "1"] + CPU)
    assert os.path.exists(tmp_path / "comparison.png")
    assert os.path.exists(tmp_path / "comparison_radar.png")


def test_baselines_cli(corpus_file, tmp_path):
    pytest.importorskip("tokenizers")
    args = ["--input-file", corpus_file, "--vocab-size", "100",
            "--kinds", "bpe,char"]
    got = TTB.main(args + ["--output-dir", str(tmp_path / "t")])
    JTB.main(args + ["--output-dir", str(tmp_path / "j")])
    assert os.path.exists(tmp_path / "t" / "baseline_stats.json")
    with open(tmp_path / "j" / "baseline_stats.json") as f:
        want = json.load(f)
    assert set(got) == set(want) == {"bpe_100", "char"}
    for name in got:
        for key in ("vocab_size", "avg_tokens_per_line", "chars_per_token"):
            assert got[name][key] == want[name][key]


def test_train_retrieval_synthetic(tmp_path):
    out = str(tmp_path / "ret")
    res = TR.main([
        "--synthetic", "--output-dir", out, "--epochs", "1",
        "--batch-size", "8", "--batches-per-epoch", "2", "--image-size", "16",
        "--seq-len", "8", "--tower-dim", "16", "--projection-dim", "8"] + CPU)
    with open(os.path.join(out, "retrieval_history.json")) as f:
        hist = json.load(f)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert "text_to_image_r@1" in hist[0]
    best = torch.load(os.path.join(out, "best_params.pt"), weights_only=True)
    assert set(best) == set(res["params"])
    assert best["text_projector.fc1.weight"].shape == (32, 16)


def test_train_nlp_tasks_mlm(trained_dir, corpus_file, tmp_path):
    out = str(tmp_path / "nlp")
    results, models = TN.main([
        "--method", "hyperbolic", "--model-path", trained_dir,
        "--task", "mlm", "--train-text", corpus_file,
        "--val-text", corpus_file, "--output-dir", out,
        "--hidden-size", "32", "--num-layers", "1", "--num-heads", "2",
        "--max-length", "24", "--epochs", "1", "--batch-size", "8",
        "--max-lines", "12"] + CPU)
    with open(os.path.join(out, "nlp_results.json")) as f:
        assert json.load(f)["mlm_val_perplexity"] > 0
    assert results["mlm_val_perplexity"] > 0
    assert set(models) == {"mlm"}
    assert next(models["mlm"].parameters()).device.type == "cpu"


def test_train_nlp_tasks_classification(trained_dir, tmp_path):
    cls = tmp_path / "cls.tsv"
    rows = [("0", "the cat sat on the mat"), ("1", "a dog ran to the log"),
            ("0", "the cat and the rat"), ("1", "the dog sat together")] * 4
    cls.write_text("\n".join(f"{a}\t{b}" for a, b in rows))
    out = str(tmp_path / "nlp_cls")
    results, models = TN.main([
        "--method", "hyperbolic", "--model-path", trained_dir,
        "--task", "classification", "--train-cls", str(cls),
        "--val-cls", str(cls), "--output-dir", out, "--hidden-size", "32",
        "--num-layers", "1", "--num-heads", "2", "--max-length", "16",
        "--epochs", "1", "--batch-size", "8", "--max-lines", "16"] + CPU)
    with open(os.path.join(out, "nlp_results.json")) as f:
        acc = json.load(f)["classification_val_accuracy"]
    assert 0.0 <= acc <= 1.0 and acc == results["classification_val_accuracy"]
    assert models["classification"].classifier.out_features == 2


def test_analysis_cli(trained_dir, tmp_path):
    comp = {"a": {"throughput": {"tokens_per_sec": 120.0}},
            "b": {"throughput": {"tokens_per_sec": 80.0}}}
    cpath = tmp_path / "comparison.json"
    cpath.write_text(json.dumps(comp))
    args = ["--tokenizer-dir", trained_dir, "--comparison-json", str(cpath)]
    TA.main(args + ["--output-dir", str(tmp_path / "t")] + CPU)
    JA.main(args + ["--output-dir", str(tmp_path / "j")])
    for name in ("embedding_pca.png", "training_curves.png"):
        assert os.path.exists(tmp_path / "t" / name)
    got, want = (json.load(open(tmp_path / d / "relative_differences.json"))
                 for d in ("t", "j"))
    assert got == want


def test_analysis_grid_plots(tmp_path):
    grid = tmp_path / "results"
    for method, dist, ppl in [("hyperbolic", 1.2, 40.0), ("bpe", 2.0, 35.0)]:
        for v in (1000, 2000):
            d = grid / method / f"v{v}"
            d.mkdir(parents=True)
            (d / "distortion_stats.json").write_text(
                json.dumps({"mean": dist + v / 10000, "std": 0.1}))
            (d / "nlp_results.json").write_text(
                json.dumps({"mlm_perplexity": ppl - v / 1000}))
    out = tmp_path / "figs"
    TA.main(["--results-dir", str(grid), "--output-dir", str(out),
             "--methods", "hyperbolic,bpe,missing",
             "--vocab-sizes", "1000,2000,4000"] + CPU)
    assert os.path.exists(out / "distortion_vs_vocab.png")
    assert os.path.exists(out / "perplexity_vs_distortion.png")
    for fn in ("plot_distortion_vs_vocab", "plot_perplexity_vs_distortion",
               "plot_downstream_bars", "plot_efficiency_bars"):
        for methods, sizes in ((["hyperbolic", "bpe"], [1000, 2000]),
                               (["hyperbolic"], [1000, 2000, 4000])):
            n = getattr(TA, fn)(str(grid), methods, sizes,
                                str(out / f"{fn}.png"))
            assert n == getattr(JA, fn)(str(grid), methods, sizes,
                                        str(out / f"j_{fn}.png")), fn


def wordnet_stub(missing=False):
    """A stand-in for ``nltk.corpus.wordnet``: four noun synsets."""
    class Synset:
        def __init__(self, name, hypers=()):
            self._name, self._hypers = name, hypers

        def name(self):
            return self._name

        def hypernyms(self):
            return list(self._hypers)

    entity = Synset("entity.n.01")
    animal = Synset("animal.n.01", [entity])
    dog = Synset("dog.n.01", [animal])
    cat = Synset("cat.n.01", [animal])

    def all_synsets(pos):
        if missing:
            raise LookupError("Resource wordnet not found.")
        assert pos == "n"
        return [entity, animal, dog, cat]

    corpus = types.ModuleType("nltk.corpus")
    corpus.wordnet = types.SimpleNamespace(all_synsets=all_synsets)
    nltk = types.ModuleType("nltk")
    nltk.corpus = corpus
    return nltk, corpus


@pytest.mark.parametrize("missing", [False, True])
def test_build_wordnet_graph(monkeypatch, tmp_path, capsys, missing):
    pytest.importorskip("networkx")
    nltk, corpus = wordnet_stub(missing)
    monkeypatch.setitem(sys.modules, "nltk", nltk)
    monkeypatch.setitem(sys.modules, "nltk.corpus", corpus)
    outs = {}
    for name, mod in (("t", TW), ("j", JW)):
        path = str(tmp_path / f"{name}.pkl")
        if missing:
            with pytest.raises(SystemExit) as e:
                mod.main(["--output-path", path])
            assert "wordnet data is not installed" in str(e.value)
            continue
        mod.main(["--output-path", path])
        outs[name] = capsys.readouterr().out.replace(path, "PATH")
    if not missing:
        assert outs["t"] == outs["j"]
        assert "4 nodes / 3 edges" in outs["t"]
        from hyptokenizer_tpu_torch.evals import load_wordnet_graph
        g = load_wordnet_graph(str(tmp_path / "t.pkl"))
        assert g.has_edge("dog.n.01", "animal.n.01")


@pytest.mark.parametrize("works", [False, True])
def test_download_data_fetches_nothing(monkeypatch, tmp_path, capsys, works):
    import urllib.request
    asked = []

    def urlretrieve(url, dest):
        asked.append(url)
        if not works:
            raise OSError("network unreachable")
        with open(dest, "w") as f:
            f.write("stub")

    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    outs = {}
    for name, mod in (("t", TD), ("j", JD)):
        out = str(tmp_path / name)
        for dataset in ("wikitext103", "coco"):
            mod.main(["--dataset", dataset, "--output-dir", out])
        outs[name] = capsys.readouterr().out.replace(out, "OUT")
    assert outs["t"] == outs["j"]
    assert len(asked) == 2
    assert ("downloaded to" in outs["t"]) == works
    assert ("download failed" in outs["t"]) != works
    assert "COCO requires manual download" in outs["t"]


@pytest.mark.parametrize("cli", ["benchmark_efficiency", "compare_tokenizers",
                                 "analysis", "train_nlp_tasks",
                                 "train_retrieval"])
def test_device_defaults_to_the_card(monkeypatch, tmp_path, cli,
                                     trained_dir, corpus_file):
    """With no card, a CLI given no ``--device`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o")
    argv = {
        "benchmark_efficiency": ["--tokenizer-dir", trained_dir,
                                 "--text-path", corpus_file],
        "compare_tokenizers": ["--tokenizer", f"hyp={trained_dir}",
                               "--text-path", corpus_file,
                               "--output-dir", out],
        "analysis": ["--tokenizer-dir", trained_dir, "--output-dir", out],
        "train_nlp_tasks": ["--model-path", trained_dir, "--output-dir", out,
                            "--train-text", corpus_file],
        "train_retrieval": ["--synthetic", "--output-dir", out],
    }[cli]
    mod = {"benchmark_efficiency": TBE, "compare_tokenizers": TCT,
           "analysis": TA, "train_nlp_tasks": TN, "train_retrieval": TR}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
