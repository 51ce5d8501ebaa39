"""Analysis & plotting over experiment artifacts.

    python -m hyptokenizer_tpu_torch.cli.analysis --tokenizer-dir out/tok \\
        --output-dir out/plots

Port of ``hyptokenizer_tpu/cli/analysis.py``: distortion-vs-vocab curves,
metric bar charts, the embedding projection (PCA of the tangent-space
chart) and pairwise relative differences. A tokenizer loads, and its
tangent chart is computed, on ``--device`` (default: the card); the plots
are matplotlib's, on the host.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from hyptokenizer_tpu_torch import _device
from hyptokenizer_tpu_torch.cli._common import setup_logging


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def plot_training_curves(stats: List[Dict], out_path: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    # Per-step records only (artifacts from older runs appended a summary
    # dict without a 'step' key to training_stats).
    stats = [s for s in stats if "step" in s]
    has_dist = any("mean_dist" in s for s in stats)
    n_panels = 4 if has_dist else 3
    fig, axes = plt.subplots(1, n_panels, figsize=(5 * n_panels, 4))
    steps = [s["step"] for s in stats]
    axes[0].plot(steps, [s["vocab_size"] for s in stats])
    axes[0].set_title("vocab size")
    axes[1].plot(steps, [s["threshold"] for s in stats])
    axes[1].set_yscale("log")
    axes[1].set_title("merge threshold")
    axes[2].plot(steps, [s.get("steps_per_sec", 0) for s in stats])
    axes[2].set_title("merge steps/sec")
    if has_dist:
        # Sampled distance statistics (reference logs these per chunk,
        # fast_hyperbolic_merge.py:513-527).
        for key, label in (("min_dist", "min"), ("mean_dist", "mean"),
                           ("max_dist", "max")):
            axes[3].plot(steps, [s.get(key, float("nan")) for s in stats],
                         label=label)
        axes[3].set_title("sampled pair distances")
        axes[3].legend()
    for ax in axes:
        ax.set_xlabel("step")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)


def plot_embedding_projection(emb: np.ndarray, out_path: str,
                              max_points: int = 2000, device=None):
    """2-D PCA of the tangent chart at the origin."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from hyptokenizer_tpu_torch.models.nlp import export_euclidean_embeddings
    eu = export_euclidean_embeddings(emb, device=device)[:max_points]
    eu = eu - eu.mean(0)
    _, _, vt = np.linalg.svd(eu, full_matrices=False)
    xy = eu @ vt[:2].T
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(xy[:, 0], xy[:, 1], s=3, alpha=0.5,
               c=np.arange(len(xy)), cmap="viridis")
    ax.set_title("token embeddings (tangent-chart PCA; color = merge order)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)


def relative_differences(results: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Pairwise relative differences (analysis.py:500-606 'statistical tests')."""
    out = {}
    names = list(results)
    for a in names:
        for b in names:
            if a < b:
                va, vb = results[a], results[b]
                denom = max(abs(va), abs(vb), 1e-12)
                out[f"{a}_vs_{b}"] = {
                    "a": va, "b": vb,
                    "relative_difference": (va - vb) / denom,
                }
    return out


def plot_distortion_vs_vocab(results_dir: str, methods: List[str],
                             vocab_sizes: List[int], out_path: str) -> int:
    """Mean±std hierarchy-distortion curves per method over vocab sizes.

    Layout convention (reference notebooks/analysis.py:43-116):
    ``{results_dir}/{method}/v{V}/distortion_stats.json`` as written by
    cli/eval_hierarchy.py. Missing grid points are skipped. Returns the
    number of points plotted.
    """
    import json
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 6))
    n_points = 0
    for method in methods:
        xs, means, stds = [], [], []
        for v in vocab_sizes:
            path = os.path.join(results_dir, method, f"v{v}",
                                "distortion_stats.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                stats = json.load(f)
            xs.append(v)
            means.append(stats["mean"])
            stds.append(stats.get("std", 0.0))
            n_points += 1
        if xs:
            means = np.asarray(means)
            stds = np.asarray(stds)
            ax.plot(xs, means, marker="o", label=method.capitalize())
            ax.fill_between(xs, means - stds, means + stds, alpha=0.2)
    ax.set_xlabel("Vocabulary Size")
    ax.set_ylabel("Average Distortion")
    ax.set_title("Distortion vs. Vocabulary Size")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return n_points


def plot_perplexity_vs_distortion(results_dir: str, methods: List[str],
                                  vocab_sizes: List[int],
                                  out_path: str) -> int:
    """Scatter of downstream MLM perplexity vs hierarchy distortion
    (reference notebooks/analysis.py:118-205). Reads
    ``{results_dir}/{method}/v{V}/distortion_stats.json`` and
    ``.../v{V}/nlp_results.json`` (cli/train_nlp_tasks.py output; either the
    mlm_perplexity or mlm_val_perplexity key). Returns points plotted."""
    import json
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 6))
    n_points = 0
    for method in methods:
        xs, ys, labels = [], [], []
        for v in vocab_sizes:
            base = os.path.join(results_dir, method, f"v{v}")
            spath = os.path.join(base, "distortion_stats.json")
            npath = os.path.join(base, "nlp_results.json")
            if not (os.path.exists(spath) and os.path.exists(npath)):
                continue
            with open(spath) as f:
                stats = json.load(f)
            with open(npath) as f:
                nlp = json.load(f)
            ppl = nlp.get("mlm_val_perplexity", nlp.get("mlm_perplexity"))
            if ppl is None:
                continue
            xs.append(stats["mean"])
            ys.append(ppl)
            labels.append(f"{v // 1000}K")
            n_points += 1
        if xs:
            ax.scatter(xs, ys, s=100, alpha=0.7, label=method.capitalize())
            for x, y, lab in zip(xs, ys, labels):
                ax.annotate(lab, (x, y), fontsize=8, alpha=0.7)
    ax.set_xlabel("Distortion")
    ax.set_ylabel("Perplexity")
    ax.set_title("Perplexity vs. Distortion")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return n_points


def plot_downstream_bars(results_dir: str, methods: List[str],
                         vocab_sizes: List[int], out_path: str) -> int:
    """Bar charts of MLM perplexity / classification accuracy per method
    (reference notebooks/analysis.py:208-298), from
    ``{results_dir}/{method}/v{V}/nlp_results.json``."""
    import json
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rows = []
    for method in methods:
        for v in vocab_sizes:
            path = os.path.join(results_dir, method, f"v{v}",
                                "nlp_results.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                r = json.load(f)
            ppl = r.get("mlm_val_perplexity", r.get("mlm_perplexity"))
            rows.append((f"{method}\nv{v // 1000}K", ppl,
                         r.get("classification_accuracy")))
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    labels = [r[0] for r in rows]
    ppls = [r[1] for r in rows]
    accs = [r[2] for r in rows]
    if any(p is not None for p in ppls):
        axes[0].bar(labels, [p or 0 for p in ppls])
        axes[0].set_title("MLM perplexity")
    if any(a is not None for a in accs):
        axes[1].bar(labels, [a or 0 for a in accs])
        axes[1].set_title("classification accuracy")
    for ax in axes:
        ax.tick_params(axis="x", rotation=30)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return len(rows)


def plot_efficiency_bars(results_dir: str, methods: List[str],
                         vocab_sizes: List[int], out_path: str) -> int:
    """Throughput + training-time bars (reference notebooks/analysis.py
    :338-429) from ``{results_dir}/{method}/v{V}/efficiency.json``
    (cli/benchmark_efficiency.py --output-path)."""
    import json
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rows = []
    for method in methods:
        for v in vocab_sizes:
            path = os.path.join(results_dir, method, f"v{v}",
                                "efficiency.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                r = json.load(f)
            tput = r.get("tokenize", {}).get("tokens_per_sec")
            train_s = (r.get("training_summary") or {}).get("train_seconds")
            rows.append((f"{method}\nv{v // 1000}K", tput, train_s))
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    labels = [r[0] for r in rows]
    if any(r[1] is not None for r in rows):
        axes[0].bar(labels, [r[1] or 0 for r in rows])
        axes[0].set_title("tokenization throughput (tokens/s)")
    if any(r[2] is not None for r in rows):
        axes[1].bar(labels, [(r[2] or 0) / 3600 for r in rows])
        axes[1].set_title("training time (hours)")
    for ax in axes:
        ax.tick_params(axis="x", rotation=30)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return len(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tokenizer-dir", type=str, default=None)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--comparison-json", type=str, default=None,
                   help="output of cli.compare_tokenizers for relative-diff "
                        "analysis")
    p.add_argument("--results-dir", type=str, default=None,
                   help="experiment grid root ({method}/v{V}/...) for the "
                        "distortion-vs-vocab and perplexity-vs-distortion "
                        "plots")
    p.add_argument("--methods", type=str,
                   default="hyperbolic,bpe,wordpiece,unigram",
                   help="comma-separated method subdirs under --results-dir")
    p.add_argument("--vocab-sizes", type=str, default="10000,20000,50000",
                   help="comma-separated vocab grid under --results-dir")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    setup_logging()
    _device.resolve(args.device)   # no card: raises unless --device cpu
    os.makedirs(args.output_dir, exist_ok=True)
    if not args.tokenizer_dir and not args.results_dir:
        p.error("need --tokenizer-dir and/or --results-dir")

    if args.results_dir:
        methods = [m for m in args.methods.split(",") if m]
        sizes = [int(v) for v in args.vocab_sizes.split(",") if v]
        n = plot_distortion_vs_vocab(
            args.results_dir, methods, sizes,
            os.path.join(args.output_dir, "distortion_vs_vocab.png"))
        print(f"wrote distortion_vs_vocab.png ({n} grid points)")
        n = plot_perplexity_vs_distortion(
            args.results_dir, methods, sizes,
            os.path.join(args.output_dir, "perplexity_vs_distortion.png"))
        print(f"wrote perplexity_vs_distortion.png ({n} grid points)")
        n = plot_downstream_bars(
            args.results_dir, methods, sizes,
            os.path.join(args.output_dir, "downstream_metrics.png"))
        print(f"wrote downstream_metrics.png ({n} grid points)")
        n = plot_efficiency_bars(
            args.results_dir, methods, sizes,
            os.path.join(args.output_dir, "efficiency.png"))
        print(f"wrote efficiency.png ({n} grid points)")

    if args.tokenizer_dir:
        stats_path = os.path.join(args.tokenizer_dir, "training_stats.json")
        if os.path.exists(stats_path):
            stats = _load_json(stats_path)
            if stats:
                plot_training_curves(
                    stats,
                    os.path.join(args.output_dir, "training_curves.png"))
                print("wrote training_curves.png")

        from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer
        tok = HyperbolicTokenizer.load(args.tokenizer_dir,
                                       device=args.device)
        plot_embedding_projection(
            tok.embeddings, os.path.join(args.output_dir,
                                         "embedding_pca.png"),
            device=args.device)
        print("wrote embedding_pca.png")

    if args.comparison_json:
        comp = _load_json(args.comparison_json)
        tps = {name: r["throughput"]["tokens_per_sec"]
               for name, r in comp.items()}
        rel = relative_differences(tps)
        with open(os.path.join(args.output_dir,
                               "relative_differences.json"), "w") as f:
            json.dump(rel, f, indent=2)
        print("wrote relative_differences.json")


if __name__ == "__main__":
    main()
