"""Job kind: one whole enhanced-tokenizer training.

A job runs ``EnhancedHyperbolicTokenizer`` from its constructor through the
end of ``optimize_merges``, as ``bench.py``'s recipes and the training CLI
call them, on the traffic's lines and vocabulary, from points drawn for the
job from the run's seed by the traffic's rule for points, with the loop's
draws handed in by the benchmark (:class:`portbench.draws.MergeDraws`).

Set-up reads the traffic's corpus, builds its vocabulary and runs one
warm-up: a constructor and the cell's ``warmup_merges`` merges (the first
chunks of a training: every shape and kernel of the window, no whole
training).
"""

from __future__ import annotations

import time

import torch

from portbench import draws as D
from portbench import trace as T
from portbench.reference import corpus as C
from portbench.reference import corpus_training as R
from portbench.reference import geometry as G

# The configuration keys handed to the constructor as they are.
CTOR_KEYS = (
    "max_vocab_size", "merge_threshold", "curvature", "alpha", "beta",
    "gamma", "use_frequency_aware", "use_hierarchical",
    "use_compression_aware", "use_adaptive_curvature",
    "optimize_curvature_freq", "use_dense_channel", "min_pair_freq",
    "merge_batch", "corpus_max_tokens", "merge_policy", "queue_size",
    "freq_table_size", "max_token_len", "curvature_lr", "hierarchy_weight",
    "distortion_weight")
TRAIN_KEYS = ("steps", "log_every", "target_vocab_size")
OUTPUTS = ("emb0", "out", "log")   # what the judge reads of a job
PRE_SPLIT = {"words": C.WORDS_WITH_SPACE}


class Context:
    def __init__(self, cell, cfg, traffic, seed, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.device = seed, device
        self.lines = C.traffic_lines(traffic)
        self.vocab = C.traffic_vocab(traffic, self.lines)
        self.ctor = {k: cfg[k] for k in CTOR_KEYS}
        self.train = {k: cfg[k] for k in TRAIN_KEYS}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def points(ctx: Context, stream: int, k: int) -> torch.Tensor:
    g = D.generator(D.sub_seed(ctx.seed, stream, k), ctx.device)
    return G.traffic_points(ctx.traffic, g, len(ctx.vocab),
                            ctx.cfg["embedding_dim"])


def _train(ctx: Context, emb0, draws, train: dict):
    from hyptokenizer_tpu_torch.tokenizer import (
        EnhancedHyperbolicTokenizer, NormalizerConfig)

    normalizer = NormalizerConfig(pre_split=PRE_SPLIT[ctx.cfg["pre_split"]])
    t0 = time.perf_counter()
    tok = EnhancedHyperbolicTokenizer(
        ctx.vocab, emb0, device=ctx.device, corpus_sample=ctx.lines,
        normalizer=normalizer, **ctx.ctor)
    _sync(ctx.device)
    ctor_s = time.perf_counter() - t0
    tok.sampler = draws
    tok.optimize_merges(**train)
    _sync(ctx.device)
    return tok, ctor_s


def set_up(cell: dict, cfg: dict, traffic: dict, seed: int,
           device) -> Context:
    ctx = Context(cell, cfg, traffic, seed, device)
    warm = dict(ctx.train, steps=cell["warmup_merges"])
    _train(ctx, points(ctx, 9, 0), D.MergeDraws(D.sub_seed(seed, 9, 1),
                                                device), warm)
    return ctx


class LaunchMarks:
    """The step and merge counters around each launch of the segment
    kernel's wrapper, kept on the device until read."""

    def __init__(self):
        from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop

        self.mod = enhanced_loop
        self.fn = enhanced_loop.run_segment_cuda
        self.marks = []

        def marked(st, config, *args, **kw):
            before = torch.stack([st.base.step, st.base.num_merges,
                                  st.base.vocab_size]).clone()
            out = self.fn(st, config, *args, **kw)
            after = torch.stack([out.base.step, out.base.num_merges])
            self.marks.append((before, after, config.queue_size,
                               st.base.emb.shape[1],
                               bool(self.mod.uses_dense(config))))
            return out

        enhanced_loop.run_segment_cuda = marked

    def close(self) -> list:
        """Per launch: steps, merges, queue size, d1 and the active rows at
        its start (0 without the dense channel)."""
        self.mod.run_segment_cuda = self.fn
        out = []
        for before, after, k, d1, dense in self.marks:
            b, a = before.tolist(), after.tolist()
            out.append({"steps": a[0] - b[0], "merges": a[1] - b[1],
                        "queue_size": k, "d1": d1,
                        "dense_rows": b[2] if dense else 0})
        return out


def _layers() -> list:
    """The layers a training passes through, for the traced job's spans."""
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state

    tok = EnhancedHyperbolicTokenizer
    return [(tok, "__init__", "constructor"),
            (tok, "optimize_merges", "optimize_merges"),
            (tok, "_sync_merges_from_device", "vocabulary_strings"),
            (tok, "distance_statistics", "distance_statistics"),
            (enhanced_state, "sync_corpus", "corpus_sync"),
            (enhanced_state, "_maybe_update_curvature", "curvature_adam"),
            (enhanced_loop, "run_segment_cuda", "merge_segment")]


def job(ctx: Context, k: int, traced: bool = False) -> dict:
    emb0 = points(ctx, 1, k)
    draws = D.MergeDraws(D.sub_seed(ctx.seed, 2, k), ctx.device)
    summary = None
    if traced:
        marks = LaunchMarks() if ctx.device.type == "cuda" else None
        try:
            with T.Spans(_layers()):
                (tok, ctor_s), summary = T.profile_call(
                    lambda: _train(ctx, emb0, draws, ctx.train), ctx.device)
        finally:
            launches = marks.close() if marks else []
        summary["launches_marked"] = launches
    else:
        tok, ctor_s = _train(ctx, emb0, draws, ctx.train)
    n = len(tok.merge_history)
    n0 = len(ctx.vocab)
    stats = tok.training_stats
    return {
        "merges": n,
        "ctor_s": ctor_s,
        "ctor_morph_s": tok.ctor_stats["ctor_morph_s"],
        "chunks": len(stats),
        "syncs": sum(s["chunk_syncs"] for s in stats),
        "traced": traced,
        "trace": summary,
        "emb0": emb0,
        "out": {"merges": tok.state.merges[:n], "emb": tok.state.emb[:n0 + n],
                "curvature": tok.curvature, "vocab": list(tok.vocab)},
        "log": draws.log,
    }


def recipe(cfg: dict) -> R.Recipe:
    return R.Recipe.from_config(dict(
        cfg, curvature_freq=cfg["optimize_curvature_freq"]))


def reference_inputs(ctx: Context):
    """The corpus ids and token lengths, worked out by the reference."""
    ids = C.encode_chars(ctx.lines, ctx.vocab, ctx.cfg["corpus_max_tokens"],
                         PRE_SPLIT[ctx.cfg["pre_split"]])
    return (torch.from_numpy(ids).to(ctx.device),
            [len(t) for t in ctx.vocab])


def judge(ctx: Context, rec: dict) -> dict:
    """A training's ``OUTPUTS``, followed by the reference
    (:func:`reference.corpus_training.judge`)."""
    corpus0, lengths0 = reference_inputs(ctx)
    return R.judge(recipe(ctx.cfg), corpus0, rec["emb0"], lengths0,
                   ctx.vocab, rec["out"], rec["log"])


def control(cell: dict, cfg: dict, traffic: dict, seed: int, device,
            dtype) -> dict:
    """The numbers compared when the reference's own trainer in ``dtype``
    stands in the program's place, for the first job of a run with seed
    ``seed`` (its points and its draws' seed)."""
    ctx = Context(cell, cfg, traffic, seed, device)
    corpus0, lengths0 = reference_inputs(ctx)
    emb0 = points(ctx, 1, 0)
    draws = D.MergeDraws(D.sub_seed(seed, 2, 0), device)
    out = R.train(recipe(cfg), corpus0, emb0, lengths0, ctx.vocab, draws,
                  dtype)
    return R.judge(recipe(cfg), corpus0, emb0, lengths0, ctx.vocab, out,
                   draws.log)
