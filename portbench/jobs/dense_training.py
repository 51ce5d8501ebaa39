"""Job kind: one whole all-features training on the dense channel.

A job is the README Quick start's merge training as the training CLI runs
it: ``EnhancedHyperbolicTokenizer`` with the configuration's keys
(``CTOR_KEYS``; every other key at the constructor's default, ``ASSUMED``)
on the traffic's lines as the constructor reads a corpus file (each line
without its newline), then ``optimize_merges`` with the configuration's
steps, chunk length and phase transitions, the loop's draws handed in by
the benchmark (:class:`portbench.draws.MergeDraws`). Every job of a run
starts from the same points: the CLI's initial points
(``data.initialize_embeddings`` at the traffic's ``points_seed``, the
CLI's default ``--seed``), pretrained once in set-up as ``--embed-steps``
pretrains them (``embed_train.train_embeddings`` on the corpus file's
character ids, the CLI's sampler at that seed).

Set-up reads the corpus, builds the vocabulary, draws and pretrains the
points and runs one warm-up: a constructor and the cell's
``warmup_merges`` merges. The judge holds the pretrained table to the
reference's pretraining from the same points and draws, and the training
to :func:`reference.dense_training.judge`.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import draws as D
from portbench import trace as T
from portbench.jobs import embed_pretrain as P
from portbench.jobs import enhanced_training as E
from portbench.reference import corpus as C
from portbench.reference import dense_training as R
from portbench.reference import embed as RE

# The configuration keys handed to the constructor as they are.
CTOR_KEYS = (
    "max_vocab_size", "merge_threshold", "curvature", "alpha", "beta",
    "gamma", "use_frequency_aware", "use_hierarchical",
    "use_compression_aware", "use_adaptive_curvature",
    "optimize_curvature_freq", "use_dense_channel", "compression_weight",
    "min_pair_freq", "merge_batch", "corpus_max_tokens", "corpus_shards",
    "merge_policy", "queue_size", "freq_table_size", "curvature_lr",
    "hierarchy_weight", "distortion_weight")
# What the constructor and the loop take at their defaults: the reference's
# recipe reads these where the configuration file leaves them out.
ASSUMED = R.DEFAULTS
OUTPUTS = ("out", "log")   # what the judge reads of a job


class Context:
    def __init__(self, cell, cfg, traffic, seed, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.device = seed, device
        self.lines = C.traffic_lines(traffic)
        self.vocab = C.traffic_vocab(traffic, self.lines)
        self.texts = [ln.rstrip("\n") for ln in self.lines]
        self.ctor = {k: cfg[k] for k in CTOR_KEYS}
        self.emb = None
        self._morph = None

    @property
    def morph(self):
        if self._morph is None:
            self._morph = R.morphology(self.texts)
        return self._morph

    def points(self) -> torch.Tensor:
        """The CLI's initial points at the traffic's ``points_seed``."""
        from hyptokenizer_tpu_torch.utils import data

        t = self.traffic
        return data.initialize_embeddings(
            len(self.vocab), self.cfg["embedding_dim"], self.cfg["curvature"],
            t["init_sigma"], t["points_seed"], device=self.device)

    def pretrain_draws(self) -> D.EmbedDraws:
        """The CLI's pretraining sampler (``GeneratorSampler(--seed)``):
        the same draws."""
        return D.EmbedDraws(self.traffic["points_seed"], self.device)


def _train(ctx: Context, draws, steps: int):
    from hyptokenizer_tpu_torch.tokenizer import (
        EnhancedHyperbolicTokenizer, NormalizerConfig)

    cfg = ctx.cfg
    normalizer = NormalizerConfig(pre_split=E.PRE_SPLIT[cfg["pre_split"]])
    t0 = time.perf_counter()
    tok = EnhancedHyperbolicTokenizer(
        ctx.vocab, ctx.emb, device=ctx.device, corpus_sample=ctx.texts,
        normalizer=normalizer, **ctx.ctor)
    E._sync(ctx.device)
    ctor_s = time.perf_counter() - t0
    tok.sampler = draws
    tok.optimize_merges(
        steps=steps, log_every=cfg["log_every"],
        phase_transition_steps={2: cfg["phase2_step"],
                                3: cfg["phase3_step"]})
    E._sync(ctx.device)
    return tok, ctor_s


def _pretrain(ctx: Context):
    from hyptokenizer_tpu_torch.tokenizer import embed_train
    from hyptokenizer_tpu_torch.utils import data

    cfg = ctx.cfg
    if not cfg["embed_steps"]:     # the CLI pretrains nothing
        return ctx.points(), torch.zeros(1)
    ids = data.encode_corpus_chars(ctx.lines, ctx.vocab,
                                   max_tokens=cfg["embed_corpus_tokens"])
    out = embed_train.train_embeddings(
        ctx.points(), torch.from_numpy(ids), len(ctx.vocab),
        ctx.pretrain_draws(), steps=cfg["embed_steps"],
        batch=cfg["embed_batch"], negatives=cfg["embed_negatives"],
        lr=cfg["embed_lr"])
    E._sync(ctx.device)
    return out


def set_up(cell: dict, cfg: dict, traffic: dict, seed: int,
           device) -> Context:
    ctx = Context(cell, cfg, traffic, seed, device)
    ctx.emb, ctx.emb_losses = _pretrain(ctx)
    _train(ctx, D.MergeDraws(D.sub_seed(seed, 9, 1), device),
           cell["warmup_merges"])
    return ctx


def job(ctx: Context, k: int, traced: bool = False) -> dict:
    draws = D.MergeDraws(D.sub_seed(ctx.seed, 2, k), ctx.device)
    steps = ctx.cfg["steps"]
    summary = None
    if traced:
        marks = E.LaunchMarks() if ctx.device.type == "cuda" else None
        try:
            with T.Spans(E._layers()):
                (tok, ctor_s), summary = T.profile_call(
                    lambda: _train(ctx, draws, steps), ctx.device)
        finally:
            launches = marks.close() if marks else []
        summary["launches_marked"] = launches
    else:
        tok, ctor_s = _train(ctx, draws, steps)
    n = len(tok.merge_history)
    n0 = len(ctx.vocab)
    stats = tok.training_stats
    p2, p3 = ctx.cfg["phase2_step"], ctx.cfg["phase3_step"]
    return {
        "merges": n,
        "phase2_merges": max(0, min(n, p3) - p2),
        "ctor_s": ctor_s,
        "chunks": len(stats),
        "syncs": sum(s["chunk_syncs"] for s in stats),
        "chunk_syncs": [s["chunk_syncs"] for s in stats],
        "traced": traced,
        "trace": summary,
        "out": {"merges": tok.state.merges[:n], "emb": tok.state.emb[:n0 + n],
                "curvature": tok.curvature, "vocab": list(tok.vocab)},
        "log": draws.log,
    }


def recipe(cfg: dict) -> R.Recipe:
    return R.Recipe.from_config(cfg)


def reference_corpus(ctx: Context) -> torch.Tensor:
    """The corpus ids as the constructor lays them out, worked out by the
    reference: the lines split into words, cut at the token budget,
    shard-aligned."""
    cfg = ctx.cfg
    ids = C.encode_chars(ctx.texts, ctx.vocab, cfg["corpus_max_tokens"],
                         E.PRE_SPLIT[cfg["pre_split"]])
    return torch.from_numpy(R.shard_align(ids, cfg["corpus_shards"])).to(
        ctx.device)


def reference_pretraining(ctx: Context):
    """The reference's pretraining from the CLI's points and draws, its
    corpus ids its own: (table, losses)."""
    cfg = ctx.cfg
    if not cfg["embed_steps"]:
        return ctx.points(), torch.zeros(1)
    ids = C.encode_chars(ctx.lines, ctx.vocab, cfg["embed_corpus_tokens"])
    return RE.train(
        ctx.points(), torch.from_numpy(ids).to(ctx.device), len(ctx.vocab),
        ctx.pretrain_draws(), cfg["embed_steps"], cfg["embed_batch"],
        cfg["embed_negatives"], cfg["embed_lr"])


def judge(ctx: Context, rec: dict) -> dict:
    """The pretrained table that every training started from against the
    reference's pretraining (``table_gap``, ``loss_gap``:
    ``embed_pretrain.compare``), and a training's ``OUTPUTS`` followed by
    the reference (:func:`reference.dense_training.judge`) from that
    table."""
    numbers = P.compare({"emb": ctx.emb, "losses": ctx.emb_losses},
                        *reference_pretraining(ctx))
    numbers.update(_judge_training(ctx, rec))
    return numbers


def _judge_training(ctx: Context, rec: dict) -> dict:
    """:func:`reference.dense_training.judge` of a training from the
    context's table. Prints what is not compared (``dense_gap``, against
    all active pairs) and how the search went, on standard error."""
    numbers = R.judge(recipe(ctx.cfg), reference_corpus(ctx), ctx.emb,
                      ctx.vocab, ctx.morph, rec["out"], rec["log"])
    print(f"# not compared: dense_gap {numbers['dense_gap']!r}; search "
          f"{R.last_search}; unowed {R.last_unowed!r}", file=sys.stderr)
    return numbers


def control(cell: dict, cfg: dict, traffic: dict, seed: int, device,
            dtype) -> dict:
    """The numbers compared when the reference's own trainer in ``dtype``
    (:func:`reference.dense_training.train`) stands in the program's
    place, for the first job of a run with seed ``seed``, from the
    reference's own pretraining (float32, so its table reads no gap) of
    the CLI's points; its ``point_gap`` the larger of the judge's and that
    of its rows merged in ``dtype``, measured as the judge measures it,
    against its float32 rows."""
    ctx = Context(cell, cfg, traffic, seed, device)
    ctx.emb, _ = reference_pretraining(ctx)
    draws = D.MergeDraws(D.sub_seed(seed, 2, 0), device)
    out = R.train(recipe(cfg), reference_corpus(ctx), ctx.emb, ctx.vocab,
                  ctx.morph, draws, dtype)
    numbers = {"table_gap": 0.0, "loss_gap": 0.0}
    numbers.update(_judge_training(ctx, {"out": out, "log": draws.log}))
    if "emb_low" in out:
        ref = out["emb"]
        scale = torch.clamp_min(ref.abs().amax(1), 1.0)
        gap = float(((out["emb_low"] - ref).abs().amax(1) / scale).max())
        numbers["point_gap"] = max(numbers["point_gap"], gap)
    return numbers
