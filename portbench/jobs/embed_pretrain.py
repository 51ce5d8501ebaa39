"""Job kind: one whole embedding pretraining.

A job is the README Quick start's pretraining stage as the training CLI
runs it (``--embed-steps``): ``embed_train.train_embeddings`` over the
corpus's character ids, from the Quick start's initial points (drawn from
the run's seed), with a fresh sampler seeded for the job.

Set-up reads the corpus, builds the vocabulary (the characters seen at
least ``vocab_min_count`` times), encodes the corpus with the program's
encoder, as the CLI does before its pretraining, and runs the cell's
``warmup_steps`` steps.
"""

from __future__ import annotations

import torch

from portbench import draws as D
from portbench import trace as T
from portbench.reference import corpus as C
from portbench.reference import embed as R
from portbench.reference import geometry as G

OUTPUTS = ("draw_seed", "out")   # what the judge reads of a job


class Context:
    def __init__(self, cell, cfg, traffic, seed, device):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.device = seed, device
        self.lines = C.traffic_lines(traffic)
        self.vocab = C.traffic_vocab(traffic, self.lines)
        g = D.generator(D.sub_seed(seed, 1), device)
        self.emb0 = G.traffic_points(traffic, g, len(self.vocab),
                                     cfg["embedding_dim"])


def _train(ctx: Context, draws, steps: int):
    from hyptokenizer_tpu_torch.tokenizer import embed_train

    cfg = ctx.cfg
    emb, losses = embed_train.train_embeddings(
        ctx.emb0, ctx.ids, len(ctx.vocab), draws, steps=steps,
        batch=cfg["embed_batch"], negatives=cfg["embed_negatives"],
        lr=cfg["embed_lr"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return emb, losses


def set_up(cell: dict, cfg: dict, traffic: dict, seed: int,
           device) -> Context:
    from hyptokenizer_tpu_torch.utils import data

    ctx = Context(cell, cfg, traffic, seed, device)
    ctx.ids = torch.from_numpy(data.encode_corpus_chars(
        ctx.lines, ctx.vocab, max_tokens=cfg["embed_corpus_tokens"]))
    _train(ctx, D.EmbedDraws(D.sub_seed(seed, 9), device),
           cell["warmup_steps"])
    return ctx


def job(ctx: Context, k: int, traced: bool = False) -> dict:
    seed = D.sub_seed(ctx.seed, 2, k)
    draws = D.EmbedDraws(seed, ctx.device)
    steps = ctx.cfg["embed_steps"]
    summary = None
    if traced:
        from hyptokenizer_tpu_torch.ops import lorentz
        from hyptokenizer_tpu_torch.tokenizer import embed_train

        with T.Spans([(embed_train, "_ranking_nll", "embed.loss"),
                      (lorentz, "rsgd_step", "embed.rsgd_step")]):
            (emb, losses), summary = T.profile_call(
                lambda: _train(ctx, draws, steps), ctx.device)
        summary["steps"] = steps
    else:
        emb, losses = _train(ctx, draws, steps)
    return {"steps": steps, "traced": traced, "trace": summary,
            "draw_seed": seed, "out": {"emb": emb, "losses": losses}}


def judge(ctx: Context, rec: dict) -> dict:
    """A pretraining's ``OUTPUTS`` against the reference's from the same
    inputs and draws: ``table_gap`` (the widest coordinate gap over the
    table's largest coordinate or 1) and ``loss_gap`` (the last ten steps'
    mean loss, relative)."""
    return compare(rec["out"], *reference(ctx, rec["draw_seed"]))


def reference(ctx: Context, draw_seed: int, dtype=torch.float32):
    """The reference's pretraining from the cell's inputs and the draws of
    ``draw_seed``, its corpus ids its own."""
    cfg = ctx.cfg
    ids = C.encode_chars(ctx.lines, ctx.vocab, cfg["embed_corpus_tokens"])
    return R.train(
        ctx.emb0, torch.from_numpy(ids).to(ctx.device), len(ctx.vocab),
        D.EmbedDraws(draw_seed, ctx.device), cfg["embed_steps"],
        cfg["embed_batch"], cfg["embed_negatives"], cfg["embed_lr"], dtype)


def control(cell: dict, cfg: dict, traffic: dict, seed: int, device,
            dtype) -> dict:
    """The numbers compared when the reference in ``dtype`` stands in the
    program's place, for the first job of a run with seed ``seed``."""
    ctx = Context(cell, cfg, traffic, seed, device)
    draw_seed = D.sub_seed(seed, 2, 0)
    emb, losses = reference(ctx, draw_seed, dtype)
    return compare({"emb": emb, "losses": losses},
                   *reference(ctx, draw_seed))


def compare(out: dict, ref, losses) -> dict:
    emb = out["emb"][:ref.shape[0]].float()
    scale = max(float(ref.abs().max()), 1.0)
    a = float(out["losses"][-10:].float().mean())
    b = float(losses[-10:].float().mean())
    return {"table_gap": float((emb - ref.float()).abs().max()) / scale,
            "loss_gap": abs(a - b) / max(abs(b), 1e-12)}
