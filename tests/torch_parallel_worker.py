"""Worlds of CPU ranks for the tests of the port's ``parallel/``.

Imports torch and the port only (no JAX), so that a spawned rank starts
fast. :func:`run_world` starts ``n`` ranks (``spawn``) that meet through a
``FileStore`` under the test's ``tmp_path`` (no fixed port), each with one
torch thread, runs a list of jobs on every rank in turn and returns every
rank's results. The draws a rank makes are replayed from a recording
(:class:`PlaybackSampler`), so that ranks draw exactly what the JAX package
draws: the recording is taken in the test's process from the port's
single-device run with ``ReplaySampler`` (:class:`RecordingSampler`).
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class RecordingSampler:
    """Wraps a sampler and keeps each draw with its call, in order."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def _rec(self, name, args, out):
        self.calls.append((name, args, [np.asarray(x) for x in out]))
        return out

    def coherence(self, n, high):
        return self._rec("coherence", (n, high),
                         (self.inner.coherence(n, high),))[0]

    def curvature(self, hp, hn, ds, high):
        return self._rec("curvature", (hp, hn, ds, high),
                         tuple(self.inner.curvature(hp, hn, ds, high)))

    def randint(self, shape, high):
        return self._rec("randint", (tuple(shape), high),
                         (self.inner.randint(shape, high),))[0]

    def uniform(self, shape):
        return self._rec("uniform", (tuple(shape),),
                         (self.inner.uniform(shape),))[0]


class PlaybackSampler:
    """Replays a :class:`RecordingSampler`'s calls, checking each call."""

    def __init__(self, calls):
        self.calls = list(calls)
        self.pos = 0

    def _next(self, name, args):
        want, wargs, out = self.calls[self.pos]
        assert (want, tuple(wargs)) == (name, tuple(args)), (
            f"draw {self.pos}: recorded {want}{wargs}, asked {name}{args}")
        self.pos += 1
        return [torch.from_numpy(np.array(x)) for x in out]

    def coherence(self, n, high):
        return self._next("coherence", (n, high))[0]

    def curvature(self, hp, hn, ds, high):
        return tuple(self._next("curvature", (hp, hn, ds, high)))

    def randint(self, shape, high):
        return self._next("randint", (tuple(shape), high))[0]

    def uniform(self, shape):
        return self._next("uniform", (tuple(shape),))[0]


def _enhanced_out(st, path):
    n = int(st.base.num_merges)
    return dict(path=path, merges=st.base.merges[:n].numpy().copy(),
                q_i=st.q_i.numpy().copy(), q_j=st.q_j.numpy().copy(),
                pair_keys=st.pair_keys.numpy().copy(),
                pair_counts=st.pair_counts.numpy().copy(),
                curvature=float(st.base.curvature),
                corpus=st.corpus.numpy().copy())


def job_enhanced(mesh, spec):
    """``spec``: vocab, emb, kw (constructor), load (an artifact dir, in
    place of the constructor), chunks (merges per chunk), calls (draws)."""
    from hyptokenizer_tpu_torch.parallel import sharded as Sh
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    if spec.get("load"):
        tok = EnhancedHyperbolicTokenizer.load(spec["load"], device="cpu")
    else:
        tok = EnhancedHyperbolicTokenizer(spec["vocab"], spec["emb"],
                                          device="cpu", **spec["kw"])
    st = tok.enh_state
    sampler = PlaybackSampler(spec["calls"])
    path = Sh.select_sync_path(st, tok.enh_config, mesh)
    before = (st.pair_keys.numpy().copy(), st.pair_counts.numpy().copy())
    outs = []
    for n in spec["chunks"]:
        st, _ = Sh.run_enhanced_sharded(st, tok.enh_config, n, mesh, sampler)
        outs.append(_enhanced_out(st, path))
    return dict(chunks=outs, table_before=before)


def job_merges(mesh, spec):
    """``spec``: emb, lengths, max_v, threshold, chunks."""
    from hyptokenizer_tpu_torch.parallel import sharded as Sh
    from hyptokenizer_tpu_torch.tokenizer.state import MergeConfig, init_state
    config = MergeConfig(max_vocab_size=spec["max_v"], search_block=16)
    st = init_state(spec["emb"], spec["lengths"], curvature=1.0,
                    threshold=spec["threshold"], config=config, device="cpu")
    outs = []
    for n in spec["chunks"]:
        st = Sh.run_merges_sharded(st, config, n, mesh)
        k = int(st.num_merges)
        outs.append(dict(merges=st.merges[:k].numpy().copy(),
                         emb=st.emb.numpy().copy(), step=int(st.step),
                         threshold=float(st.threshold)))
    return outs


def job_embed(mesh, spec):
    from hyptokenizer_tpu_torch.parallel import sharded as Sh
    e, losses = Sh.run_embed_train_sharded(
        torch.from_numpy(spec["emb"]), torch.from_numpy(spec["corpus"]),
        spec["vocab_size"], PlaybackSampler(spec["calls"]), mesh,
        **spec["kw"])
    return dict(emb=e.numpy(), losses=losses.numpy())


def job_layout(mesh, spec):
    from hyptokenizer_tpu_torch.parallel import mesh as M
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    tok = EnhancedHyperbolicTokenizer(spec["vocab"], spec["emb"],
                                      device="cpu", **spec["kw"])
    st = tok.enh_state
    placed = M.shard_enhanced_state(st, mesh, "v3")
    sh = M.enhanced_state_shardings(mesh, st, "v3")
    return dict(
        base={f.name: getattr(M.state_shardings(mesh), f.name)
              for f in dataclasses.fields(st.base)},
        corpus=sh.corpus, pair_keys=sh.pair_keys, q_i=sh.q_i,
        shard=placed.corpus.numpy().copy(), whole=st.corpus.numpy().copy(),
        rep=M.shard_enhanced_state(st, mesh, "replicated").corpus.shape[0],
        mesh=(mesh.rank, mesh.size, str(mesh.device), mesh.backend))


JOBS = {"enhanced": job_enhanced, "merges": job_merges, "embed": job_embed,
        "layout": job_layout}


def _rank_main(rank, n, store_path, jobs, out_dir):
    torch.set_num_threads(1)
    from hyptokenizer_tpu_torch.parallel.mesh import make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        mesh = make_mesh(device="cpu")
        results = {name: JOBS[kind](mesh, spec)
                   for name, (kind, spec) in jobs.items()}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(n, jobs, tmp_dir):
    """Every rank's results (a list by rank) of ``jobs`` ({name: (kind,
    spec)}) on a world of ``n`` CPU ranks."""
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    mp.start_processes(_rank_main, args=(n, store, jobs, tmp_dir), nprocs=n,
                       start_method="spawn")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]
