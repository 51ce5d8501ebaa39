"""Scaling benchmark: merge throughput of the sharded loop.

Port of ``hyptokenizer_tpu/cli/bench_scaling.py``. Each process is one
rank (``parallel/``), and every rank joins every collective, so the one
size measured is the world's: the JAX CLI's multi-process branch. Run
alone it measures a world of one; with ``--multihost`` (a coordinator or
``torchrun``'s environment) every rank prints its line. ``--loop base`` is
the distance-only loop (K4 on the card), ``--loop enhanced`` the flagship's
corpus-only scored loop on the first 2,000 lines of
``data/wiki_corpus.txt.bz2`` (K1, the v3 sync when the world is > 1).

Prints per rank ``host r/n: loop=... devices=n: X steps/s ...`` (with
the merge count and the history checksum the ranks compared), then the
JAX CLI's JSON line ``{"process", "n_processes", "loop",
"steps_per_sec_by_devices"}``. ``main`` returns the results with each
size's trained state (``states``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

CORPUS_LINES = 2000
ENHANCED_SLOTS = 8192


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    from hyptokenizer_tpu_torch.cli._common import add_multihost_args

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max-vocab-size", type=int, default=50_176)
    p.add_argument("--n-init", type=int, default=4096)
    p.add_argument("--embedding-dim", type=int, default=100)
    p.add_argument("--steps", type=int, default=4096)
    p.add_argument("--warmup", type=int, default=128)
    p.add_argument("--loop", choices=("base", "enhanced"), default="base",
                   help="which training loop to scale: the distance-only "
                        "merge loop, or the flagship enhanced scored loop "
                        "(whose chunk includes the sharded corpus sync)")
    p.add_argument("--corpus-max-tokens", type=int, default=65_536,
                   help="enhanced loop: corpus slice size")
    p.add_argument("--corpus-shards", type=int, default=None,
                   help="enhanced loop: corpus alignment (default: the "
                        "world size, as the JAX CLI aligns to the mesh)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card)")
    add_multihost_args(p)
    args = p.parse_args(argv)

    from hyptokenizer_tpu_torch import _device
    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.parallel import make_mesh, run_merges_sharded
    from hyptokenizer_tpu_torch.parallel.mesh import pad_vocab_for_mesh
    from hyptokenizer_tpu_torch.parallel.sharded import history_checksum
    from hyptokenizer_tpu_torch.tokenizer.state import MergeConfig, init_state

    dev = _device.resolve(args.device)
    if args.multihost:
        from hyptokenizer_tpu_torch.parallel.multihost import \
            initialize_multihost
        initialize_multihost(coordinator_address=args.coordinator_address,
                             num_processes=args.num_processes,
                             process_id=args.process_id,
                             backend=args.dist_backend, device=dev)
    mesh = make_mesh(device=dev, backend=args.dist_backend)
    dev = mesh.device
    host = f"host {mesh.rank}/{mesh.size}"
    print(f"{host}: 1 local / {mesh.size} global devices", flush=True)
    sizes = [mesh.size]

    def points(n):
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        return L.random_points(g, n, args.embedding_dim, sigma=0.5,
                               device=dev)

    def bench_base(n):
        max_v = pad_vocab_for_mesh(args.max_vocab_size, n)
        config = MergeConfig(max_vocab_size=max_v, search_block=512)
        state = init_state(points(args.n_init),
                           torch.ones((args.n_init,), dtype=torch.int32),
                           curvature=1.0, threshold=5.0, config=config,
                           device=dev)
        state = run_merges_sharded(state, config, args.warmup, mesh)
        _sync(dev)
        t0 = time.perf_counter()
        state = run_merges_sharded(state, config, args.steps, mesh)
        _sync(dev)
        return args.steps / (time.perf_counter() - t0), state

    def bench_enhanced(n):
        from hyptokenizer_tpu_torch.parallel.sharded import \
            run_enhanced_sharded
        from hyptokenizer_tpu_torch.tokenizer import (
            EnhancedHyperbolicTokenizer, NormalizerConfig, WORDS_WITH_SPACE)
        from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
        from hyptokenizer_tpu_torch.utils import data

        corpus_path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "data", "wiki_corpus.txt.bz2")
        lines = data.read_corpus_lines(corpus_path)[:CORPUS_LINES]
        chars = sorted({ch for ln in lines for ch in ln})
        vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
        tok = EnhancedHyperbolicTokenizer(
            vocab, points(len(vocab)),
            max_vocab_size=pad_vocab_for_mesh(ENHANCED_SLOTS, n),
            merge_threshold=100.0, alpha=0.05, beta=0.9, gamma=0.05,
            min_pair_freq=1, merge_batch=16, use_dense_channel=False,
            corpus_sample=lines, corpus_max_tokens=args.corpus_max_tokens,
            corpus_shards=args.corpus_shards or max(n, 1),
            normalizer=NormalizerConfig(pre_split=WORDS_WITH_SPACE),
            merge_policy="priority", seed=0, device=dev)
        st = E.clone_state(tok.enh_state)
        # One warm-up chunk (the first sync, the kernel's first launch),
        # then the timed chunks.
        st, _ = run_enhanced_sharded(st, tok.enh_config, 64, mesh,
                                     tok.sampler)
        _sync(dev)
        start = int(st.base.num_merges)
        t0 = time.perf_counter()
        for _ in range(max(1, args.steps // 256)):
            st, _ = run_enhanced_sharded(st, tok.enh_config, 256, mesh,
                                         tok.sampler)
        _sync(dev)
        merges = int(st.base.num_merges) - start
        return merges / (time.perf_counter() - t0), st.base

    bench_one = bench_enhanced if args.loop == "enhanced" else bench_base
    results = {}
    states = {}
    for n in sizes:
        sps, base = bench_one(n)
        results[n] = sps
        states[n] = base
        eff = sps / (results[1] * n) if 1 in results and n > 1 else 1.0
        nm, chk = history_checksum(base).tolist()
        print(f"{host}: loop={args.loop} devices={n}: {sps:.1f} steps/s  "
              f"scaling-efficiency={eff:.2f} merges={nm} checksum={chk}",
              flush=True)
    rec = {"process": mesh.rank, "n_processes": mesh.size,
           "loop": args.loop, "steps_per_sec_by_devices": results}
    print(json.dumps(rec), flush=True)
    return dict(rec, states=states)


if __name__ == "__main__":
    main()
