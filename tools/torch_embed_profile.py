#!/usr/bin/env python3
"""Where a step of the port's embedding trainers goes, on the card.

    python3 tools/torch_embed_profile.py [--steps 300] [--device cuda]

Two shapes of the README's Quick start (d=100): the co-occurrence
pretraining (``train_embeddings``: the corpus's character vocabulary, batch
1024, 10 negatives) and the merge-tree supervision
(``train_embeddings_pairs``: a 46,357-row table, batch 2048, 10 negatives,
one edge pair per row). For each: milliseconds per step on the host clock
(the run ends in a synchronise), then a ``torch.profiler`` window over
``--profile-steps`` steps with the device time per step, the heaviest
operations by host time and the heaviest kernels by device time. Prints
one JSON line per shape and the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(HERE, "data", "wiki_corpus.txt.bz2")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(name, run, steps, profile_steps, dev):
    run(10)                                   # first use of each operation
    _sync(dev)
    t0 = time.perf_counter()
    run(steps)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run(profile_steps)
        _sync(dev)
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type.name == "CUDA")
    top = sorted((e for e in ka if e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    top_dev = sorted((e for e in ka if e.device_type.name == "CUDA"),
                     key=lambda e: -e.self_device_time_total)[:6]
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in ka if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    copies = sum(e.count for e in ka if e.key == "cudaMemcpyAsync")
    return {"shape": name, "ms_per_step": ms,
            "device_ms_per_step": dev_us / 1e3 / profile_steps,
            "launches_per_step": launches / profile_steps,
            "syncs_per_step": syncs / profile_steps,
            "memcpy_calls_per_step": copies / profile_steps,
            "top_host_us_per_step": {
                e.key: round(e.self_cpu_time_total / profile_steps, 1)
                for e in top},
            "top_device_us_per_step": {
                e.key[:60]: round(e.self_device_time_total / profile_steps, 1)
                for e in top_dev}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--profile-steps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    from hyptokenizer_tpu_torch import _device
    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.tokenizer import embed_train as ET
    from hyptokenizer_tpu_torch.utils import data

    dev = _device.resolve(args.device)
    with data.open_text(CORPUS) as f:
        vocab = data.build_initial_vocab(f)
    with data.open_text(CORPUS) as f:
        corpus = torch.from_numpy(data.encode_corpus_chars(f, vocab, 1 << 21))
    emb = data.initialize_embeddings(len(vocab), 100, seed=42, device=dev)

    def pretrain(n):
        ET.train_embeddings(emb, corpus, len(vocab),
                            ET.GeneratorSampler(42, dev), steps=n)

    rows = 46_357
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = L.random_points(gen, rows, 100, sigma=0.5, device=dev)
    child = torch.arange(44, rows, device=dev)
    pairs = torch.stack([child, torch.clamp_max(child + 1, rows - 1)], 1)
    weights = torch.ones(pairs.shape[0], device=dev)
    pool = torch.arange(rows, device=dev)

    def supervise(n):
        ET.train_embeddings_pairs(table, pairs, weights, pool,
                                  ET.GeneratorSampler(44, dev), steps=n,
                                  batch=2048, negatives=10)

    for name, run in (("pretraining", pretrain), ("supervision", supervise)):
        print(json.dumps(measure(name, run, args.steps, args.profile_steps,
                                 dev)), flush=True)
    card = _device.card(dev)
    print(f"{card['name']}, {card['power_limit']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
