#!/usr/bin/env python3
"""Kernels K1, K2 and K3 of one checkout of the port, timed on one NVIDIA
card, so that two checkouts can be compared in turns in one call.

    python3 tools/torch_kernel_turns.py [--root DIR]

Imports ``hyptokenizer_tpu_torch`` from DIR (default: this checkout), so
its kernels are built from DIR's sources into DIR's own build directory,
and drives them through entry points that every slice of the port has
(with this checkout's ``chip_smoke.py`` helpers). Times are CUDA-event
times:

* K1: the smoke's corpus-only path (two 2048-merge chunks), then the
  smoke's check segment from the trained state, synced (µs per step, the
  mean of 5 launches), and K1's step floor from the same state
  (``chip_smoke.k1_floor_state``: threshold 0, no step merges);
* K2: one segment from the all-features constructor's synced state and
  one from that state after 6144 merges padded to 49,152 active rows
  (``chip_smoke.check_k2_depth``'s shapes);
* K3: 50,176 random points (d = 100, sigma 0.5; the mean of 3 calls) and
  the distance-only constructor's 4096 rows and the all-features
  constructor's character vocabulary (means of 20 calls), with, for each
  row's chosen partner, the largest gap to float64 of the distance and of
  the gram that distance implies (``gram_err_fp64``: cosh(sqrt(c) d)
  against the float64 gram, so it includes the fp32 acosh's rounding).

Prints the card line and one JSON object (with each kernel's ``nvcc
-Xptxas -v`` lines). Exits nonzero without a card.
"""

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def events_ms(fn, reps):
    """Mean CUDA-event time of ``reps`` calls of ``fn`` after a warm-up
    call; returns (last result, ms)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b) / reps


def k1_turn(C, lines):
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    tok, main = C.main_path(lines)
    cfg = tok.enh_config
    st0 = E.sync_corpus(E.clone_state(tok.enh_state), cfg,
                        E.TorchSampler(1, "cuda"))
    sc = E.state_scalars(st0)
    freq = cfg.curvature_freq
    budgets = (sc["num_merges"] + C.LOG_EVERY,
               sc["step"] + C.LOG_EVERY + 1024,
               (sc["curv_last"] // freq + 1) * freq)
    clones = [E.clone_state(st0) for _ in range(6)]
    sk, ms = events_ms(lambda: K12.run_segment_cuda(clones.pop(), cfg,
                                                    *budgets), 5)
    steps = E.state_scalars(sk)["step"] - sc["step"]
    floor_ms, floor_steps = C.time_k1_floor(st0, cfg)
    return dict(
        ms=ms, steps=steps,
        merges=E.state_scalars(sk)["num_merges"] - sc["num_merges"],
        us_per_step=ms * 1e3 / steps,
        floor_us_per_step=floor_ms * 1e3 / floor_steps,
        train_s=main["train_s"],
        steady_merges_per_s=main["steady_merges_per_s"],
        chunk_seconds=main["chunk_seconds"])


def k2_turn(C, lines):
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    tok, start, alls = C.main_path_all(lines)
    cfg = tok.enh_config
    out = {"train_s": alls["train_s"], "ctor_vocab": int(
        start.base.vocab_size)}
    for label, st in (("smoke_shape", start),
                      ("depth", selfcheck.pad_dense_state(
                          tok.enh_state, C.K2_DEPTH_ROWS))):
        st0 = E.sync_corpus(E.clone_state(st), cfg,
                            E.TorchSampler(1, "cuda"))
        sc = E.state_scalars(st0)
        freq = cfg.curvature_freq
        budgets = (sc["num_merges"] + C.LOG_EVERY,
                   sc["step"] + C.LOG_EVERY + 1024,
                   (sc["curv_last"] // freq + 1) * freq)
        ms, sk = C.time_segment(st0, cfg, budgets)
        steps = E.state_scalars(sk)["step"] - sc["step"]
        out[label] = dict(rows=sc["vocab_size"], ms=ms, steps=steps,
                          us_per_step=ms * 1e3 / steps)
    return out


def k3_case(emb, vocab, c, reps):
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3

    (bd, bj), ms = events_ms(lambda: K3.pairwise_min_best(emb, vocab, c),
                             reps)
    rows = torch.nonzero(torch.isfinite(bd[:vocab])).flatten()
    e64 = emb.double()
    sig = torch.ones(emb.shape[1], dtype=torch.float64, device=emb.device)
    sig[1:] = -1.0
    g64 = (e64[rows] * sig * e64[bj[rows].long()]).sum(-1)
    sc = float(c) ** 0.5
    d64 = torch.acosh(torch.clamp_min(g64, 1.0)) / sc
    d = bd[rows].double()
    return dict(rows=vocab, ms=ms,
                dist_err_fp64=float((d - d64).abs().max()),
                gram_err_fp64=float((torch.cosh(d * sc) - g64).abs().max()))


def k3_turn(ctor_vocab):
    from hyptokenizer_tpu_torch.ops import lorentz as L

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    emb = L.random_points(gen, 50_176, 100, sigma=0.5, device="cuda")
    c = torch.tensor(1.0, device="cuda")
    out = {"full": k3_case(emb, 50_176, c, 3)}
    for label, v in (("ctor_4096", 4096), ("ctor_chars", ctor_vocab)):
        small = torch.zeros_like(emb)
        small[:v] = emb[:v]
        out[label] = k3_case(small, v, c, 20)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        sys.exit(1)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    C = load_smoke()
    from hyptokenizer_tpu_torch.ops.cuda import _build
    from hyptokenizer_tpu_torch.utils import data

    if not _build.CSRC.startswith(root):
        raise RuntimeError(f"imported the port from {_build.CSRC}, not "
                           f"{root}")
    card = C.card_line()
    _build.build_all()
    ptxas = {name: [ln.strip() for ln in log["ptxas"].splitlines()
                    if "Compiling" in ln or "Used" in ln or "spill" in ln]
             for name, log in _build.BUILD_LOG.items()}
    lines = data.read_corpus_lines(C.CORPUS)
    result = {"root": os.path.relpath(root, ROOT), "ptxas": ptxas}
    result["k1"] = k1_turn(C, lines)
    result["k2"] = k2_turn(C, lines)
    result["k3"] = k3_turn(result["k2"]["ctor_vocab"])
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
