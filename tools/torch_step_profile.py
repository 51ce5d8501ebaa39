#!/usr/bin/env python3
"""Where a step of the port's kernels K1, K2 and K4 spends its time, on one
NVIDIA card.

    python3 tools/torch_step_profile.py [--only k1,k2,k4] [--set NAME=VALUE ...]

Builds ``csrc/merge_loop.cu`` and ``csrc/enhanced_loop.cu`` with
``-DHYPTOK_PROFILE`` (their ``HYPTOK_MARK`` phase marks then make thread 0
of block 0 add SM cycles per phase, ``csrc/common.cuh``) into
``hyptokenizer_tpu_torch/_build/``, has the wrappers launch those builds,
and times with CUDA events:

* K1: first the corpus-only path of ``chip_smoke.py`` (two 2048-merge
  chunks) with its regular build under ``torch.profiler``, split by the
  program's spans and counters (``utils/metrics.trace_snapshot``: the
  syncs and their parts, the K1 launches and the waits for them, the
  curvature steps, the vocabulary strings, why each segment and sync
  ended); then, with the profile build, the smoke's K1 check segment (from
  the trained state, synced) and K1's step floor from the same state
  (``chip_smoke.k1_floor_state``: threshold 0, no step merges);

* K4: a 4096-step chunk from 28,922 and from 45,056 random active rows in
  50,176 slots (``evals/selfcheck.base_state``, d=100, threshold 5), and
  the step floor from the latter (threshold 0, no merge);
* K2: one segment from the all-features constructor's synced state (the
  smoke's timing shape) and one from that state after 6144 merges padded
  to 49,152 active rows (``evals/selfcheck.pad_dense_state``), as
  ``chip_smoke.py`` runs them; and the all-features training before them
  (6144 merges, 43 to about 6.2k active rows), wall time.

For each, it prints µs per step and each phase's share of block 0's
cycles, spread over that time. ``--set kRowLanes=4`` (any ``constexpr int``
of either source) builds a variant with that constant changed, to compare
layouts without editing the sources. Block 0 is the one that runs K2's serial
step; in K4 every block runs the same phases. Prints the card line and one
JSON object. Exits nonzero without a card.
"""

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

# Phase k runs from the mark before HYPTOK_MARK(k) to it.
K4_PHASES = ["barrier", "reduce partials", "midpoint",
             "block's partial reduction", "scalars, publish",
             "owner write", "fold"]
# K1's marks, those of its queue warps' thread 0 ("" where it sets none;
# the merges run on the merge warps, outside these phases). In the
# one-role kernel before the queue/merge split, phase 5 held the merges
# and the consumption.
K1_PHASES = ["step's top: halt check, wait for the step's end", "", "",
             "queue scan", "batch", "consumption", "", "", "", "",
             "scalars", "launch: staging, mirror check, pair index",
             "launch: last step's end, write-back"]
K2_PHASES = ["halt check", "wait for the grid's fold",
             "dense candidate and score", "queue scan", "batch",
             "merges, invalidation, consumption", "scalars",
             "event, fold staging", "fold passes' ends", "fold's partial",
             "after the fold", "fold: row loads", "fold: columns",
             "fold: candidate stores"]


def build_profiled(overrides):
    """The profile builds of K4's and K2's sources, with the ``constexpr
    int`` constants in ``overrides`` changed, registered as the libraries
    the wrappers load."""
    from hyptokenizer_tpu_torch.ops.cuda import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name in ("merge_loop", "enhanced_loop"):
        with open(os.path.join(_build.CSRC, name + ".cu")) as f:
            text = f.read()
        for const, value in overrides.items():
            text = re.sub(rf"(constexpr int {const} = )[^;]+;",
                          rf"\g<1>{value};", text)
        src = os.path.join(_build.BUILD_DIR, f"profile-{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        out = os.path.join(_build.BUILD_DIR, f"profile-{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), "-gencode", _build.ARCH, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-DHYPTOK_PROFILE",
             "-I", _build.CSRC, "-o", out, src]), out)
    for name, (proc, out) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name}")
        lib = ctypes.CDLL(out)
        lib.hyptok_profile_read.argtypes = [ctypes.c_void_p]
        lib.hyptok_profile_read.restype = ctypes.c_int
        _build._LIBS[name] = lib


def read_profile(name):
    """Block 0's cycles per phase since the last read (zeroes them)."""
    from hyptokenizer_tpu_torch.ops.cuda import _build

    out = (ctypes.c_ulonglong * 16)()
    torch.cuda.synchronize()
    rc = _build._LIBS[name].hyptok_profile_read(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"reading the profile failed: CUDA error {rc}")
    return list(out)


def split(phases, cycles, steps, us_per_step):
    """Each phase's share of block 0's thread-0 cycles and its SM cycles per
    step, spread over the event time per step. ``sm_mhz`` is the phases'
    cycles over the event time: below the SM clock when the event time
    holds more than the kernel (the host's part of a short launch)."""
    total = sum(c for ph, c in zip(phases, cycles) if ph) or 1
    return {"us_per_step": us_per_step, "steps": steps,
            "cycles_per_step": total / steps,
            "sm_mhz": total / (us_per_step * steps),
            "phases": {ph: {"share": c / total,
                            "cycles_per_step": c / steps,
                            "us_per_step": us_per_step * c / total}
                       for ph, c in zip(phases, cycles) if ph}}


def k1_spans(lines):
    """The corpus-only path's chunks under ``torch.profiler``, split by the
    program's own spans and counters (``utils/metrics.trace_snapshot``:
    host and event seconds per span). Returns (tokenizer, split)."""
    import chip_smoke as C
    from torch.profiler import ProfilerActivity, profile

    from hyptokenizer_tpu_torch.ops.cuda import _build
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.utils import metrics

    _build.build_all([K12.SOURCE])          # nvcc is not part of a chunk
    metrics.tracing()                       # the session's record starts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        tok, main = C.main_path(lines)
    return tok, {"ctor_s": main["ctor_s"],
                 "chunk_seconds": main["chunk_seconds"],
                 **metrics.trace_snapshot()}


def profile_k1(tok):
    """K1's phases on the smoke's check segment and at its step floor."""
    import chip_smoke as C
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    cfg = tok.enh_config
    st0 = E.sync_corpus(E.clone_state(tok.enh_state), cfg,
                        E.TorchSampler(1, "cuda"))
    sc = E.state_scalars(st0)
    freq = cfg.curvature_freq
    budgets = (sc["num_merges"] + C.LOG_EVERY,
               sc["step"] + C.LOG_EVERY + 1024,
               (sc["curv_last"] // freq + 1) * freq)
    out = {}
    for label, (st, c, b) in (("k1_check_segment", (st0, cfg, budgets)),
                              ("k1_floor", C.k1_floor_state(st0, cfg))):
        read_profile("enhanced_loop")
        ms, sk = C.time_k1_segment(st, c, b)
        cyc = [x / 2 for x in read_profile("enhanced_loop")]
        a, e = E.state_scalars(st), E.state_scalars(sk)
        steps = e["step"] - a["step"]
        out[label] = split(K1_PHASES, cyc, steps, ms * 1e3 / steps)
        out[label]["merges"] = e["num_merges"] - a["num_merges"]
        out[label]["ms"] = ms
    return out


def profile_k4():
    import chip_smoke as C
    from hyptokenizer_tpu_torch.evals import selfcheck

    out = {}
    for n0 in (28_922, 45_056):
        st, cfg = selfcheck.base_state("cuda", n0=n0, d=100, max_v=50_176,
                                       threshold=5.0)
        C.time_chunk(st, cfg, C.DIST_CHUNK)          # reads the warm-up
        read_profile("merge_loop")
        ms, sk = C.time_chunk(st, cfg, C.DIST_CHUNK)
        cyc = read_profile("merge_loop")
        # time_chunk runs a warm-up chunk and the timed one: half the cycles
        cyc = [c / 2 for c in cyc]
        steps = int(sk.step) - int(st.step)
        out[f"k4_{n0}_rows"] = split(K4_PHASES, cyc, steps,
                                     ms * 1e3 / steps)
        out[f"k4_{n0}_rows"]["merges"] = int(sk.num_merges)
    cfg0 = dataclasses.replace(cfg, adaptive_threshold=False,
                               empty_stop_after=1 << 30)
    st0 = dataclasses.replace(st, threshold=torch.zeros_like(st.threshold))
    read_profile("merge_loop")
    ms, sk = C.time_chunk(st0, cfg0, C.DIST_CHUNK)
    cyc = [c / 2 for c in read_profile("merge_loop")]
    out["k4_floor_45056_rows"] = split(K4_PHASES, cyc,
                                       C.DIST_CHUNK, ms * 1e3 / C.DIST_CHUNK)
    return out


def profile_k2():
    import chip_smoke as C
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
    from hyptokenizer_tpu_torch.utils import data

    lines = data.read_corpus_lines(C.CORPUS)
    tok, start, alls = C.main_path_all(lines)
    cfg = tok.enh_config
    out = {"k2_training": {key: alls[key] for key in (
        "train_s", "merges", "merges_per_s", "chunk_seconds")}}
    for label, st in (("k2_smoke_shape", start),
                      ("k2_49152_rows",
                       selfcheck.pad_dense_state(tok.enh_state,
                                                 C.K2_DEPTH_ROWS))):
        st0 = E.sync_corpus(E.clone_state(st), cfg,
                            E.TorchSampler(1, "cuda"))
        sc = E.state_scalars(st0)
        freq = cfg.curvature_freq
        budgets = (sc["num_merges"] + C.LOG_EVERY,
                   sc["step"] + C.LOG_EVERY + 1024,
                   (sc["curv_last"] // freq + 1) * freq)
        read_profile("enhanced_loop")
        ms, sk = C.time_segment(st0, cfg, budgets)
        cyc = [c / 2 for c in read_profile("enhanced_loop")]
        ek = E.state_scalars(sk)
        steps = ek["step"] - sc["step"]
        out[label] = split(K2_PHASES, cyc, steps,
                           ms * 1e3 / steps)
        out[label]["rows"] = sc["vocab_size"]
        out[label]["merges"] = ek["num_merges"] - sc["num_merges"]
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as C

    from hyptokenizer_tpu_torch.utils import data

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="k1,k2,k4",
                    help="comma-separated kernels to profile")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE")
    args = ap.parse_args()
    only = set(args.only.split(","))
    overrides = dict(kv.split("=", 1) for kv in args.set)
    card = C.card_line()
    result = {"overrides": overrides, "sm_clock": subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    tok = None
    if "k1" in only:
        tok, result["k1_spans"] = k1_spans(data.read_corpus_lines(C.CORPUS))
    build_profiled(overrides)
    if tok is not None:
        result.update(profile_k1(tok))
        del tok
    if "k4" in only:
        result.update(profile_k4())
    if "k2" in only:
        result.update(profile_k2())
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
