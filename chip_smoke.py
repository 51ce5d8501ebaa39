#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path once at full width: the corpus-only flagship
tokenizer of ``bench.py`` ``bench_enhanced`` (50,176 vocabulary slots,
d=100, the whole ``data/wiki_corpus.txt.bz2``) is constructed and trained
for two 2048-merge chunks through ``EnhancedHyperbolicTokenizer`` and
``optimize_merges``, then encodes corpus lines and round-trips through
``save``/``load`` in a temporary directory. Phases:

1. watchdog, card line, kernel build (nvcc, route ``.so`` + ctypes);
2. the main path, with every kernel's launch count reset just before it
   and read just after; each kernel must have launched;
3. each kernel against its plain PyTorch version on the same inputs, on
   the card, at the main path's shapes (kernel K1: one segment from a
   synced state; merge history exact, rows within ``ROW_ATOL``);
4. a ``kernels`` JSON line, the card line, and the last line
   ``{"ok": true, "device": {...}}``, printed only when every phase passed.

Exits nonzero, printing no result, without a CUDA device, without the
port's package beside this file, on any failed check, or when the
watchdog fires.
"""

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

# A hang (kernel, relaunch loop, build) ends the run with a traceback and a
# nonzero exit after this many seconds.
WATCHDOG_S = 1100
faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(HERE, "data", "wiki_corpus.txt.bz2")
TRAIN_STEPS = 4096
LOG_EVERY = 2048
ROW_ATOL = 1e-5          # fp32 rows: summation order differs (kernel note)
H100_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
H100_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores

# bench.py bench_enhanced (:114-124): the flagship corpus-only recipe.
FLAGSHIP = dict(
    max_vocab_size=50_176, merge_threshold=100.0,
    alpha=0.05, beta=0.9, gamma=0.05,
    use_hierarchical=False, use_compression_aware=False,
    use_adaptive_curvature=True, optimize_curvature_freq=1000,
    use_dense_channel=False, min_pair_freq=1, merge_batch=16,
    corpus_max_tokens=2_900_000, merge_policy="priority", seed=0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main_path(lines, device="cuda"):
    """Construct the flagship tokenizer and train two chunks. Returns the
    tokenizer and the phase's numbers."""
    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K1
    from hyptokenizer_tpu_torch.tokenizer import (
        WORDS_WITH_SPACE, EnhancedHyperbolicTokenizer, NormalizerConfig)

    dev = torch.device(device)
    chars = sorted({ch for ln in lines for ch in ln})
    vocab = ["<pad>", "<bos>", "<eos>", "<unk>"] + chars
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    emb = L.random_points(gen, len(vocab), 100, sigma=0.5, device=dev)

    t0 = time.perf_counter()
    tok = EnhancedHyperbolicTokenizer(
        vocab, emb, device=dev, corpus_sample=lines,
        normalizer=NormalizerConfig(pre_split=WORDS_WITH_SPACE), **FLAGSHIP)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0

    K1.reset_launches()
    t0 = time.perf_counter()
    tok.optimize_merges(steps=TRAIN_STEPS, log_every=LOG_EVERY)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"enhanced_loop": K1.launches}

    merges = len(tok.merge_history)
    if merges < TRAIN_STEPS or merges != int(tok.state.num_merges):
        fail(f"trained {merges} merges (device {int(tok.state.num_merges)}),"
             f" expected {TRAIN_STEPS}")
    return tok, dict(ctor_s=ctor_s, train_s=train_s, merges=merges,
                     merges_per_s=merges / train_s,
                     # chunks after the first (which carries first-use
                     # setup), each chunk's own merges over its seconds
                     steady_merges_per_s=sum(
                         s["chunk_merges"] for s in tok.training_stats[1:])
                     / sum(s["chunk_seconds"]
                           for s in tok.training_stats[1:]),
                     launches=launches,
                     chunk_syncs=[s["chunk_syncs"]
                                  for s in tok.training_stats],
                     chunk_seconds=[round(s["chunk_seconds"], 4)
                                    for s in tok.training_stats])


def check_trained(tok, lines, device="cuda") -> None:
    """What came out is right: finite rows of the expected shape, token
    features equal to the host's recomputation from the vocabulary strings,
    lossless encode, and identical encodes after save/load."""
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    from hyptokenizer_tpu_torch.tokenizer.enhanced import _token_features

    st = tok.enh_state
    v = len(tok.vocab)
    if int(st.base.vocab_size) != v:
        fail(f"device vocab {int(st.base.vocab_size)} != host vocab {v}")
    emb = st.base.emb[:v]
    if emb.shape != (v, 101) or not bool(torch.isfinite(emb).all()):
        fail("embedding rows are not finite of shape (V, 101)")
    t_hash, b_len, vflag = _token_features(tok.vocab)
    lengths = [len(t) for t in tok.vocab]
    if st.base.lengths[:v].tolist() != lengths:
        fail("token lengths disagree with the vocabulary strings")
    if st.token_hash[:v].cpu().numpy().tolist() != t_hash.tolist():
        fail("token hashes disagree with the vocabulary strings")
    if st.byte_lengths[:v].tolist() != b_len.tolist() or \
            st.has_vowel[:v].tolist() != vflag.tolist():
        fail("byte lengths or vowel flags disagree with the vocabulary")

    sample = lines[:16]
    ids = tok.encode_batch(sample)
    for text, seq in zip(sample, ids):
        if tok.decode(seq) != text:
            fail(f"encode/decode is not lossless on {text[:40]!r}")
    with tempfile.TemporaryDirectory() as d:
        tok.save(d)
        back = EnhancedHyperbolicTokenizer.load(d, device=device)
    if back.encode_batch(sample) != ids:
        fail("encode streams differ after save/load")
    if back.vocab != tok.vocab:
        fail("vocabulary differs after save/load")


def check_k1(tok):
    """Kernel K1 against its plain version from one synced state."""
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K1
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    cfg = tok.enh_config
    st = E.clone_state(tok.enh_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st0 = E.sync_corpus(st, cfg, E.TorchSampler(1, "cuda"))
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    sc = E.state_scalars(st0)
    freq = cfg.curvature_freq
    budgets = (sc["num_merges"] + LOG_EVERY,
               sc["step"] + LOG_EVERY + 1024,
               (sc["curv_last"] // freq + 1) * freq)

    def run_kernel():
        return K1.run_segment_cuda(E.clone_state(st0), cfg, *budgets)

    def run_plain():
        return K1.run_segment_plain(E.clone_state(st0), cfg, *budgets,
                                    sampler=None)

    sk = run_kernel()
    sp = run_plain()
    torch.cuda.synchronize()
    a, b = E.state_scalars(sk), E.state_scalars(sp)
    if a != b:
        fail(f"K1 scalars {a} != plain {b}")
    nm, v, v0 = a["num_merges"], a["vocab_size"], sc["vocab_size"]
    n = nm - sc["num_merges"]
    if n <= 0:
        fail("the K1 check segment merged nothing")
    exact = {
        "merges": (sk.base.merges, sp.base.merges),
        "lengths": (sk.base.lengths, sp.base.lengths),
        "token_hash": (sk.token_hash, sp.token_hash),
        "byte_lengths": (sk.byte_lengths, sp.byte_lengths),
        "has_vowel": (sk.has_vowel, sp.has_vowel),
        "q_score": (sk.q_score, sp.q_score),
        "threshold": (sk.base.threshold, sp.base.threshold),
        "phase": (sk.phase, sp.phase),
    }
    for name, (x, y) in exact.items():
        if not torch.equal(x, y):
            fail(f"K1 {name} differs from the plain version")
    err = float((sk.base.emb[v0:v] - sp.base.emb[v0:v]).abs().max())
    merge_err = float((sk.base.merge_dists[:nm]
                       - sp.base.merge_dists[:nm]).abs().max())
    if not err <= ROW_ATOL or merge_err != 0.0:
        fail(f"K1 rows differ by {err} (limit {ROW_ATOL}), merge distances "
             f"by {merge_err}")

    # Times: kernel over fresh clones (clone outside the timed region).
    reps = 5
    clones = [E.clone_state(st0) for _ in range(reps)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for c in clones:
        K1.run_segment_cuda(c, cfg, *budgets)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    run_plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    d1 = st0.base.emb.shape[1]
    nbytes = K1.segment_bytes(st0, cfg, n)
    steps = a["step"] - sc["step"]
    # Per step: a compare per queue entry of the phase (scan) and, per
    # merge, a compare per entry of the three queues (consumption); per
    # merge ~12 flops per coordinate (dot, midpoint, projection).
    ops = steps * cfg.queue_size * 2 + n * (3 * cfg.queue_size + 12 * d1)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return dict(
        name="enhanced_loop", route="cuda",
        source="hyptokenizer_tpu_torch/ops/cuda/csrc/enhanced_loop.cu",
        replaces="hyptokenizer_tpu/ops/pallas/enhanced_loop.py:156",
        checked=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, segment_merges=n, segment_steps=steps,
        segment_bytes=nbytes, sync_ms=sync_ms)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    try:
        from hyptokenizer_tpu_torch.ops.cuda import _build
        from hyptokenizer_tpu_torch.utils import data
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    if not os.path.exists(CORPUS):
        fail(f"corpus {CORPUS} missing")
    t_all = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    took = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build_s {build_s:.2f} {json.dumps(took)}", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for ln in log["ptxas"].splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas {name}: {ln.strip()}", flush=True)

    lines = data.read_corpus_lines(CORPUS)
    tok, main = main_path(lines)
    for name, n in main["launches"].items():
        if n <= 0:
            fail(f"the main path never launched kernel {name}")
    per_chunk = main["launches"]["enhanced_loop"] / (TRAIN_STEPS / LOG_EVERY)
    print(f"ctor_s {main['ctor_s']:.3f} train_s {main['train_s']:.3f} "
          f"merges {main['merges']} merges_per_s {main['merges_per_s']:.1f} "
          f"steady_merges_per_s {main['steady_merges_per_s']:.1f} "
          f"launches {json.dumps(main['launches'])} "
          f"launches_per_chunk {per_chunk} syncs {main['chunk_syncs']} "
          f"chunk_seconds {main['chunk_seconds']}",
          flush=True)
    check_trained(tok, lines)
    print("main path outputs checked", flush=True)

    k1 = check_k1(tok)
    k1["launches"] = main["launches"]["enhanced_loop"]
    k1["launches_per_chunk"] = per_chunk
    print(f"K1 segment: {k1['segment_merges']} merges in "
          f"{k1['segment_steps']} steps, {k1['ms']:.3f} ms on the card, "
          f"plain {k1['plain_ms']:.1f} ms, max_abs_err {k1['max_abs_err']}; "
          f"one full-size sync {k1['sync_ms']:.1f} ms",
          flush=True)
    print(f"wall_s {time.perf_counter() - t_all:.1f}", flush=True)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
