#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's three main paths once at full width (50,176 vocabulary
slots, d=100, the whole ``data/wiki_corpus.txt.bz2``), through
``EnhancedHyperbolicTokenizer`` or ``HyperbolicTokenizer``,
``optimize_merges``, ``encode`` and ``save``/``load`` in a temporary
directory:

* the corpus-only flagship of ``bench.py`` ``bench_enhanced``, two
  2048-merge chunks (kernel K1);
* the all-features configuration of ``bench.py`` ``bench_allfeatures``
  (dense channel, hierarchical curriculum, compression, adaptive curvature
  every 100 merges), 6144 merges across both phase transitions, then one
  more 512-merge chunk after ``load`` (kernels K3 in the constructors and
  K2 in training);
* the distance-only loop of ``bench.py`` ``bench_distance_only``: 4096
  length-1 tokens at sigma 0.5, threshold 5.0, adaptive, through the
  startup threshold controller, 256 steps then six 4096-step chunks, then
  one more 4096-step chunk after ``load`` (kernels K3 in the constructors
  and K4 in training).

Phases:

1. watchdog, card line, kernel build (one nvcc per source, in parallel;
   route ``.so`` + ctypes);
2. each main path, with every kernel's launch count reset just before it
   and read just after; each kernel of the path must have launched;
3. each kernel against its plain PyTorch version on the same inputs, on
   the card, at the main path's shapes: K1 on one segment from a synced
   state (merge history exact, rows within ``ROW_ATOL``), and its step
   floor (a segment in which no step merges); the replay's selection
   (``replay_select``, R1) over the flagship's 2.9M corpus slots, exactly,
   timed beside its plain versions and ``torch.cummax``; the sync's
   replay (``replay_pass``, R2) of the first trained chunk's window onto
   the flagship's 2.9M slots under both policies (corpus, passes and
   rounds exact), timed beside its plain pass loop; the sync's
   scoring (``sync_score``) on the trained flagship's pair table (masks
   exact, scores within ``evals/selfcheck.score_tolerance``), timed
   beside its plain version; the curvature Adam step (``curvature_step``,
   kernel C1) on the trained flagship state and on the all-features state
   (curvature, moments and rescaled distances within 1e-5 relative, the
   counters equal), timed beside its plain version; K2 by lockstep
   with oracle resync, step by step over 4 segments from the all-features
   state (``evals/selfcheck._lockstep_steps``: merges as the JAX protocol
   compares them, rows within ``ROW_ATOL`` plus their float32 conditioning,
   candidate grams within their float32 rounding bound); K3 at full
   activity (distances within ``DIST_ATOL``, partners equal except at ties
   within it; ``gram_err_fp64``, the gram its distance implies against
   float64) and at both constructors' active rows, where its launches
   on the paths run (the same gates, on the same inputs); K4 by lockstep
   with oracle resync, step by step over
   ``K4_LOCKSTEP_STEPS`` steps from the trained distance-only state
   (``evals/selfcheck._lockstep_base_steps``: scalars equal, merged pair
   equal or a tie within the gram's rounding bound, new row within
   ``ROW_ATOL`` plus its float32 conditioning, the fold within its gram
   bound), and by the JAX package's chunk protocol at its own size
   (``evals/selfcheck._check_base_kernel``, verdict recorded, see
   ``PERF.md``);
4. the depth phases, each kernel against its plain version by the step
   lockstep and timed with CUDA events: K4 from ``K4_DEPTH_N0`` active rows
   in 50,176 slots (a 4096-step chunk, its step floor with no step
   merging, also at the distance-only path's own timing chunk, and
   ``K4_DEPTH_LOCKSTEP`` lockstep steps); K2 from the all-features state
   padded to ``K2_DEPTH_ROWS`` active rows
   (``evals/selfcheck.pad_dense_state``; one segment timed, one held in
   lockstep);
5. the port's bench at full depth (``hyptokenizer_tpu_torch.bench``
   ``run``): the corpus-only flagship and the all-features configuration
   for their 50,000 merges, the bare distance-only loop with its trials,
   then ``evals/selfcheck.kernel_selfcheck``. Each path has every launch
   count reset just before it and read just after, and each kernel's
   launches timed with CUDA events around its wrapper (event time: the
   wrapper's host side included); the corpus-only path must end at the
   bench's stop (its target vocabulary, or two chunks that merge
   nothing), the all-features path at the 50,176-slot capacity, both
   with their outputs checked as above (features, lossless encode, the
   same ids after ``save``/``load``); every selfcheck verdict must be
   "pass". Prints the bench's first-line JSON, its diagnostics and its
   wall time;
6. the CLI phase (``cli_phase``): the port's training CLIs as a user runs
   them, at full width (d=100) on ``data/wiki_corpus.txt.bz2``
   decompressed to ``corpus.txt``. (a) The README's Quick start verbatim
   under ``hyptokenizer_tpu_torch.cli`` (50,000 slots, 46,000 steps, 3,000
   pretraining steps, words pre-split, priority policy) with
   ``--hierarchy-supervision merge-tree`` at its default 9,000 steps:
   K3 in the constructor and K2 must launch, the pretraining loss must
   fall, the saved rows be finite and on the sheet, the encode lossless and
   the saved artifacts encode the same ids; its stages (pretraining,
   training, supervision) are timed from the metrics stream. (b) The
   flagship's flags (``bench.ENHANCED``) through the CLI with
   ``--no-use-dense-channel``: K1 to the target or to candidate
   exhaustion, the same checks. (c) Exact resume: the Quick start's dense
   configuration for ``RESUME_STEPS`` merges (both phase switches, a
   curvature event every 100 merges) in one process, and in two: a half
   with a checkpoint (started beside the first), then ``--resume`` in a
   new process; merge histories identical, embeddings, curvature and
   threshold equal to the bit. (d)
   ``train_tokenizer`` (K3, K4) cut to 512 steps, as the JAX CLI runs it
   with no token-length cap, its vocabulary bytes gated. (a), (b) and (d)
   run through ``main(argv)`` with the launch counts reset just before and
   read just after, each launch timed by ``KernelTimer``; (c) runs
   ``python -m`` processes;
7. the models phase (``models_phase``), the downstream CLIs through
   ``main(argv)`` on (a)'s tokenizer (about 46,000 tokens), each load of
   it launching K3 (counts reset just before each CLI and read just
   after): (e) ``train_nlp_tasks --task both`` at its defaults (BERT
   hidden 256, 4 layers, 4 heads, length 128, batch 16, 2000 lines, one
   epoch, hyperbolic embeddings injected at the matched scale), held-out
   lines for the perplexity and classification TSVs labelled by whether a
   line holds a digit: perplexity and accuracy finite, the models on the
   card, each model's forward on the card within ``FWD_TOL`` of a CPU copy's
   on one batch; stage seconds, steps per second and peak memory; (f)
   ``train_retrieval --synthetic`` at its defaults: the loss finite and
   falling, R@1 recorded, ``best_params.pt`` loading back into the model;
   (g) ``benchmark_efficiency`` on 1000 corpus lines (tokenize and encode
   throughput on the host, the native encoder); (h)
   ``compare_tokenizers`` against a 50,000-token ``bpe`` baseline from
   ``train_baseline_tokenizers`` (alone when the ``tokenizers`` library
   does not import);
8. the parallel phase (``parallel_phase``), the sharded training of
   ``hyptokenizer_tpu_torch/parallel/``: (a) the flagship's flags of
   (b) through ``train_enhanced_tokenizer --mesh`` at a world of one under
   NCCL, full depth and width: the path must be the v3 sync, K1 must
   launch (counts reset just before, read just after) and the merge
   history must equal the unsharded CLI run's (b); (b) two ranks on the
   card under gloo (this script with ``--parallel-rank``, two processes
   meeting at a localhost coordinator): ``bench_scaling --multihost`` for
   the base loop (K3, K4) and the enhanced loop (K1) at its own 8,192
   slots and 2,000 lines, d=100, and the all-features configuration at
   8,192 slots on those lines (K3, K2 reading the v3 sync's hashed table
   at D = 2), each rank's kernels counted in its process; both ranks'
   histories must equal each other's and then one process's on the card;
   (c) K2 with ``n_buckets = 4`` (``check_k2_hashed``, run beside K2's
   depth check on its 49,152-row state: the v3 layout for 4 ranks, held to
   the plain version step by step, timed against the lexicographic table);
   (d) ``bench_scaling`` at a world of one for both loops (the references
   of (b)); (e) one int32 ``all_reduce``'s latency under NCCL at a world
   of one and under gloo at a world of two;
9. a ``computed`` JSON line (K1's shared-memory plan, K3's tile plans
   and its bound at the fp32 rate outside the tensor cores: numbers
   computed from the shapes, not measured), a ``collectives_us`` line
   (e), a ``kernels`` JSON line
   (measured, with each kernel's ``bound_ms`` and its launches and event
   time on the full-depth paths, ``full_depth``, and its launches on the
   CLI paths, ``launches_cli``, K3's on the models phase,
   ``launches_models``, and every kernel's on the parallel phase,
   ``launches_parallel``; K2's hashed lookup under ``hashed``), the card
   line, and the
   last line ``{"ok": true, "device": {...}}``, printed only when every
   phase passed.

Exits nonzero, printing no result, without a CUDA device, without the
port's package beside this file, on any failed check, or when the
watchdog fires. (``--parallel-rank R --coordinator HOST:PORT --out FILE``
runs one rank of phase 8; the phase starts them.)
"""

import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import torch

# A hang (kernel, relaunch loop, build) ends the run with a traceback and a
# nonzero exit after this many seconds.
WATCHDOG_S = 1100
faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(HERE, "data", "wiki_corpus.txt.bz2")
TRAIN_STEPS = 4096
LOG_EVERY = 2048
ALL_STEPS = 6144         # the all-features path crosses merges 1000 and 6000
ALL_AFTER_LOAD = 512
STORM_RULES = 7          # a phase-2 storm sync's window (~6.4 merges)
ROW_ATOL = 1e-5          # fp32 rows: summation order differs (kernel note)
DIST_ATOL = 1e-5         # K3: tests/test_pallas_pairwise.py's rule
LOCKSTEP_SEGMENTS = 4   # K2 held to its plain version step by step
# bench.py bench_distance_only (:230-257): the distance-only loop.
DIST_N0 = 4096
DIST_WARM = 256
DIST_CHUNK = 4096
DIST_CHUNKS = 6
K4_LOCKSTEP_STEPS = 400
# The depth phases: K4 from 45,056 active rows in 50,176 slots (a
# 4096-step chunk fits before capacity), K2 from the all-features state
# padded to 49,152 active rows.
K4_DEPTH_N0 = 45_056
K4_DEPTH_LOCKSTEP = 200
K2_DEPTH_ROWS = 49_152
# The structural length gate (MergeConfig.max_token_len) at the enhanced
# tokenizer's default. Without it the distance-only loop at these shapes
# chains merges of a token with its own midpoints, whose strings grow
# without bound (PERF.md, section 6); the bare state loop of bench.py never
# builds the strings, a tokenizer does.
DIST_MAX_TOKEN_LEN = 512
H100_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
H100_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
H100_TF32_FLOPS = 495e12     # H100 SXM TF32 tensor cores, dense
TF32_PRODUCTS = 3            # TF32 products per fp32-accurate product


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
    """Construct the flagship tokenizer (the bench's recipe,
    ``bench.ENHANCED``) and train two chunks. Returns the tokenizer and
    the phase's numbers."""
    from hyptokenizer_tpu_torch import bench
    from hyptokenizer_tpu_torch.ops.cuda import curvature_step as C1
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K1
    from hyptokenizer_tpu_torch.ops.cuda import replay_pass as RP
    from hyptokenizer_tpu_torch.ops.cuda import replay_select as RS
    from hyptokenizer_tpu_torch.ops.cuda import sync_score as S1
    from hyptokenizer_tpu_torch.tokenizer import (
        WORDS_WITH_SPACE, EnhancedHyperbolicTokenizer, NormalizerConfig)

    dev = torch.device(device)
    vocab, emb = bench.char_points(lines, dev)

    t0 = time.perf_counter()
    tok = EnhancedHyperbolicTokenizer(
        vocab, emb, device=dev, corpus_sample=lines,
        normalizer=NormalizerConfig(pre_split=WORDS_WITH_SPACE),
        **bench.ENHANCED)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0

    K1.reset_launches()
    RP.reset_launches()
    RS.reset_launches()
    S1.reset_launches()
    C1.reset_launches()
    t0 = time.perf_counter()
    tok.optimize_merges(steps=TRAIN_STEPS, log_every=LOG_EVERY)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"enhanced_loop": K1.launches, "replay_pass": RP.launches,
                "sync_score": S1.launches, "curvature_step": C1.launches}

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
                     launches=launches, replay_select_launches=RS.launches,
                     chunk_syncs=[s["chunk_syncs"]
                                  for s in tok.training_stats],
                     chunk_seconds=[round(s["chunk_seconds"], 4)
                                    for s in tok.training_stats])


def check_trained(tok, lines, device="cuda"):
    """What came out is right: finite rows of the expected shape, token
    features equal to the host's recomputation from the vocabulary strings,
    lossless encode, and identical encodes after save/load. Returns the
    loaded tokenizer."""
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
    return back


def main_path_all(lines, device="cuda"):
    """The all-features path: construct (K3), train ``ALL_STEPS`` merges
    across both phase transitions (K2), check the outputs, save/load, and
    train ``ALL_AFTER_LOAD`` more merges after load. Returns the tokenizer,
    the state the constructor built (for the K2 check) and the phase's
    numbers, among them each sync's corpus length and window
    ``[corpus_synced, num_merges)`` of the ``ALL_STEPS`` training, kept on
    the card (``syncs``, for :func:`check_replay_pass`)."""
    from hyptokenizer_tpu_torch import bench
    from hyptokenizer_tpu_torch.ops.cuda import curvature_step as C1
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3
    from hyptokenizer_tpu_torch.ops.cuda import replay_pass as RP
    from hyptokenizer_tpu_torch.ops.cuda import replay_select as RS
    from hyptokenizer_tpu_torch.ops.cuda import sync_score as S1
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    dev = torch.device(device)
    vocab, emb = bench.char_points(lines, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    K12.reset_launches()
    K3.reset_launches()
    RP.reset_launches()
    RS.reset_launches()
    S1.reset_launches()
    C1.reset_launches()
    t0 = time.perf_counter()
    tok = EnhancedHyperbolicTokenizer(
        vocab, emb, device=dev, corpus_sample=lines, **bench.ALLFEATURES)
    sync()
    ctor_s = time.perf_counter() - t0
    start = E.clone_state(tok.enh_state)

    syncs = []
    replay_corpus = E.replay_corpus

    def kept(st, config):
        # one small copy on the card a sync, read after the training
        syncs.append((st.corpus.shape[0], torch.stack(
            [st.corpus_synced, st.base.num_merges])))
        return replay_corpus(st, config)

    E.replay_corpus = kept
    try:
        t0 = time.perf_counter()
        tok.optimize_merges(steps=ALL_STEPS, log_every=LOG_EVERY,
                            target_vocab_size=50_000,
                            phase_transition_steps={2: 1000, 3: 6000})
        sync()
        train_s = time.perf_counter() - t0
    finally:
        E.replay_corpus = replay_corpus
    syncs = [(n, *w.tolist()) for n, w in syncs]
    final_corpus = tok.enh_state.corpus.clone()
    merges = len(tok.merge_history)
    if merges < ALL_STEPS or merges != int(tok.state.num_merges):
        fail(f"all-features path trained {merges} merges (device "
             f"{int(tok.state.num_merges)}), expected {ALL_STEPS}")
    if tok.current_phase != 3:
        fail(f"all-features path ended in phase {tok.current_phase}, not 3")
    curvature = float(tok.state.curvature)
    if curvature == 1.0 or curvature != curvature:
        fail(f"curvature {curvature} was not trained")

    back = check_trained(tok, lines, device)
    t0 = time.perf_counter()
    back.optimize_merges(steps=ALL_AFTER_LOAD, log_every=ALL_AFTER_LOAD)
    sync()
    after_s = time.perf_counter() - t0
    n_after = len(back.merge_history) - merges
    v = int(back.state.vocab_size)
    if n_after < ALL_AFTER_LOAD or v != len(back.vocab) or \
            not bool(torch.isfinite(back.state.emb[:v]).all()):
        fail(f"training after load made {n_after} merges (expected "
             f"{ALL_AFTER_LOAD}) or non-finite rows")
    launches = {"enhanced_loop_dense": K12.dense_launches,
                "pairwise_min_best": K3.launches, "replay_pass": RP.launches,
                "sync_score": S1.launches, "curvature_step": C1.launches}
    return tok, start, dict(
        ctor_s=ctor_s, train_s=train_s, merges=merges,
        merges_per_s=merges / train_s, phase=tok.current_phase,
        curvature=curvature, after_load_s=after_s,
        after_load_merges=n_after, launches=launches,
        replay_select_launches=RS.launches, syncs=syncs,
        final_corpus=final_corpus,
        corpus_only_launches=K12.launches,
        chunk_syncs=[s["chunk_syncs"] for s in tok.training_stats],
        chunk_seconds=[round(s["chunk_seconds"], 4)
                       for s in tok.training_stats])


def plain_segment(st, cfg, budgets):
    """The plain version of one segment (``enhanced_step`` looped to the
    kernel's halt conditions), recording per step the rows below the
    post-batch vocabulary and the merges made."""
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    per_step = []
    sc = E.state_scalars(st)
    for _ in range(K12.SEGMENT_STEPS):
        if E._halted(sc, *budgets):
            break
        st = E.enhanced_step(st, cfg, None)
        now = E.state_scalars(st)
        per_step.append((now["vocab_size"],
                         now["num_merges"] - sc["num_merges"]))
        sc = now
    return st, per_step


def check_k2(tok, start):
    """Kernel K2 against its plain version: step-by-step lockstep with
    oracle resync over ``LOCKSTEP_SEGMENTS`` segments from the all-features
    constructor's state (``evals/selfcheck._lockstep_steps``), then one
    segment of each timed from the same synced state."""
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    cfg = tok.enh_config
    out = {}
    holder = types.SimpleNamespace(enh_state=start, enh_config=cfg)
    selfcheck._lockstep_steps(holder, LOCKSTEP_SEGMENTS, out, "k2",
                              row_atol=ROW_ATOL)
    if out["k2"] != "pass":
        fail(f"K2 lockstep against its plain version: {out['k2']}")

    st0 = E.sync_corpus(E.clone_state(start), cfg, E.TorchSampler(1, "cuda"))
    sc = E.state_scalars(st0)
    freq = cfg.curvature_freq
    budgets = (sc["num_merges"] + LOG_EVERY,
               sc["step"] + LOG_EVERY + 1024,
               (sc["curv_last"] // freq + 1) * freq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, per_step = plain_segment(E.clone_state(st0), cfg, budgets)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n = sum(m for _, m in per_step)
    if n <= 0:
        fail("the K2 timing segment merged nothing")

    reps = 5
    clones = [E.clone_state(st0) for _ in range(reps + 1)]
    K12.run_segment_cuda(clones.pop(), cfg, *budgets)      # warm-up
    torch.cuda.synchronize()
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record()
    for c in clones:
        K12.run_segment_cuda(c, cfg, *budgets)
    end_ev.record()
    torch.cuda.synchronize()
    ms = start_ev.elapsed_time(end_ev) / reps

    d1 = st0.base.emb.shape[1]
    v0 = sc["vocab_size"]
    steps = len(per_step)
    nbytes = K12.segment_bytes(st0, cfg, n, dense_rows=v0)
    fold_rows = sum(v for v, _ in per_step)
    ops = K12.segment_ops(cfg, d1, n, steps, dense_rows=v0)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return dict(
        name="enhanced_loop_dense", route="cuda",
        source="hyptokenizer_tpu_torch/ops/cuda/csrc/enhanced_loop.cu",
        replaces="hyptokenizer_tpu/ops/pallas/enhanced_loop.py:156",
        checked=True, max_abs_err=out["k2_row_err"], ms=ms,
        plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, segment_merges=n, segment_steps=steps,
        us_per_step=ms * 1e3 / steps, segment_rows=v0,
        segment_bytes=nbytes, segment_ops=ops,
        bytes_rereading=K12.segment_bytes_rereading(st0, cfg, n, fold_rows),
        grid=K12.dense_grid_size(st0.base.emb.device, cfg),
        lockstep=out["k2"],
        lockstep_merges=out["k2_merges"], lockstep_steps=out["k2_steps"],
        reorders=out["k2_reorders"], dist_ties=out["k2_dist_ties"],
        partner_ties=out["k2_partner_ties"],
        row_err_over_tol=out["k2_row_err_over_tol"],
        gram_gap_over_bound=out["k2_gram_gap_over_bound"])


def time_segment(st0, cfg, budgets):
    """One K2 segment from ``st0`` timed with CUDA events, after a warm-up
    segment on a clone. Returns (ms, the kernel's end state)."""
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    warm, run = E.clone_state(st0), E.clone_state(st0)
    K12.run_segment_cuda(warm, cfg, *budgets)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    sk = K12.run_segment_cuda(run, cfg, *budgets)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), sk


def check_k2_depth(tok):
    """Kernel K2 at a deep vocabulary: the all-features state after the
    smoke's chunks, its active prefix padded to ``K2_DEPTH_ROWS`` rows
    (``evals/selfcheck.pad_dense_state``); one segment timed, and one
    segment held to the plain version step by step."""
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    cfg = tok.enh_config
    deep = selfcheck.pad_dense_state(tok.enh_state, K2_DEPTH_ROWS)
    st0 = E.sync_corpus(E.clone_state(deep), cfg, E.TorchSampler(1, "cuda"))
    sc = E.state_scalars(st0)
    freq = cfg.curvature_freq
    budgets = (sc["num_merges"] + LOG_EVERY,
               sc["step"] + LOG_EVERY + 1024,
               (sc["curv_last"] // freq + 1) * freq)
    ms, sk = time_segment(st0, cfg, budgets)
    ek = E.state_scalars(sk)
    n = ek["num_merges"] - sc["num_merges"]
    steps = ek["step"] - sc["step"]
    if n <= 0 or steps <= 0:
        fail(f"the deep K2 segment ran {steps} steps and {n} merges")
    v0 = sc["vocab_size"]
    d1 = st0.base.emb.shape[1]
    out = {}
    holder = types.SimpleNamespace(enh_state=deep, enh_config=cfg)
    selfcheck._lockstep_steps(holder, 1, out, "k2d", row_atol=ROW_ATOL)
    if out["k2d"] != "pass":
        fail(f"K2 lockstep at {v0} rows against its plain version: "
             f"{out['k2d']}")
    nbytes = K12.segment_bytes(st0, cfg, n, dense_rows=v0)
    ops = K12.segment_ops(cfg, d1, n, steps, dense_rows=v0)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return dict(
        rows=v0, ms=ms, segment_merges=n, segment_steps=steps,
        us_per_step=ms * 1e3 / steps, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        segment_bytes=nbytes, segment_ops=ops,
        rows_end=v0 + n,
        lockstep=out["k2d"], lockstep_merges=out["k2d_merges"],
        lockstep_steps=out["k2d_steps"], reorders=out["k2d_reorders"],
        dist_ties=out["k2d_dist_ties"],
        partner_ties=out["k2d_partner_ties"],
        max_abs_err=out["k2d_row_err"],
        row_err_over_tol=out["k2d_row_err_over_tol"],
        gram_gap_over_bound=out["k2d_gram_gap_over_bound"])


K2_HASHED_D = 4   # (c) of the parallel phase: the v3 layout for 4 ranks


def check_k2_hashed(tok):
    """Kernel K2 reading a hash-partitioned pair table (n_buckets =
    ``K2_HASHED_D``, the layout the v3 sharded sync leaves for that many
    ranks, ``parallel.sharded.hash_partition_table``) on the depth state of
    ``check_k2_depth``: held to its plain version step by step over one
    segment, and one segment timed against the same segment on the
    lexicographic table (lex, hashed, hashed, lex)."""
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.parallel.sharded import hash_partition_table
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    cfg = tok.enh_config
    cfg_h = dataclasses.replace(cfg, pair_table_hashed=K2_HASHED_D)

    def hashed(st):
        keys, counts = hash_partition_table(st.pair_keys, st.pair_counts,
                                            K2_HASHED_D)
        return dataclasses.replace(st, pair_keys=keys, pair_counts=counts)

    deep = selfcheck.pad_dense_state(tok.enh_state, K2_DEPTH_ROWS)
    st0 = E.sync_corpus(E.clone_state(deep), cfg, E.TorchSampler(1, "cuda"))
    st0h = hashed(E.clone_state(st0))
    dropped = int((st0.pair_counts > 0).sum()) - \
        int((st0h.pair_counts > 0).sum())
    sc = E.state_scalars(st0)
    freq = cfg.curvature_freq
    budgets = (sc["num_merges"] + LOG_EVERY,
               sc["step"] + LOG_EVERY + 1024,
               (sc["curv_last"] // freq + 1) * freq)
    lex_ms, hashed_ms = [], []
    for which in ("lex", "hashed", "hashed", "lex"):
        if which == "lex":
            ms, sk_lex = time_segment(st0, cfg, budgets)
            lex_ms.append(ms)
        else:
            ms, sk = time_segment(st0h, cfg_h, budgets)
            hashed_ms.append(ms)
    ek = E.state_scalars(sk)
    n = ek["num_merges"] - sc["num_merges"]
    steps = ek["step"] - sc["step"]
    if n <= 0 or steps <= 0:
        fail(f"the hashed K2 segment ran {steps} steps and {n} merges")
    same = torch.equal(sk.base.merges, sk_lex.base.merges)
    if dropped == 0 and not same:
        fail("K2 on the hashed table merged otherwise than on the "
             "lexicographic table holding the same pairs")
    out = {}
    holder = types.SimpleNamespace(enh_state=deep, enh_config=cfg_h)
    selfcheck._lockstep_steps(
        holder, 1, out, "k2h", row_atol=ROW_ATOL,
        sync=lambda st, c, s: hashed(E.sync_corpus(st, c, s)))
    if out["k2h"] != "pass":
        fail(f"K2 with n_buckets={K2_HASHED_D} against its plain version: "
             f"{out['k2h']}")
    ms, lms = sum(hashed_ms) / 2, sum(lex_ms) / 2
    return dict(
        n_buckets=K2_HASHED_D, rows=sc["vocab_size"], segment_merges=n,
        segment_steps=steps, ms=ms, us_per_step=ms * 1e3 / steps,
        lex_ms=lms, lex_us_per_step=lms * 1e3 / steps,
        same_merges_as_lex=same, pairs_dropped=dropped,
        lockstep=out["k2h"], lockstep_merges=out["k2h_merges"],
        lockstep_steps=out["k2h_steps"], reorders=out["k2h_reorders"],
        max_abs_err=out["k2h_row_err"],
        row_err_over_tol=out["k2h_row_err_over_tol"])


def gate_k3(emb, vocab, c, bd, bj):
    """K3's gates against its plain version on the same inputs: the same
    rows without a candidate, distances within ``DIST_ATOL``, partners
    equal except at ties within ``DIST_ATOL`` in a float64 distance.
    Returns (max_abs_err, tied rows, the plain version's ms)."""
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bd0, bj0 = K3.pairwise_min_best_plain(emb, vocab, c)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    fin = torch.isfinite(bd0)
    if not torch.equal(torch.isfinite(bd), fin):
        fail(f"K3 at {vocab} rows leaves other rows without a candidate "
             f"than its plain version")
    err = float((bd[fin] - bd0[fin]).abs().max()) if fin.any() else 0.0
    if not err <= DIST_ATOL:
        fail(f"K3 distances at {vocab} rows differ by {err} (limit "
             f"{DIST_ATOL})")
    rows = torch.nonzero(bj != bj0).flatten()
    e64 = emb.double()
    sig = torch.ones(emb.shape[1], dtype=torch.float64, device=emb.device)
    sig[1:] = -1.0

    def dist(i, j):
        g = torch.clamp_min((e64[i] * sig * e64[j]).sum(-1), 1.0)
        return torch.acosh(g)

    gap = (dist(rows, bj[rows].long()) - dist(rows, bj0[rows].long())).abs()
    if rows.numel() and not float(gap.max()) <= DIST_ATOL:
        fail(f"K3 partners at {vocab} rows differ from the plain version "
             f"beyond a tie on {int((gap > DIST_ATOL).sum())} rows")
    return err, int(rows.numel()), plain_ms


def check_k3(ctor_vocab: int):
    """Kernel K3 against its plain version at full activity (50,176 random
    points, d=100, c=1) and at the constructors' active prefixes, where
    its launches on the paths run: the all-features character vocabulary
    (``ctor_vocab``) and the distance-only path's ``DIST_N0`` rows. Returns
    its ``kernels`` entry and what this run computed of its plan."""
    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3

    max_v, d = 50_176, 100
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    emb = L.random_points(gen, max_v, d, sigma=0.5, device="cuda")
    c = torch.tensor(1.0, device="cuda")

    def timed(fn, reps):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b) / reps

    (bd, bj), ms = timed(lambda: K3.pairwise_min_best(emb, max_v, c), 3)
    err, ties, plain_ms = gate_k3(emb, max_v, c, bd, bj)
    # The gram the kernel's distance implies at its chosen partner, against
    # float64 (includes the fp32 acosh's rounding).
    e64 = emb.double()
    sig = torch.ones(d + 1, dtype=torch.float64, device="cuda")
    sig[1:] = -1.0
    fin_rows = torch.nonzero(torch.isfinite(bd)).flatten()
    g64 = (e64[fin_rows] * sig * e64[bj[fin_rows].long()]).sum(-1)
    gram_err = float((torch.cosh(bd[fin_rows].double()) - g64).abs().max())

    ctor = {}
    for v in (ctor_vocab, DIST_N0):
        small = torch.zeros_like(emb)
        small[:v] = emb[:v]
        (sd, sj), v_ms = timed(lambda: K3.pairwise_min_best(small, v, c), 20)
        v_err, v_ties, _ = gate_k3(small, v, c, sd, sj)
        ctor[v] = dict(ms=v_ms, max_abs_err=v_err, ties=v_ties)

    # The same work whatever computes it: fp32-accurate products at the
    # card's fastest fp32-accurate rate (three TF32 products each), and,
    # beside it, at the fp32 rate outside the tensor cores.
    flops = K3.pairwise_flops(max_v, d + 1)
    nbytes = max_v * (d + 1) * 4 + max_v * 8
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops * TF32_PRODUCTS / H100_TF32_FLOPS * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {f"rows_{v}": K3.tile_plan(v, d + 1, sms)
             for v in (max_v, ctor_vocab, DIST_N0)}
    computed = dict(
        bound_fp32_cuda_ms=flops / H100_FP32_FLOPS * 1e3,
        tile_plan={k: dict(tensor_cores=p.tensor_cores, depth=p.depth,
                           items=len(p.items), chunk=p.chunk)
                   for k, p in plans.items()})
    entry = dict(
        name="pairwise_min_best", route="cuda",
        source="hyptokenizer_tpu_torch/ops/cuda/csrc/pairwise.cu",
        replaces="hyptokenizer_tpu/ops/pallas/pairwise.py:44",
        checked=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, rows=max_v, ties=ties, gram_err_fp64=gram_err,
        ctor_rows=ctor_vocab, ctor_ms=ctor[ctor_vocab]["ms"],
        ctor_max_abs_err=ctor[ctor_vocab]["max_abs_err"],
        ctor_ties=ctor[ctor_vocab]["ties"],
        dist_ctor_rows=DIST_N0, dist_ctor_ms=ctor[DIST_N0]["ms"],
        dist_ctor_max_abs_err=ctor[DIST_N0]["max_abs_err"],
        dist_ctor_ties=ctor[DIST_N0]["ties"])
    return entry, computed


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
        return E.run_segment_plain(E.clone_state(st0), cfg, *budgets, None,
                                   K1.SEGMENT_STEPS)

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

    floor_ms, floor_steps = time_k1_floor(st0, cfg)
    d1 = st0.base.emb.shape[1]
    nbytes = K1.segment_bytes(st0, cfg, n)
    steps = a["step"] - sc["step"]
    ops = K1.segment_ops(cfg, d1, n, steps)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return dict(
        floor_us_per_step=floor_ms * 1e3 / floor_steps,
        name="enhanced_loop", route="cuda",
        source="hyptokenizer_tpu_torch/ops/cuda/csrc/enhanced_loop.cu",
        replaces="hyptokenizer_tpu/ops/pallas/enhanced_loop.py:156",
        checked=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, segment_merges=n, segment_steps=steps,
        us_per_step=ms * 1e3 / steps, segment_bytes=nbytes, sync_ms=sync_ms)


def event_ms(fn, reps: int = 20) -> float:
    """Milliseconds a call of ``fn`` on the card: CUDA events around
    ``reps`` calls after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_replay_select(tok, lines):
    """The replay's selection kernel against its plain versions on the
    card, over all the flagship's corpus slots: the matches of the first
    ``LOG_EVERY`` trained merges on the constructor's corpus, as a mask
    (the take) and as priorities (one matching round, then the matching to
    its end), exactly. Then timed with CUDA events, inputs warm in L2 as
    the replay leaves them: the kernel, the plain versions and
    ``torch.cummax`` alone (the library call in the plain take), against
    the bound by bytes."""
    from hyptokenizer_tpu_torch.ops.cuda import replay_select as RS
    from hyptokenizer_tpu_torch.tokenizer import scoring as SC

    cfg = tok.enh_config
    base = tok.enh_state.base
    corpus = tok._encode_initial_corpus(lines,
                                        tok.enh_state.corpus.shape[0])
    window = min(LOG_EVERY, int(base.num_merges))
    hi, lo, valid = SC._adjacent_pair_keys(corpus)
    mid = SC._match_rules(hi, lo, valid, base.merges, 0, window, cfg.n_init)
    m = mid >= 0
    n = m.shape[0]
    if not torch.equal(RS.parity_take(m), SC.parity_take_plain(m)):
        fail("replay_select's take differs from the plain version")
    sel_k, sel_p = torch.zeros_like(m), torch.zeros_like(m)
    alive_k, flag = RS.matching_round(m, mid, sel_k)
    alive_p, live_p = SC.matching_round_plain(m, mid, sel_p)
    if not (torch.equal(alive_k, alive_p) and torch.equal(sel_k, sel_p)
            and int(flag) == int(live_p)):
        fail("replay_select's matching round differs from the plain version")
    alive, sel_k, rounds = m, torch.zeros_like(m), 0
    while bool(alive.any()):
        rounds += 1
        alive, _ = RS.matching_round(alive, mid, sel_k)
    alive, sel_p, plain_rounds = m, torch.zeros_like(m), 0
    while bool(alive.any()):
        plain_rounds += 1
        alive, _ = SC.matching_round_plain(alive, mid, sel_p)
    if not torch.equal(sel_k, sel_p) or rounds != plain_rounds:
        fail(f"replay_select's matching ({rounds} rounds) differs from the "
             f"plain version's ({plain_rounds})")

    sel = torch.zeros_like(m)
    idx = torch.arange(n, device=m.device, dtype=torch.int32)
    heads = torch.where(m & ~SC._shift_right(m, False), idx,
                        torch.full_like(idx, -1))
    take_ms = event_ms(lambda: RS.parity_take(m))
    round_ms = event_ms(lambda: RS.matching_round(m, mid, sel))
    plain_take_ms = event_ms(lambda: SC.parity_take_plain(m), reps=5)
    plain_ms = event_ms(lambda: SC.matching_round_plain(m, mid, sel), reps=5)
    library_ms = event_ms(lambda: torch.cummax(heads, dim=0), reps=5)
    # Each entry read once and written once: the mask and the take (2
    # bytes); alive, pri and sel read, sel and the new alive written (8).
    return dict(
        name="replay_select", route="cuda",
        source="hyptokenizer_tpu_torch/ops/cuda/csrc/replay_select.cu",
        replaces="hyptokenizer_tpu/tokenizer/scoring.py:141 blocked_cummax "
                 "(an XLA scan, no pallas_call)",
        checked=True, max_abs_err=0, slots=n, matches=int(m.sum()),
        rounds=rounds, ms=round_ms, take_ms=take_ms, plain_ms=plain_ms,
        plain_take_ms=plain_take_ms, library_ms=library_ms,
        bound_ms=8 * n / H100_BYTES_PER_S * 1e3,
        bound_take_ms=2 * n / H100_BYTES_PER_S * 1e3, bound_by="bytes")


def _replay_pair(corpus, merges, start, end, n_init):
    """R2 against the plain pass loop on card tensors, merges ``[start,
    end)`` replayed onto ``corpus`` under both policies, exactly: corpus,
    passes and matching rounds. Then each timed with CUDA events, the
    kernel with its wrapper's host side against the plain loop, and the
    bound by bytes: the corpus read once and written once (8 bytes a slot)
    when the blocks hold their slices in shared memory, and that for
    every pass when they hold them in global memory."""
    from hyptokenizer_tpu_torch.ops.cuda import replay_pass as RP
    from hyptokenizer_tpu_torch.tokenizer import scoring as SC
    from hyptokenizer_tpu_torch.utils import metrics

    n = corpus.shape[0]
    plan = RP._plan(RP._launcher(), corpus.device, n)
    count = end - start
    res = dict(slots=n, start=start, window=count,
               state="shared" if plan.shared else "global",
               table=("block" if RP.table_capacity(count) <= RP.LOCAL_TABLE
                      else "grid"))
    for policy, select in (("rank", SC._select_matching),
                           ("fixpoint", SC._select_leftmost)):
        rank = policy == "rank"
        got, stats = RP.replay(corpus, merges, start, end, n_init, rank=rank)
        passes, rounds = stats.tolist()
        metrics.tracing()
        with torch.profiler.profile():
            want = SC._replay(corpus, merges, start, count, n_init, select)
            counters = metrics.trace_snapshot()["counters"]
        plain = (counters["replay.passes"], counters["replay.match_rounds"])
        if not torch.equal(got, want) or (passes, rounds) != plain:
            fail(f"replay_pass ({policy}, window [{start}, {end}) on {n} "
                 f"slots: {passes} passes, {rounds} rounds) differs from "
                 f"the plain loop's ({plain})")
        res[policy] = dict(
            passes=passes, rounds=rounds,
            ms=event_ms(lambda: RP.replay(corpus, merges, start, end,
                                          n_init, rank=rank)),
            plain_ms=event_ms(lambda: SC._replay(corpus, merges, start,
                                                 count, n_init, select),
                              reps=3),
            bound_ms=(1 if plan.shared else passes) * 8 * n
            / H100_BYTES_PER_S * 1e3)
    return res


def check_replay_pass(tok, lines):
    """The sync's replay kernel R2 against its plain pass loop on the
    card (:func:`_replay_pair`) over all the flagship's corpus slots: the
    first ``LOG_EVERY`` trained merges replayed onto the constructor's
    corpus, the window of a first sync after them (a rule table the grid
    builds in global memory)."""
    cfg = tok.enh_config
    base = tok.enh_state.base
    corpus = tok._encode_initial_corpus(lines,
                                        tok.enh_state.corpus.shape[0])
    window = min(LOG_EVERY, int(base.num_merges))
    res = dict(name="replay_pass", route="cuda",
               source="hyptokenizer_tpu_torch/ops/cuda/csrc/replay_pass.cu",
               replaces="hyptokenizer_tpu/tokenizer/scoring.py:502, :569 "
                        "the replays' XLA ops (no pallas_call)",
               checked=True, max_abs_err=0, bound_by="bytes")
    res.update(_replay_pair(corpus, base.merges, 0, window, cfg.n_init))
    res.update(ms=res["rank"]["ms"], plain_ms=res["rank"]["plain_ms"],
               bound_ms=res["rank"]["bound_ms"], library_ms=None)
    return res


def check_replay_pass_all(tok, start, alls):
    """R2 on a storm-sized window of the all-features training: its syncs
    are replayed in order from the constructor's corpus by R2 under the
    path's own policy (each at the length the sync was handed), the
    outcome checked against the trained corpus, and the first
    ``STORM_RULES`` merges of its first phase-2 sync, replayed onto the
    corpus as that sync was handed it (what a storm sync there would
    replay: a rule table each block builds in shared memory), held to the
    plain loop by :func:`_replay_pair`."""
    from hyptokenizer_tpu_torch.ops.cuda import replay_pass as RP
    from hyptokenizer_tpu_torch.tokenizer import scoring as SC

    cfg = tok.enh_config
    merges = tok.enh_state.base.merges
    syncs = alls["syncs"]
    pick = next((i for i, (_, s, e) in enumerate(syncs)
                 if s >= cfg.phase2_step and e - s >= STORM_RULES), None)
    if pick is None:
        fail(f"the all-features training has no phase-2 sync of "
             f"{STORM_RULES} rules or more: {syncs[:40]}")
    c = start.corpus
    at = None
    for i, (n, s, e) in enumerate(syncs):
        c = c[:n]
        if i == pick:
            at = c
        c, _ = RP.replay(c, merges, s, e, cfg.n_init,
                         rank=cfg.priority_replay)
    final = alls["final_corpus"]
    m = final.shape[0]
    if m > c.shape[0] or not torch.equal(c[:m], final) or \
            bool((c[m:] != SC.PAD_ID).any()):
        fail("the all-features syncs replayed in order do not give the "
             "trained corpus")
    first = syncs[pick][1]
    res = _replay_pair(at, merges, first, first + STORM_RULES, cfg.n_init)
    res.update(sync=pick, syncs=len(syncs),
               policy="rank" if cfg.priority_replay else "fixpoint")
    return res


def print_replay_pass(what, rec):
    print(f"replay_pass on {what}: {rec['slots']} slots, merges "
          f"[{rec['start']}, {rec['start'] + rec['window']}), slices in "
          f"{rec['state']} memory, rule table by the {rec['table']}: "
          + "; ".join(f"{p}: {rec[p]['passes']} passes, {rec[p]['rounds']} "
                      f"rounds, {rec[p]['ms']:.4f} ms on the card, bound "
                      f"{rec[p]['bound_ms']:.4f} ms (bytes), plain loop "
                      f"{rec[p]['plain_ms']:.3f} ms"
                      for p in ("rank", "fixpoint")), flush=True)


def check_sync_score(tok):
    """The sync's scoring kernel S1 against its plain version on the
    trained flagship's last pair table (its rows, samples and curvature):
    candidate masks exact, distances and scores within
    ``evals/selfcheck.score_tolerance``, the queue's top ``queue_size``
    within ``compare_queues``. Then timed with CUDA events (the wrapper's
    host side included) and by the profiler's kernel time, beside the
    plain version and the bound: the gram's multiply-adds of the valid rows
    at the fp32 rate, or each input byte read once (the table, the
    embedding rows it names, the samples) and each output written once."""
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
    from hyptokenizer_tpu_torch.tokenizer import scoring as SC

    cfg = tok.enh_config
    inputs = selfcheck.state_score_inputs(tok.enh_state)
    got = E.score_candidates(cfg, **inputs)
    want = E.score_candidates_plain(cfg, **inputs)
    tol = selfcheck.score_tolerance(cfg, inputs)
    cmp = selfcheck.compare_scores(got, want, tol, inputs["curvature"])
    if not cmp["masks_equal"] or cmp["score_gap_over_tol"] > 1.0 or \
            cmp["dist_gap_over_tol"] > 1.0:
        fail(f"sync_score differs from the plain version: {cmp}")
    keys = inputs["keys"]
    queues = [SC.top_k_desc(sc, cfg.queue_size) for sc in (got[0], want[0])]
    qcmp = selfcheck.compare_queues(
        *[(keys[p, 0], keys[p, 1], v) for v, p in queues], keys, tol[1])
    if not qcmp["ok"]:
        fail(f"sync_score's queue differs from the plain version's: {qcmp}")

    def launch():
        return E.score_candidates(cfg, **inputs)

    ms = event_ms(launch, reps=50)
    plain_ms = event_ms(lambda: E.score_candidates_plain(cfg, **inputs),
                        reps=5)
    reps = 20
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    kernel_us = sum(e.device_time_total for e in prof.key_averages()
                    if "sync_score_kernel" in e.key)
    t, d1 = keys.shape[0], inputs["emb"].shape[1]
    valid = keys[:, 0] != SC.PKEY_SENT
    n_valid = int(valid.sum())
    samples = inputs["coh_samples"]
    rows = torch.unique(torch.cat([keys[valid].flatten(), samples.int()]))
    n_phases = got[0].shape[0]
    nbytes = (12 * t + 4 * samples.numel() + 4 * d1 * rows.numel()
              + 4 * t * (1 + n_phases))
    ops = n_valid * 2 * d1 * (1 + samples.numel())
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return dict(
        name="sync_score", route="cuda",
        source="hyptokenizer_tpu_torch/ops/cuda/csrc/sync_score.cu",
        replaces="hyptokenizer_tpu/tokenizer/enhanced_state.py "
                 "_sync_finish's scoring (XLA ops, no pallas_call)",
        checked=True, rows=t, candidates=cmp["candidates"],
        samples=samples.numel(), d1=d1,
        score_gap=cmp["score_max_gap"],
        score_gap_over_tol=cmp["score_gap_over_tol"],
        dist_gap_over_tol=cmp["dist_gap_over_tol"],
        queue_differ=qcmp["differ"], ms=ms,
        kernel_ms=kernel_us / reps / 1e3, plain_ms=plain_ms,
        library_ms=None, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms > ops_ms else "operations")


def check_curvature_step(tok):
    """The curvature Adam step's kernel C1 against its plain version
    (``enhanced_state.curvature_adam_plain``) on the trained state of
    ``tok``, made due (its counter one interval back), from the same
    draws: curvature, moments and the rescaled distances within 1e-5
    relative, their infinities kept, the step and merge counters equal.
    Then timed with CUDA events over 50 steps (the wrapper's host side
    included, the draws made once) beside the plain version over 20, and
    by the profiler's kernel time of its two kernels; bound by bytes: each
    embedding row the step gathers read once, the draws and the merge
    pairs read once, the rescaled distances read and written once."""
    from hyptokenizer_tpu_torch.ops.cuda import curvature_step as C1
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    cfg = tok.enh_config
    st = tok.enh_state
    nm = int(st.base.num_merges)
    st = dataclasses.replace(st, curv_last=torch.full_like(
        st.curv_last, nm - cfg.curvature_freq))
    sc = E.state_scalars(st)
    draws = E.TorchSampler(7, st.base.emb.device).curvature(
        cfg.hier_pairs, cfg.hier_negatives, cfg.distortion_samples,
        sc["vocab_size"])
    fixed = types.SimpleNamespace(curvature=lambda *_: draws)

    def launch():
        return E._maybe_update_curvature(st, cfg, fixed, scalars=sc)

    C1.reset_launches()
    got = launch()
    want = E.curvature_adam_plain(st, cfg, draws, nm)
    rel = 0.0
    for a, b in ((got.base.curvature, want.base.curvature),
                 (got.curv_m, want.curv_m), (got.curv_v, want.curv_v),
                 (got.base.best_dist, want.base.best_dist),
                 (got.q_dist, want.q_dist)):
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin) or \
                not torch.equal(a[~fin], b[~fin]):
            fail("curvature_step changed which distances are infinite")
        if bool(fin.any()):
            rel = max(rel, float(((a[fin] - b[fin]).abs()
                                  / b[fin].abs().clamp_min(1e-30)).max()))
    if rel > 1e-5 or C1.launches != 1 or \
            not torch.equal(got.curv_t, want.curv_t) or \
            not torch.equal(got.curv_last, want.curv_last):
        fail(f"curvature_step differs from the plain version: relative "
             f"{rel:.3g}, launches {C1.launches}, t {int(got.curv_t)} / "
             f"{int(want.curv_t)}, last {int(got.curv_last)} / "
             f"{int(want.curv_last)}")

    ms = event_ms(launch, reps=50)
    plain_ms = event_ms(lambda: E.curvature_adam_plain(st, cfg, draws, nm),
                        reps=20)
    reps = 20
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    kernel_us = sum(e.device_time_total for e in prof.key_averages()
                    if "terms_kernel" in e.key or "update_kernel" in e.key)
    negs, ii, jj = draws
    hp = cfg.hier_pairs
    take = torch.clamp(max(nm - hp, 0) + torch.arange(
        hp, device=negs.device), max=max(nm - 1, 0))
    rows = torch.unique(torch.cat([st.base.merges[take].flatten(),
                                   negs.flatten(), ii, jj]))
    d1 = st.base.emb.shape[1]
    nbytes = (4 * d1 * rows.numel() + 4 * (negs.numel() + 2 * ii.numel())
              + 8 * hp + 8 * (st.base.best_dist.numel() + st.q_dist.numel()))
    return dict(
        name="curvature_step", route="cuda",
        source="hyptokenizer_tpu_torch/ops/cuda/csrc/curvature_step.cu",
        replaces="hyptokenizer_tpu/tokenizer/enhanced_state.py "
                 "_maybe_update_curvature (jax.grad and the Adam update: "
                 "XLA ops, no pallas_call)",
        checked=True, max_rel_err=rel, merges=nm,
        poisoned=bool(st.base.best_dist[0] == -float("inf")),
        rows_gathered=rows.numel(), ms=ms, kernel_ms=kernel_us / reps / 1e3,
        plain_ms=plain_ms, library_ms=None,
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes")


def k1_floor_state(st0, cfg):
    """(state, config, budgets) of K1's step floor from the synced state
    ``st0``: threshold 0, no adaptive growth and no empty-round stop, so no
    step merges and one launch runs ``SEGMENT_STEPS`` steps of the queue
    scan, the block's barriers and the loop scalars alone."""
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K1
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    cfg0 = dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, adaptive_threshold=False, empty_stop_after=1 << 30))
    st = dataclasses.replace(st0, base=dataclasses.replace(
        st0.base, threshold=torch.zeros_like(st0.base.threshold)))
    sc = E.state_scalars(st)
    budgets = (sc["num_merges"] + LOG_EVERY,
               sc["step"] + K1.SEGMENT_STEPS + 1, E.NO_CURVATURE_STOP)
    return st, cfg0, budgets


def time_k1_floor(st0, cfg):
    """K1's step floor (``k1_floor_state``) timed with CUDA events after a
    warm-up launch. Returns (ms, steps)."""
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    st, cfg0, budgets = k1_floor_state(st0, cfg)
    ms, sk = time_k1_segment(st, cfg0, budgets)
    a, b = E.state_scalars(st), E.state_scalars(sk)
    steps = b["step"] - a["step"]
    if steps < 1 or b["num_merges"] != a["num_merges"] or \
            b["needs_resync"]:
        fail(f"the K1 floor segment ran {steps} steps and "
             f"{b['num_merges'] - a['num_merges']} merges")
    return ms, steps


def time_k1_segment(st0, cfg, budgets):
    """One K1 segment from ``st0`` (left untouched) timed with CUDA events,
    after a warm-up segment on a clone. Returns (ms, the kernel's end
    state)."""
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K1
    from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E

    warm, run = E.clone_state(st0), E.clone_state(st0)
    K1.run_segment_cuda(warm, cfg, *budgets)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    sk = K1.run_segment_cuda(run, cfg, *budgets)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), sk


def main_path_distance(lines, device="cuda"):
    """The distance-only path: construct (K3 over 4096 rows), train
    ``DIST_WARM`` steps and ``DIST_CHUNKS`` chunks of ``DIST_CHUNK`` steps
    (the startup controller, then K4), encode/decode, save/load and one
    more chunk after load. Returns the trained tokenizer, a copy of its
    state before save and the phase's numbers."""
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.ops import lorentz as L
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3
    from hyptokenizer_tpu_torch.tokenizer import HyperbolicTokenizer

    dev = torch.device(device)
    chars = sorted({ch for ln in lines for ch in ln})
    if len(chars) > DIST_N0:
        fail(f"the corpus has {len(chars)} characters, more than {DIST_N0}")
    have = set(chars)
    extra = (chr(c) for c in range(0x4E00, 0x4E00 + 2 * DIST_N0)
             if chr(c) not in have)
    vocab = chars + [next(extra) for _ in range(DIST_N0 - len(chars))]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    emb = L.random_points(gen, DIST_N0, 100, sigma=0.5, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    K3.reset_launches()
    K4.reset_launches()
    t0 = time.perf_counter()
    tok = HyperbolicTokenizer(vocab, emb, merge_threshold=5.0,
                              max_vocab_size=50_176, search_block=512,
                              device=dev)
    tok.config = dataclasses.replace(tok.config,
                                     max_token_len=DIST_MAX_TOKEN_LEN)
    sync()
    ctor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok.optimize_merges(DIST_WARM, log_every=DIST_CHUNK)
    tok.optimize_merges(DIST_CHUNKS * DIST_CHUNK, log_every=DIST_CHUNK)
    sync()
    train_s = time.perf_counter() - t0
    merges = len(tok.merge_history)
    steps = int(tok.state.step)
    if steps != DIST_WARM + DIST_CHUNKS * DIST_CHUNK or \
            merges != int(tok.state.num_merges) or merges < DIST_CHUNK:
        fail(f"distance-only path: {steps} steps, {merges} merges (device "
             f"{int(tok.state.num_merges)})")
    trained = selfcheck.clone_merge_state(tok.state)

    v = len(tok.vocab)
    emb_v = tok.state.emb[:v]
    if int(tok.state.vocab_size) != v or emb_v.shape != (v, 101) or \
            not bool(torch.isfinite(emb_v).all()):
        fail("distance-only rows are not finite of shape (V, 101)")
    lengths = [len(t) for t in tok.vocab]
    if tok.state.lengths[:v].tolist() != lengths:
        fail("distance-only token lengths disagree with the vocabulary")
    if max(lengths) > 2 * DIST_MAX_TOKEN_LEN:
        fail(f"a distance-only token of {max(lengths)} characters passed "
             f"the length gate {DIST_MAX_TOKEN_LEN}")
    sample = lines[:16]
    ids = tok.encode_batch(sample)
    for text, seq in zip(sample, ids):
        if tok.decode(seq) != text:
            fail(f"distance-only encode/decode is not lossless on "
                 f"{text[:40]!r}")
    with tempfile.TemporaryDirectory() as d:
        tok.save(d)
        back = HyperbolicTokenizer.load(d, device=device)
    if back.vocab != tok.vocab or back.encode_batch(sample) != ids:
        fail("distance-only vocabulary or encodes differ after save/load")
    back.config = dataclasses.replace(back.config,
                                      max_token_len=DIST_MAX_TOKEN_LEN)
    t0 = time.perf_counter()
    back.optimize_merges(DIST_CHUNK, log_every=DIST_CHUNK)
    sync()
    after_s = time.perf_counter() - t0
    n_after = len(back.merge_history) - merges
    va = int(back.state.vocab_size)
    if n_after <= 0 or va != len(back.vocab) or \
            not bool(torch.isfinite(back.state.emb[:va]).all()):
        fail(f"distance-only training after load made {n_after} merges or "
             "non-finite rows")
    launches = {"merge_loop": K4.launches, "pairwise_min_best": K3.launches}
    return tok, trained, dict(
        ctor_s=ctor_s, train_s=train_s, merges=merges, steps=steps,
        vocab=v, max_len=max(lengths), startup=tok.startup_stats,
        after_load_s=after_s,
        after_load_merges=n_after, launches=launches,
        steps_per_s=[round(s["steps_per_sec"], 1)
                     for s in tok.training_stats],
        thresholds=[round(s["threshold"], 4) for s in tok.training_stats])


def check_k4(trained, cfg):
    """Kernel K4 against its plain version: step-by-step lockstep with
    oracle resync over ``K4_LOCKSTEP_STEPS`` steps from the trained state,
    the JAX package's chunk check at its own size (verdict recorded), then
    one ``DIST_CHUNK``-step chunk of each timed from the trained state."""
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4
    from hyptokenizer_tpu_torch.tokenizer import state as S

    out = {}
    selfcheck._lockstep_base_steps(trained, cfg, K4_LOCKSTEP_STEPS, out,
                                   "k4", row_atol=ROW_ATOL)
    if out["k4"] != "pass":
        fail(f"K4 lockstep against its plain version: {out['k4']}")
    selfcheck._check_base_kernel(out)

    max_v, d1 = trained.emb.shape
    v0, nm0 = int(trained.vocab_size), int(trained.num_merges)
    ms, sk = time_chunk(trained, cfg, DIST_CHUNK)
    t0 = time.perf_counter()
    sp = S.run_merges_plain(selfcheck.clone_merge_state(trained), cfg,
                            DIST_CHUNK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    m = int(sk.num_merges) - nm0
    steps = int(sk.step) - int(trained.step)
    if steps != DIST_CHUNK or m <= 0:
        fail(f"the K4 timing chunk ran {steps} steps and {m} merges")
    floor_ms = time_floor(trained, cfg)
    grid = K4.grid_size(trained.emb.device)
    nbytes = K4.chunk_bytes(v0, m, d1, max_v, cfg.max_token_len)
    ops = K4.chunk_ops(v0, m, steps, d1)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    mean_vocab = v0 + m / 2
    return dict(
        name="merge_loop", route="cuda",
        source="hyptokenizer_tpu_torch/ops/cuda/csrc/merge_loop.cu",
        replaces="hyptokenizer_tpu/ops/pallas/merge_loop.py:81",
        checked=True, max_abs_err=out["k4_row_err"], ms=ms,
        plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, chunk_steps=steps, chunk_merges=m,
        chunk_bytes=nbytes, chunk_ops=ops,
        bytes_rereading=K4.chunk_bytes_rereading(v0, m, steps, d1, max_v,
                                                 cfg.max_token_len),
        us_per_step=ms * 1e3 / steps,
        floor_us_per_step=floor_ms * 1e3 / DIST_CHUNK,
        bound_us_per_step=max(bytes_ms, ops_ms) * 1e3 / steps,
        mean_vocab=mean_vocab, grid=grid,
        resident_rows=K4.smem_plan(max_v, d1, grid).resident,
        plain_merges=int(sp.num_merges) - nm0,
        lockstep=out["k4"], lockstep_steps=out["k4_steps"],
        lockstep_merges=out["k4_merges"], pair_ties=out["k4_pair_ties"],
        partner_ties=out["k4_partner_ties"],
        row_err_over_tol=out["k4_row_err_over_tol"],
        gram_gap_over_bound=out["k4_gram_gap_over_bound"],
        chunk_check=out["kernel_selfcheck"],
        chunk_check_merges=out["kernel_selfcheck_merges"],
        chunk_check_ties=out.get("kernel_selfcheck_ties"))


def time_chunk(st, cfg, n_steps):
    """One K4 chunk of ``n_steps`` steps from ``st`` (left untouched) timed
    with CUDA events, after a warm-up chunk on a clone. Returns (ms, the
    kernel's end state)."""
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4

    warm = selfcheck.clone_merge_state(st)
    run = selfcheck.clone_merge_state(st)
    K4.run_merges_chunk(warm, cfg, n_steps)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    sk = K4.run_merges_chunk(run, cfg, n_steps)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), sk


def time_floor(st, cfg):
    """K4's step floor from ``st``: a ``DIST_CHUNK``-step chunk in which no
    step merges (threshold 0, no adaptation, no empty-round stop), so a
    step is the argmin, the grid barrier and the loop scalars alone."""
    cfg0 = dataclasses.replace(cfg, adaptive_threshold=False,
                               empty_stop_after=1 << 30)
    st0 = dataclasses.replace(st, threshold=torch.zeros_like(st.threshold))
    ms, sk = time_chunk(st0, cfg0, DIST_CHUNK)
    steps = int(sk.step) - int(st.step)
    if steps != DIST_CHUNK or int(sk.num_merges) != int(st.num_merges):
        fail(f"the K4 floor chunk ran {steps} steps and merged")
    return ms


def check_k4_depth():
    """Kernel K4 at the bench's depth: ``K4_DEPTH_N0`` active rows in
    50,176 slots (``evals/selfcheck.base_state``), one ``DIST_CHUNK``-step
    chunk timed, its step floor from the same state, and
    ``K4_DEPTH_LOCKSTEP`` steps held to the plain version step by step."""
    from hyptokenizer_tpu_torch.evals import selfcheck
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4

    st, cfg = selfcheck.base_state("cuda", n0=K4_DEPTH_N0, d=100,
                                   max_v=50_176, threshold=5.0)
    max_v, d1 = st.emb.shape
    ms, sk = time_chunk(st, cfg, DIST_CHUNK)
    m = int(sk.num_merges)
    steps = int(sk.step)
    if steps != DIST_CHUNK or m <= 0:
        fail(f"the deep K4 chunk ran {steps} steps and {m} merges")
    floor_ms = time_floor(st, cfg)
    out = {}
    selfcheck._lockstep_base_steps(st, cfg, K4_DEPTH_LOCKSTEP, out, "k4d",
                                   row_atol=ROW_ATOL)
    if out["k4d"] != "pass" or out["k4d_steps"] != K4_DEPTH_LOCKSTEP:
        fail(f"K4 lockstep at {K4_DEPTH_N0} rows against its plain "
             f"version: {out['k4d']} over {out['k4d_steps']} steps")
    nbytes = K4.chunk_bytes(K4_DEPTH_N0, m, d1, max_v)
    ops = K4.chunk_ops(K4_DEPTH_N0, m, steps, d1)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return dict(
        rows=K4_DEPTH_N0, mean_vocab=K4_DEPTH_N0 + m / 2, ms=ms,
        chunk_steps=steps, chunk_merges=m, us_per_step=ms * 1e3 / steps,
        floor_ms=floor_ms, floor_us_per_step=floor_ms * 1e3 / DIST_CHUNK,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        chunk_bytes=nbytes, chunk_ops=ops,
        bytes_rereading=K4.chunk_bytes_rereading(K4_DEPTH_N0, m, steps, d1,
                                                 max_v),
        lockstep=out["k4d"], lockstep_steps=out["k4d_steps"],
        lockstep_merges=out["k4d_merges"], pair_ties=out["k4d_pair_ties"],
        partner_ties=out["k4d_partner_ties"], max_abs_err=out["k4d_row_err"],
        row_err_over_tol=out["k4d_row_err_over_tol"],
        gram_gap_over_bound=out["k4d_gram_gap_over_bound"])


class KernelTimer:
    """CUDA events around each launch of the kernels' wrappers (K1/K2
    ``enhanced_loop.run_segment_cuda``, K3 ``pairwise.pairwise_min_best``,
    K4 ``merge_loop.run_merges_chunk``), with the loop's step counter before
    and after, kept on the card until :meth:`collect`. The events bracket
    the wrapper, so its host side counts where the card waits for it."""

    def __init__(self):
        from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
        from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4
        from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3

        self.marks = {}
        self.patched = []

        def wrap(mod, attr, name_of, step_of):
            fn = getattr(mod, attr)

            def timed(*args, **kw):
                name = name_of(*args)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                s0 = step_of(args[0])
                a.record()
                out = fn(*args, **kw)
                b.record()
                s1 = step_of(out[0] if isinstance(out, tuple) else out)
                self.marks.setdefault(name, []).append((a, b, s0, s1))
                return out

            setattr(mod, attr, timed)
            self.patched.append((mod, attr, fn))

        zero = torch.zeros((), dtype=torch.int32, device="cuda")
        wrap(K12, "run_segment_cuda",
             lambda st, cfg, *_: ("enhanced_loop_dense" if cfg.uses_dense
                                  else "enhanced_loop"),
             lambda st: st.base.step.clone())
        wrap(K3, "pairwise_min_best", lambda *_: "pairwise_min_best",
             lambda _: zero)
        wrap(K4, "run_merges_chunk", lambda *_: "merge_loop",
             lambda st: st.step.clone())

    def collect(self) -> dict:
        """Per kernel since the last call: launches, event ms summed, steps
        and µs per step; then forget them."""
        torch.cuda.synchronize()
        out = {}
        for name, marks in self.marks.items():
            ms = sum(a.elapsed_time(b) for a, b, _, _ in marks)
            steps = int(sum(int(s1) - int(s0) for _, _, s0, s1 in marks))
            out[name] = dict(launches=len(marks), event_ms=ms, steps=steps)
            if steps:
                out[name]["us_per_step"] = ms * 1e3 / steps
        self.marks = {}
        return out

    def close(self) -> None:
        for mod, attr, fn in self.patched:
            setattr(mod, attr, fn)


def bench_phase(lines):
    """The port's bench (``hyptokenizer_tpu_torch/bench.py``) at its full
    default depth, through its ``run``: each path with the launch counts
    reset just before it and read just after, its kernels' launches timed,
    and its outputs checked; then the selfcheck. Returns (the bench's
    headline, its diagnostics, its record, the full-depth numbers per path
    and kernel, the bench's wall seconds)."""
    from hyptokenizer_tpu_torch import bench
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3

    needs = {"enhanced": ("enhanced_loop",),
             "allfeatures": ("enhanced_loop_dense", "pairwise_min_best"),
             "distance_only": ("pairwise_min_best", "merge_loop")}
    depth = {}
    timer = KernelTimer()

    def reset():
        K12.reset_launches()
        K3.reset_launches()
        K4.reset_launches()

    def after(name, rec, trained):
        counts = {"enhanced_loop": K12.launches,
                  "enhanced_loop_dense": K12.dense_launches,
                  "pairwise_min_best": K3.launches,
                  "merge_loop": K4.launches}
        timed = timer.collect()
        for kernel in needs[name]:
            if counts[kernel] <= 0:
                fail(f"the bench's {name} path never launched kernel "
                     f"{kernel}")
            if timed.get(kernel, {}).get("launches") != counts[kernel]:
                fail(f"{kernel} on the bench's {name} path: "
                     f"{counts[kernel]} launches counted, "
                     f"{timed.get(kernel, {}).get('launches')} timed")
        depth[name] = {k: dict(timed[k]) for k in needs[name]}
        if name == "enhanced":
            if rec["stop"] not in ("target", "no candidates"):
                fail(f"the corpus-only bench ended by {rec['stop']} after "
                     f"{rec['merges']} merges")
            check_trained(trained, lines)
        elif name == "allfeatures":
            if rec["stop"] != "capacity" or rec["vocab"] != 50_176 or \
                    rec["phase"] != 3:
                fail(f"the all-features bench ended by {rec['stop']} at "
                     f"vocab {rec['vocab']} in phase {rec['phase']}")
            if not rec["curvature"] == rec["curvature"] or \
                    rec["curvature"] == 1.0:
                fail(f"all-features curvature {rec['curvature']}")
            check_trained(trained, lines)
        else:
            v = int(trained.vocab_size)
            if not rec["rate"] > 0 or int(trained.num_merges) <= 0 or \
                    not bool(torch.isfinite(trained.emb[:v]).all()):
                fail(f"the distance-only bench: {rec}")
        depth[name]["merges"] = rec["merges"]
        depth[name]["vocab"] = rec["vocab"]
        depth[name]["memory"] = rec["memory"]
        timer.collect()     # drop the checks' launches
        reset()

    reset()
    t0 = time.perf_counter()
    try:
        head, diag, rec, failed = bench.run("cuda", lines=lines, after=after)
    finally:
        timer.close()
    wall = time.perf_counter() - t0
    if failed:
        fail(f"kernel_selfcheck: {json.dumps(failed)}")
    for key in ("value", "enhanced_allfeatures_merges_per_sec",
                "distance_only_steps_per_sec"):
        if not head[key] > 0:
            fail(f"the bench's {key} is {head[key]}")
    return head, diag, rec, depth, wall


# The CLI phase: the README's Quick start (with merge-tree supervision at
# its default 27,000 // 3 = 9,000 steps), the flagship's flags of
# bench.ENHANCED, the resume check and the distance-only CLI.
QUICKSTART = ["--embedding-dim", "100", "--max-vocab-size", "50000",
              "--steps", "46000", "--embed-steps", "3000",
              "--pre-split", "words", "--merge-policy", "priority"]
SUPERVISION = ["--hierarchy-supervision", "merge-tree"]
FLAGSHIP_CLI = ["--embedding-dim", "100", "--init-sigma", "0.5",
                "--max-vocab-size", "50176", "--merge-threshold", "100.0",
                "--alpha", "0.05", "--beta", "0.9", "--gamma", "0.05",
                "--no-use-hierarchical", "--no-use-compression-aware",
                "--optimize-curvature-freq", "1000",
                "--no-use-dense-channel", "--merge-batch", "16",
                "--corpus-max-tokens", "2900000", "--seed", "0",
                "--steps", "50000", "--log-every", "2048",
                "--target-vocab-size", "50000", "--pre-split", "words",
                "--merge-policy", "priority"]
RESUME_STEPS = 6144      # crosses both phase switches (1000, 6000)
RESUME_CHUNK = 1024      # --log-every; the checkpoint after 3 chunks
# train_tokenizer as the JAX CLI runs it: no token-length cap. Its strings
# grow with the square of the steps once its chains pass the acosh clamp
# floor (about 1 MB at 512 steps), so the depth is cut to 512 steps and
# the vocabulary's bytes are gated.
BASE_CLI = ["--embedding-dim", "100", "--max-vocab-size", "50000",
            "--steps", "512", "--log-every", "256"]
BASE_CLI_MAX_BYTES = 16 << 20
SHEET_RTOL = 1e-5        # x0 against sqrt(1 + c |x_s|^2) in float64


def check_on_sheet(out_dir: str, what: str, c: float = 1.0) -> None:
    """The saved rows are finite and on the sheet ``x0^2 - c |x_s|^2 = 1``
    (the embedding trainers project with the tokenizer's curvature ``c``,
    as the JAX package's do)."""
    import numpy as np
    emb = np.load(os.path.join(out_dir, "embeddings.npy")).astype(np.float64)
    if not np.isfinite(emb).all():
        fail(f"{what}: non-finite saved embeddings")
    x0 = np.sqrt(1.0 + c * np.sum(emb[:, 1:] ** 2, axis=1))
    err = float(np.max(np.abs(emb[:, 0] - x0) / x0))
    if err > SHEET_RTOL:
        fail(f"{what}: saved rows off the sheet (relative {err:.3g})")


def check_loaded(tok, cls, out_dir, sample, what, device):
    """Lossless encode, and the same ids from the CLI's saved artifacts."""
    ids = tok.encode_batch(sample)
    for text, seq in zip(sample, ids):
        if tok.decode(seq) != text:
            fail(f"{what}: encode/decode is not lossless on {text[:40]!r}")
    back = cls.load(out_dir, device=device)
    if back.encode_batch(sample) != ids or back.vocab != tok.vocab:
        fail(f"{what}: the saved artifacts encode differently")


def read_metrics(path: str) -> dict:
    with open(path) as f:
        records = [json.loads(ln) for ln in f]
    return {r["stage"]: r for r in records if "stage" in r}


def run_clis(runs, work):
    """CLI runs, each in a new process (``python -m``) as a user runs it,
    all started together. ``runs`` maps a name to its argv; returns each
    run's seconds. A failed run fails the phase once every process ended."""
    cmd = [sys.executable, "-m",
           "hyptokenizer_tpu_torch.cli.train_enhanced_tokenizer"]
    env = dict(os.environ, PYTHONPATH=HERE)
    logs = {what: os.path.join(work, what + ".log") for what in runs}
    t0 = time.perf_counter()
    procs = {}
    took = {}
    try:
        for what, argv in runs.items():
            with open(logs[what], "w") as log:
                procs[what] = subprocess.Popen(
                    cmd + argv, cwd=HERE, stdout=subprocess.DEVNULL,
                    stderr=log, env=env)
        while len(took) < len(procs):
            if time.perf_counter() - t0 > 600:
                fail(f"CLI runs {sorted(set(procs) - set(took))} took over "
                     "600 s")
            for what, proc in procs.items():
                if what not in took and proc.poll() is not None:
                    took[what] = time.perf_counter() - t0
            time.sleep(0.05)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    errors = []
    for what, proc in procs.items():
        if proc.returncode != 0:
            with open(logs[what]) as f:
                errors.append(f"{what}: exit {proc.returncode}\n"
                              f"{f.read()[-3000:]}")
    if errors:
        fail("; ".join(errors))
    return took


def cli_phase(work: str, lines):
    """The port's CLIs as a user runs them, on the corpus decompressed to
    ``work/corpus.txt``: (a) the README's Quick start with merge-tree
    supervision, (b) the flagship's flags with ``--no-use-dense-channel``,
    (c) exact resume across processes, (d) ``train_tokenizer``. Each of
    (a), (b) and (d) runs through ``main(argv)`` with the launch counts
    reset just before and read just after, each kernel's launches timed by
    ``KernelTimer``. Returns the phase's numbers."""
    from hyptokenizer_tpu_torch.cli import train_enhanced_tokenizer as TE
    from hyptokenizer_tpu_torch.cli import train_tokenizer as TB
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3
    from hyptokenizer_tpu_torch.tokenizer import (
        EnhancedHyperbolicTokenizer, HyperbolicTokenizer)

    import bz2
    import shutil
    corpus = os.path.join(work, "corpus.txt")
    with bz2.open(CORPUS, "rb") as src, open(corpus, "wb") as dst:
        shutil.copyfileobj(src, dst)
    device = "cuda"   # the CLIs' default: no --device flag is passed
    sample = lines[:16]
    res = {}

    def drive(name, main_fn, argv, needs):
        K12.reset_launches()
        K3.reset_launches()
        K4.reset_launches()
        timer = KernelTimer()
        try:
            t0 = time.perf_counter()
            tok = main_fn(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            timed = timer.collect()
        finally:
            timer.close()
        counts = {"enhanced_loop": K12.launches,
                  "enhanced_loop_dense": K12.dense_launches,
                  "pairwise_min_best": K3.launches,
                  "merge_loop": K4.launches}
        for kernel in needs:
            if counts[kernel] <= 0:
                fail(f"the CLI path {name} never launched kernel {kernel}")
        res[name] = dict(
            wall_s=wall, merges=len(tok.merge_history), vocab=len(tok.vocab),
            launches={k: counts[k] for k in needs},
            kernels={k: timed[k] for k in needs if k in timed})
        return tok

    # (a) the Quick start
    out_a = os.path.join(work, "quickstart")
    m_a = os.path.join(work, "quickstart.jsonl")
    tok = drive("quickstart", TE.main,
                ["--corpus-path", corpus, "--output-dir", out_a,
                 "--metrics-path", m_a] + QUICKSTART + SUPERVISION,
                ("enhanced_loop_dense", "pairwise_min_best"))
    stages = read_metrics(m_a)
    print(f"CLI (a) Quick start: {json.dumps(res['quickstart'])} stages "
          f"{json.dumps(stages)} chunk_syncs "
          f"{[s['chunk_syncs'] for s in tok.training_stats]} chunk_seconds "
          f"{[round(s['chunk_seconds'], 3) for s in tok.training_stats]}",
          flush=True)
    pre = stages["embed_pretrain"]
    if not pre["loss_last"] < pre["loss_first"]:
        fail(f"Quick start pretraining loss {pre['loss_first']} -> "
             f"{pre['loss_last']} did not fall")
    check_on_sheet(out_a, "Quick start", float(tok.state.curvature))
    t0 = time.perf_counter()
    check_trained(tok, [ln for ln in lines if ln][:16], device)
    check_loaded(tok, EnhancedHyperbolicTokenizer, out_a, sample,
                 "Quick start", device)
    res["quickstart"]["checks_s"] = time.perf_counter() - t0
    res["quickstart"].update(
        phase=tok.current_phase, curvature=float(tok.state.curvature),
        pretrain_s=pre["seconds"], pretrain_steps=pre["steps"],
        pretrain_loss=[pre["loss_first"], pre["loss_last"]],
        train_s=stages["train"]["seconds"],
        supervision_s=stages["hierarchy_supervision"]["seconds"])
    del tok

    # (b) the flagship's flags through the CLI, corpus only (K1)
    out_b = os.path.join(work, "flagship")
    tok = drive("flagship", TE.main,
                ["--corpus-path", corpus, "--output-dir", out_b]
                + FLAGSHIP_CLI,
                ("enhanced_loop",))
    # The bench's stop: its target, or candidate exhaustion (a chunk that
    # merged nothing, and the next one, which optimize_merges does not
    # record, merged nothing too).
    target = int(FLAGSHIP_CLI[FLAGSHIP_CLI.index("--target-vocab-size") + 1])
    last = tok.training_stats[-1]["chunk_merges"]
    print(f"CLI (b) flagship: {json.dumps(res['flagship'])} last chunk "
          f"{last}", flush=True)
    if len(tok.vocab) < target and last != 0:
        fail(f"the flagship CLI ended at vocab {len(tok.vocab)}, its last "
             f"chunk merging {last}")
    check_trained(tok, [ln for ln in lines if ln][:16], device)
    check_loaded(tok, EnhancedHyperbolicTokenizer, out_b, sample,
                 "flagship CLI", device)
    res["flagship"]["stop"] = ("target" if len(tok.vocab) >= target
                               else "no candidates")
    del tok

    # (c) exact resume: uninterrupted, and beside it a checkpointed half,
    # then its continuation in a new process (--steps counts what is left).
    ck = os.path.join(work, "ck")
    common = (["--corpus-path", corpus, "--log-every", str(RESUME_CHUNK)]
              + QUICKSTART)
    common[common.index("--steps") + 1] = str(RESUME_STEPS)
    half = list(common)
    half[half.index("--steps") + 1] = str(RESUME_STEPS // 2)
    every = ["--checkpoint-dir", ck, "--checkpoint-every",
             str(RESUME_STEPS // 2 // RESUME_CHUNK)]
    dirs = {k: os.path.join(work, "resume_" + k)
            for k in ("whole", "half", "resumed")}
    took = run_clis({
        "whole": common + ["--output-dir", dirs["whole"]],
        "half": half + every + ["--output-dir", dirs["half"]]}, work)
    took.update(run_clis({"resumed": half + [
        "--checkpoint-dir", ck, "--resume", "--output-dir", dirs["resumed"]]},
        work))
    with open(os.path.join(ck, "host_state.json")) as f:
        at = len(json.load(f)["merge_history"])
    import numpy as np
    got = {}
    for k in ("whole", "resumed"):
        with open(os.path.join(dirs[k], "merges.json")) as f:
            merges = f.read()
        with open(os.path.join(dirs[k], "config.json")) as f:
            cfg = json.load(f)
        got[k] = (merges, np.load(os.path.join(dirs[k], "embeddings.npy")),
                  np.load(os.path.join(dirs[k], "curvature.npy")),
                  cfg["merge_threshold"], cfg["curvature"])
    w, r = got["whole"], got["resumed"]
    n_merges = len(json.loads(w[0]))
    if n_merges < RESUME_STEPS or not 0 < at < n_merges:
        fail(f"resume check: {n_merges} merges, checkpoint at {at}")
    if w[0] != r[0]:
        fail("resume check: the merge histories differ")
    if not (np.array_equal(w[1], r[1]) and np.array_equal(w[2], r[2])
            and w[3] == r[3] and w[4] == r[4]):
        fail("resume check: embeddings, curvature or threshold differ")
    res["resume"] = dict(merges=n_merges, checkpoint_at=at,
                         curvature=float(w[2]), threshold=w[3],
                         process_s=took)
    print(f"CLI (c) resume: {json.dumps(res['resume'])}", flush=True)

    # (d) train_tokenizer (K3 in the constructor, K4 in training)
    out_d = os.path.join(work, "base")
    tok = drive("train_tokenizer", TB.main,
                ["--corpus-path", corpus, "--output-dir", out_d] + BASE_CLI,
                ("pairwise_min_best", "merge_loop"))
    nbytes = sum(len(t.encode("utf-8")) for t in tok.vocab)
    if nbytes > BASE_CLI_MAX_BYTES:
        fail(f"train_tokenizer's vocabulary holds {nbytes} bytes")
    check_on_sheet(out_d, "train_tokenizer")
    check_loaded(tok, HyperbolicTokenizer, out_d, sample, "train_tokenizer",
                 device)
    res["train_tokenizer"].update(
        vocab_bytes=nbytes, longest=max(len(t) for t in tok.vocab),
        steps=int(tok.state.step))
    return res



# The models phase: the downstream CLIs at their defaults (train_nlp_tasks:
# hidden 256, 4 layers, 4 heads, --max-length 128, batch 16, --max-lines
# 2000, 1 epoch; train_retrieval --synthetic: tower 128, depth 2,
# projection 64, batch 32, image 64, seq 32, 2 epochs of 20 batches).
NLP_LINES = 2000          # train_nlp_tasks' --max-lines
HELD_OUT = slice(4000, 4500)   # corpus lines none of the training reads
BENCH_LINES = 1000        # benchmark_efficiency's --max-lines
FWD_TOL = 1e-4            # card vs CPU forward, fp32 with TF32 off
STAGES = (("TokenizerAdapter", "load"), ("get_embeddings", "export"),
          ("batch_encode", "encode"), ("build_bert_mlm", "build"),
          ("build_bert_classifier", "build"), ("_adamw", "optimizer"),
          ("mlm_eval", "mlm_eval"),
          ("mlm_train", "mlm_train"),
          ("classification_train", "classification_train"))


class StageClock:
    """Seconds of the downstream stages: ``models.nlp``'s functions and the
    adapter's methods wrapped with a card synchronisation on each side
    (nested stages count in both). Keeps the last adapter built, and the
    host clock at each batch ``make_batches`` hands out (after a
    synchronisation: the previous step has ended), one list per call."""

    def __init__(self):
        from hyptokenizer_tpu_torch.models import nlp
        self.seconds, self.patched, self.adapter = {}, [], None
        self.batch_clock = []
        adapter_cls = nlp.TokenizerAdapter
        for name, stage in STAGES:
            owner = adapter_cls if name in (
                "get_embeddings", "batch_encode") else nlp
            self._wrap(owner, name, stage)
        batches = nlp.make_batches

        def clocked(*args, **kw):
            marks = []
            self.batch_clock.append(marks)
            for batch in batches(*args, **kw):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                yield batch
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        nlp.make_batches = clocked
        self.patched.append((nlp, "make_batches", batches))

    def _wrap(self, owner, name, stage):
        fn = getattr(owner, name)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[stage] = (self.seconds.get(stage, 0.0)
                                   + time.perf_counter() - t0)
            if name == "TokenizerAdapter":
                self.adapter = out
            return out

        setattr(owner, name, timed)
        self.patched.append((owner, name, fn))

    def close(self):
        for owner, name, fn in self.patched:
            setattr(owner, name, fn)


def check_forward(model, batch, what):
    """The trained model's forward on the card against a CPU copy's on the
    same batch; returns the largest absolute difference."""
    import copy
    ids, mask = (torch.from_numpy(a).long() for a in batch)
    with torch.no_grad():
        got = model(ids.cuda(), mask.cuda()).cpu()
        want = copy.deepcopy(model).cpu()(ids, mask)
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite logits on the card")
    if not torch.allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL):
        fail(f"{what}: card and CPU forwards differ by "
             f"{float((got - want).abs().max()):.3g}")
    return float((got - want).abs().max())


def models_phase(work: str):
    """The downstream models and the evaluation CLIs on the Quick start's
    tokenizer (``work/quickstart``, about 46,000 tokens, loaded by the base
    class as the JAX CLIs load it; each load runs K3 in its constructor,
    over the initial vocabulary):
    (e) ``train_nlp_tasks --task both`` at its defaults with hyperbolic
    embeddings, on ``work/corpus.txt`` with held-out lines and
    classification TSVs labelled by whether the line holds a digit; (f)
    ``train_retrieval --synthetic`` at its defaults; (g)
    ``benchmark_efficiency`` on 1000 corpus lines; (h) ``compare_tokenizers``
    against a ``bpe`` baseline from ``train_baseline_tokenizers`` (or alone
    when the ``tokenizers`` library does not import). Returns the phase's
    numbers."""
    import re

    import numpy as np

    from hyptokenizer_tpu_torch.cli import benchmark_efficiency as TBE
    from hyptokenizer_tpu_torch.cli import compare_tokenizers as TCT
    from hyptokenizer_tpu_torch.cli import train_baseline_tokenizers as TTB
    from hyptokenizer_tpu_torch.cli import train_nlp_tasks as TN
    from hyptokenizer_tpu_torch.cli import train_retrieval as TR
    from hyptokenizer_tpu_torch.models import (
        MultimodalHyperbolicModel, TransformerTower, ViTTower, nlp)
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3

    corpus = os.path.join(work, "corpus.txt")
    tok_dir = os.path.join(work, "quickstart")
    with open(corpus, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    held = lines[HELD_OUT]
    val_text = os.path.join(work, "val.txt")
    with open(val_text, "w", encoding="utf-8") as f:
        f.write("\n".join(held) + "\n")
    tsv = {}
    for split, part in (("train", lines[:NLP_LINES]), ("val", held)):
        tsv[split] = os.path.join(work, f"{split}.tsv")
        with open(tsv[split], "w", encoding="utf-8") as f:
            for ln in part:
                label = int(bool(re.search(r"[0-9]", ln)))
                f.write(f"{label}\t{ln.replace(chr(9), ' ')}\n")
    res = {}

    def k3_launches(name, fn):
        K3.reset_launches()
        timer = KernelTimer()
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            timed = timer.collect()
        finally:
            timer.close()
        res[name] = {"wall_s": wall, "k3_launches": K3.launches,
                     "k3_event_ms": timed.get("pairwise_min_best",
                                              {}).get("event_ms")}
        if K3.launches <= 0:
            fail(f"{name}: loading the tokenizer never launched K3")
        return out

    # (e) BERT MLM and classification
    clock = StageClock()
    torch.cuda.reset_peak_memory_stats()
    try:
        results, models = k3_launches("nlp", lambda: TN.main([
            "--method", "hyperbolic", "--model-path", tok_dir,
            "--task", "both", "--train-text", corpus, "--val-text",
            val_text, "--train-cls", tsv["train"], "--val-cls", tsv["val"],
            "--output-dir", os.path.join(work, "nlp")]))
    finally:
        clock.close()
    e = res["nlp"]
    e.update(results, peak_mib=torch.cuda.max_memory_allocated() / 2**20,
             stages=dict(clock.seconds))
    ppl = results.get("mlm_val_perplexity")
    acc = results.get("classification_val_accuracy")
    if ppl is None or not np.isfinite(ppl) or acc is None \
            or not 0.0 <= acc <= 1.0:
        fail(f"train_nlp_tasks: results {results}")
    for task, model in models.items():
        if any(p.device.type != "cuda" for p in model.parameters()):
            fail(f"train_nlp_tasks: the {task} model is not on the card")
    steps = NLP_LINES // 16
    e["vocab"] = clock.adapter.get_vocab_size()
    e["mlm_steps_per_s"] = steps / (clock.seconds["mlm_train"]
                                    - clock.seconds["mlm_eval"])
    marks = clock.batch_clock[0]          # mlm_train's one epoch
    e["mlm_first_step_s"] = marks[1] - marks[0]
    e["mlm_steady_steps_per_s"] = (len(marks) - 2) / (marks[-1] - marks[1])
    e["classification_steps_per_s"] = (steps
                                       / clock.seconds["classification_train"])
    enc = clock.adapter.batch_encode(held[:16], max_length=128)
    batch = next(nlp.make_batches(enc, 16, 128))
    e["forward_max_abs_err"] = {
        task: check_forward(model, batch, f"train_nlp_tasks {task}")
        for task, model in models.items()}
    del models, clock
    print(f"models (e) train_nlp_tasks: {json.dumps(e)}", flush=True)

    # (f) two-tower retrieval on the synthetic task
    t0 = time.perf_counter()
    out_f = os.path.join(work, "retrieval")
    torch.cuda.reset_peak_memory_stats()
    ret = TR.main(["--synthetic", "--output-dir", out_f])
    torch.cuda.synchronize()
    hist = ret["history"]
    losses = [h["loss"] for h in hist]
    f_res = res["retrieval"] = dict(
        wall_s=time.perf_counter() - t0, losses=losses,
        r1=[h.get("text_to_image_r@1") for h in hist],
        best_r1=ret["best"]["r1"],
        peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"train_retrieval: the loss did not fall: {losses}")
    if any(r is None for r in f_res["r1"]) or f_res["best_r1"] < 0:
        fail(f"train_retrieval: R@1 not recorded: {f_res}")
    best = torch.load(os.path.join(out_f, "best_params.pt"),
                      weights_only=True)
    fresh = MultimodalHyperbolicModel(
        text_encoder=TransformerTower(vocab_size=256, dim=128, depth=2,
                                      heads=4, max_len=32),
        image_encoder=ViTTower(image_size=64, patch_size=8, dim=128,
                               depth=2, heads=4),
        projection_dim=64, hidden_dim=256)
    fresh.load_state_dict(best)
    print(f"models (f) train_retrieval: {json.dumps(f_res)}", flush=True)

    # (g) tokenize and encode throughput (host side, the native encoder)
    eff = k3_launches("benchmark_efficiency", lambda: TBE.main([
        "--tokenizer-dir", tok_dir, "--text-path", corpus,
        "--max-lines", str(BENCH_LINES),
        "--output-path", os.path.join(work, "efficiency.json")]))
    g = res["benchmark_efficiency"]
    for path in ("tokenize", "encode"):
        r = eff[path]
        if not r["tokens_per_sec"] > 0:
            fail(f"benchmark_efficiency: {path} {r}")
        g[path] = {k: r[k] for k in ("tokens_per_sec", "chars_per_sec",
                                     "total_tokens", "avg_seconds",
                                     "std_seconds")}
    print(f"models (g) benchmark_efficiency: {json.dumps(g)}", flush=True)

    # (h) compare against a BPE baseline (HF tokenizers, a CPU library)
    specs = ["--tokenizer", f"hyperbolic={tok_dir}"]
    try:
        import tokenizers  # noqa: F401
        have_hf = True
    except ImportError:
        have_hf = False
        print("models (h): the tokenizers library does not import here; "
              "the hyperbolic tokenizer is compared alone", flush=True)
    if have_hf:
        base = TTB.main(["--input-file", corpus, "--output-dir",
                         os.path.join(work, "baselines"), "--vocab-size",
                         "50000", "--kinds", "bpe"])
        specs += ["--tokenizer", f"bpe={base['bpe_50000']['path']}"]
    cmp = k3_launches("compare_tokenizers", lambda: TCT.main(
        specs + ["--text-path", corpus, "--output-dir",
                 os.path.join(work, "compare"), "--no-plot"]))
    h = res["compare_tokenizers"]
    h["tokenizers_library"] = have_hf
    for name, r in cmp.items():
        if not r["throughput"]["tokens_per_sec"] > 0:
            fail(f"compare_tokenizers: {name} {r}")
        h[name] = {"tokens_per_sec": r["throughput"]["tokens_per_sec"],
                   "chars_per_token": r["compression"]["chars_per_token"],
                   "word_boundary_ratio":
                       r["quality"]["word_boundary_ratio"],
                   "morpheme_ratio": r["quality"]["morpheme_ratio"]}
    print(f"models (h) compare_tokenizers: {json.dumps(h)}", flush=True)
    return res



# The parallel phase: the sharded training of parallel/ on the one card.
# (a) the flagship's CLI flags with --mesh (a world of one under NCCL);
# (b) two ranks on the card under gloo (NCCL refuses two ranks on one
# device): bench_scaling --multihost for both loops at its own 8,192 slots
# and 2,000 lines, and an all-features run (the dense channel: K2 reads the
# v3 sync's hashed table at D = 2), each against one process on the card;
# (c) K2 with n_buckets = 4 (check_k2_hashed, on the depth state);
# (d) bench_scaling at a world of one; (e) one int32 all_reduce under NCCL
# at a world of one and under gloo at a world of two.
PAR_RANKS = 2
PAR_LINES = 2000                  # bench_scaling's corpus slice
PAR_SLOTS = 8192                  # bench_scaling's enhanced slots
PAR_ALL_STEPS = 2048
PAR_ALL_CHUNK = 512
PAR_BENCH = {"base": ["--max-vocab-size", str(PAR_SLOTS), "--steps", "2048",
                      "--warmup", "128"],
             "enhanced": ["--loop", "enhanced", "--steps", "2048",
                          "--corpus-shards", str(PAR_RANKS)]}
COLLECTIVE_REPS = 200
KERNELS = ("enhanced_loop", "enhanced_loop_dense", "pairwise_min_best",
           "merge_loop")


def launch_counts() -> dict:
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3
    return dict(zip(KERNELS, (K12.launches, K12.dense_launches, K3.launches,
                              K4.launches)))


def reset_counts() -> None:
    from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
    from hyptokenizer_tpu_torch.ops.cuda import merge_loop as K4
    from hyptokenizer_tpu_torch.ops.cuda import pairwise as K3
    for mod in (K12, K3, K4):
        mod.reset_launches()


def par_all_features(lines, mesh):
    """bench.py bench_allfeatures' configuration at PAR_SLOTS slots on
    PAR_LINES lines, its corpus aligned for PAR_RANKS ranks, trained
    PAR_ALL_STEPS merges (both phase switches): (tokenizer, seconds)."""
    from hyptokenizer_tpu_torch import bench
    from hyptokenizer_tpu_torch.tokenizer import EnhancedHyperbolicTokenizer
    vocab, emb = bench.char_points(lines, torch.device("cuda"))
    kw = dict(bench.ALLFEATURES, max_vocab_size=PAR_SLOTS,
              corpus_shards=PAR_RANKS)
    tok = EnhancedHyperbolicTokenizer(vocab, emb, corpus_sample=lines,
                                      device="cuda", mesh=mesh, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok.optimize_merges(steps=PAR_ALL_STEPS, log_every=PAR_ALL_CHUNK,
                        phase_transition_steps={2: 1000, 3: 6000})
    torch.cuda.synchronize()
    return tok, time.perf_counter() - t0


def run_bench_scaling(loop: str, extra=()):
    """bench_scaling.main on one loop: (steps/s, merge history, launches,
    seconds), the launch counts reset just before it."""
    from hyptokenizer_tpu_torch.cli import bench_scaling
    reset_counts()
    t0 = time.perf_counter()
    res = bench_scaling.main(PAR_BENCH[loop] + list(extra))
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    (n, sps), = res["steps_per_sec_by_devices"].items()
    base = res["states"][n]
    hist = base.merges[:int(base.num_merges)].tolist()
    return sps, hist, launch_counts(), took


def collective_us(fn, reps: int = COLLECTIVE_REPS) -> float:
    """Median host microseconds of ``fn()`` followed by a card
    synchronisation, after 20 warm-up calls."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    return sorted(times)[len(times) // 2]


def parallel_child(rank: int, coordinator: str, out_path: str) -> None:
    """One of PAR_RANKS ranks on the card under gloo: (b)'s runs and the
    gloo all_reduce latency, written to ``out_path`` as JSON."""
    from hyptokenizer_tpu_torch.parallel import mesh as M
    from hyptokenizer_tpu_torch.parallel.multihost import (
        global_mesh, initialize_multihost)
    from hyptokenizer_tpu_torch.parallel.sharded import select_sync_path
    from hyptokenizer_tpu_torch.utils import data

    initialize_multihost(coordinator_address=coordinator,
                         num_processes=PAR_RANKS, process_id=rank,
                         backend="gloo", device="cuda")
    mesh = global_mesh("cuda", backend="gloo")
    rec = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend}
    flags = ["--multihost", "--dist-backend", "gloo"]
    for loop in ("base", "enhanced"):
        sps, hist, counts, took = run_bench_scaling(loop, flags)
        rec[loop] = dict(steps_per_s=sps, merges=hist, launches=counts,
                         seconds=took)
    lines = data.read_corpus_lines(CORPUS)[:PAR_LINES]
    reset_counts()
    tok, took = par_all_features(lines, mesh)
    rec["all_features"] = dict(
        merges=tok.merge_history, launches=launch_counts(), seconds=took,
        path=select_sync_path(tok.enh_state, tok.enh_config, mesh),
        syncs=[s["chunk_syncs"] for s in tok.training_stats])
    one = torch.ones((1,), dtype=torch.int32, device="cuda")
    rec["gloo_all_reduce_us"] = collective_us(
        lambda: M.all_reduce(mesh, one))
    with open(out_path, "w") as f:
        json.dump(rec, f)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(work: str, lines):
    """(a)-(e) above. Returns the phase's numbers."""
    import torch.distributed as dist

    from hyptokenizer_tpu_torch.cli import train_enhanced_tokenizer as TE
    from hyptokenizer_tpu_torch.parallel.sharded import select_sync_path

    res = {}
    # (a) the flagship through --mesh at a world of one (NCCL).
    corpus = os.path.join(work, "corpus.txt")
    out_a = os.path.join(work, "flagship_mesh")
    reset_counts()
    timer = KernelTimer()
    try:
        t0 = time.perf_counter()
        tok = TE.main(["--corpus-path", corpus, "--output-dir", out_a,
                       "--mesh"] + FLAGSHIP_CLI)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timed = timer.collect()
    finally:
        timer.close()
    counts = launch_counts()
    if counts["enhanced_loop"] <= 0:
        fail("the sharded flagship (--mesh) never launched enhanced_loop")
    path = select_sync_path(tok.enh_state, tok.enh_config, tok.mesh)
    if (tok.mesh.size, tok.mesh.backend, path) != (1, "nccl", "v3"):
        fail(f"the sharded flagship ran on {tok.mesh.size} ranks under "
             f"{tok.mesh.backend} through {path}, not one NCCL rank and v3")
    with open(os.path.join(out_a, "merges.json")) as f:
        sharded = f.read()
    with open(os.path.join(work, "flagship", "merges.json")) as f:
        unsharded = f.read()
    if sharded != unsharded:
        fail("the sharded flagship's merges differ from the unsharded CLI "
             "run's")
    res["flagship_mesh"] = dict(
        path=path, wall_s=wall, merges=len(tok.merge_history),
        launches={"enhanced_loop": counts["enhanced_loop"]},
        kernels={k: v for k, v in timed.items() if k == "enhanced_loop"},
        syncs=sum(s["chunk_syncs"] for s in tok.training_stats))
    print(f"parallel (a) flagship --mesh: path {path} (world 1, nccl), "
          f"{json.dumps(res['flagship_mesh'])}; merges equal the "
          f"unsharded CLI run's", flush=True)
    del tok

    # (b) two ranks on the card under gloo, started together.
    coord = f"127.0.0.1:{free_port()}"
    outs = [os.path.join(work, f"rank{r}.json") for r in range(PAR_RANKS)]
    logs = [os.path.join(work, f"rank{r}.log") for r in range(PAR_RANKS)]
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(PAR_RANKS):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--parallel-rank", str(r), "--coordinator", coord,
                     "--out", outs[r]], cwd=HERE, stdout=log,
                    stderr=subprocess.STDOUT, env=env))
        for p in procs:
            p.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        fail("the two gloo ranks took over 300 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.perf_counter() - t0
    # Then one process on the card, alone: the references, which are (d).
    ref = {}
    for loop in ("base", "enhanced"):
        sps, hist, counts, took = run_bench_scaling(loop)
        ref[loop] = dict(steps_per_s=sps, merges=hist, launches=counts,
                         seconds=took)
    reset_counts()
    tok, took = par_all_features(lines[:PAR_LINES], None)
    ref["all_features"] = dict(merges=tok.merge_history,
                               launches=launch_counts(), seconds=took)
    del tok
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r]) as f:
                fail(f"gloo rank {r} exited {p.returncode}:\n"
                     f"{f.read()[-3000:]}")
    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f))
    need = {"base": ("merge_loop", "pairwise_min_best"),
            "enhanced": ("enhanced_loop",),
            "all_features": ("enhanced_loop_dense", "pairwise_min_best")}
    for what, kernels in need.items():
        hist = [[list(m) for m in rk[what]["merges"]] for rk in ranks]
        single = [list(m) for m in ref[what]["merges"]]
        if not len(single) > 0:
            fail(f"parallel (b) {what}: the single process merged nothing")
        if any(h != single for h in hist):
            fail(f"parallel (b) {what}: the ranks' merges "
                 f"({[len(h) for h in hist]}) differ from each other or "
                 f"from one process's ({len(single)})")
        for rk in ranks:
            for k in kernels:
                if rk[what]["launches"][k] <= 0:
                    fail(f"parallel (b) {what}: rank {rk['rank']} never "
                         f"launched {k}")
    if any(rk["all_features"]["path"] != "v3" for rk in ranks):
        fail(f"parallel (b): the all-features run took "
             f"{[rk['all_features']['path'] for rk in ranks]}, not v3")
    res["two_ranks"] = dict(
        seconds=ranks_s,
        ranks=[{w: {k: v for k, v in rk[w].items() if k != "merges"}
                for w in need} for rk in ranks],
        merges={w: len(ref[w]["merges"]) for w in need})
    res["world_one"] = {w: {k: v for k, v in ref[w].items() if k != "merges"}
                        for w in need}
    print(f"parallel (b) two gloo ranks on the card, {ranks_s:.1f} s: "
          f"merges equal each other's and one process's "
          f"({json.dumps(res['two_ranks']['merges'])}); all-features path "
          f"v3 (K2 hashed, D = 2); ranks {json.dumps(res['two_ranks']['ranks'])}",
          flush=True)
    print(f"parallel (d) bench_scaling at a world of one: base "
          f"{ref['base']['steps_per_s']:.1f} steps/s, enhanced "
          f"{ref['enhanced']['steps_per_s']:.1f} merges/s; single process "
          f"{json.dumps(res['world_one'])}", flush=True)

    # (e) the collectives' latency.
    one = torch.ones((1,), dtype=torch.int32, device="cuda")
    res["nccl_all_reduce_us"] = collective_us(lambda: dist.all_reduce(one))
    res["gloo_all_reduce_us"] = [rk["gloo_all_reduce_us"] for rk in ranks]
    print(f"parallel (e) one int32 all_reduce: NCCL at a world of one "
          f"{res['nccl_all_reduce_us']:.2f} us, gloo at a world of two "
          f"(staged through the host) {res['gloo_all_reduce_us']} us "
          f"(median of {COLLECTIVE_REPS}, host clock)", flush=True)
    dist.destroy_process_group()
    return res


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    try:
        from hyptokenizer_tpu_torch.ops.cuda import _build
        from hyptokenizer_tpu_torch.ops.cuda import enhanced_loop as K12
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
    cfg = tok.enh_config
    computed = {"enhanced_loop": {"smem": dataclasses.asdict(
        K12.smem_plan(cfg.queue_size, cfg.merge_batch))}}
    print(f"K1 segment: {k1['segment_merges']} merges in "
          f"{k1['segment_steps']} steps, {k1['ms']:.3f} ms on the card, "
          f"plain {k1['plain_ms']:.1f} ms, max_abs_err {k1['max_abs_err']}; "
          f"step floor {k1['floor_us_per_step']:.3f} us (queues resident: "
          f"{computed['enhanced_loop']['smem']['resident']}); one full-size "
          f"sync "
          f"{k1['sync_ms']:.1f} ms",
          flush=True)
    rs = check_replay_select(tok, lines)
    rs["launches"] = main["replay_select_launches"]
    if rs["launches"]:
        fail(f"the main path launched R1 {rs['launches']} times; its "
             f"replay is R2")
    print(f"replay_select at {rs['slots']} slots ({rs['matches']} "
          f"matches, {rs['rounds']} rounds): round {rs['ms']:.4f} ms, take "
          f"{rs['take_ms']:.4f} ms on the card; bound {rs['bound_ms']:.4f} / "
          f"{rs['bound_take_ms']:.4f} ms ({rs['bound_by']}); plain "
          f"{rs['plain_ms']:.3f} / {rs['plain_take_ms']:.3f} ms; "
          f"torch.cummax alone {rs['library_ms']:.3f} ms; launches on the "
          f"main path {rs['launches']}", flush=True)
    rp = check_replay_pass(tok, lines)
    rp["launches"] = main["launches"]["replay_pass"]
    print_replay_pass("the flagship's first window", rp)
    print(f"replay_pass launches on the main path {rp['launches']}",
          flush=True)
    s1 = check_sync_score(tok)
    s1["launches"] = main["launches"]["sync_score"]
    print(f"sync_score on the trained table ({s1['rows']} rows, "
          f"{s1['candidates']} candidates, {s1['samples']} samples): "
          f"{s1['ms']:.4f} ms a call, kernel {s1['kernel_ms']:.4f} ms on the "
          f"card; bound {s1['bound_ms']:.4f} ms ({s1['bound_by']}); plain "
          f"{s1['plain_ms']:.3f} ms; score gap {s1['score_gap']:.3g} "
          f"({s1['score_gap_over_tol']:.3g} of its tolerance); launches on "
          f"the main path {s1['launches']}", flush=True)
    c1 = {"flagship": check_curvature_step(tok),
          "launches": main["launches"]["curvature_step"]}
    del tok

    tok, start, alls = main_path_all(lines)
    for name, n in alls["launches"].items():
        if n <= 0:
            fail(f"the all-features path never launched kernel {name}")
    print(f"all-features: ctor_s {alls['ctor_s']:.3f} "
          f"train_s {alls['train_s']:.3f} merges {alls['merges']} "
          f"merges_per_s {alls['merges_per_s']:.1f} phase {alls['phase']} "
          f"curvature {alls['curvature']:.6f} "
          f"after_load {alls['after_load_merges']} merges in "
          f"{alls['after_load_s']:.3f} s "
          f"launches {json.dumps(alls['launches'])} "
          f"(K1 {alls['corpus_only_launches']}) syncs {alls['chunk_syncs']} "
          f"chunk_seconds {alls['chunk_seconds']}", flush=True)

    if alls["replay_select_launches"]:
        fail(f"the all-features path launched R1 "
             f"{alls['replay_select_launches']} times; its replay is R2")
    rp["all_features"] = check_replay_pass_all(tok, start, alls)
    rp["launches_all_features"] = alls["launches"]["replay_pass"]
    print_replay_pass(
        f"all-features sync {rp['all_features']['sync']} of "
        f"{rp['all_features']['syncs']} ({rp['all_features']['policy']} "
        f"policy)", rp["all_features"])
    print(f"replay_pass launches: main path {rp['launches']}, all-features "
          f"path {rp['launches_all_features']}", flush=True)
    c1["all_features"] = check_curvature_step(tok)
    c1["launches_all_features"] = alls["launches"]["curvature_step"]
    for path, rec in (("flagship", c1["flagship"]),
                      ("all-features", c1["all_features"])):
        print(f"curvature_step on the {path} state ({rec['merges']} merges, "
              f"{rec['rows_gathered']} rows gathered, best_dist poisoned "
              f"{rec['poisoned']}): {rec['ms']:.4f} ms a step, kernels "
              f"{rec['kernel_ms']:.4f} ms on the card; bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); plain "
              f"{rec['plain_ms']:.3f} ms; max relative error "
              f"{rec['max_rel_err']:.3g}", flush=True)
    print(f"curvature_step launches: main path {c1['launches']}, "
          f"all-features path {c1['launches_all_features']}", flush=True)
    k2 = check_k2(tok, start)
    k2["launches"] = alls["launches"]["enhanced_loop_dense"]
    s1["launches_all_features"] = alls["launches"]["sync_score"]
    print(f"K2 lockstep: {k2['lockstep']} over {k2['lockstep_merges']} "
          f"merges in {k2['lockstep_steps']} steps, reorders "
          f"{k2['reorders']} dist_ties {k2['dist_ties']} partner_ties "
          f"{k2['partner_ties']} row_err_over_tol "
          f"{k2['row_err_over_tol']:.3g} gram_gap_over_bound "
          f"{k2['gram_gap_over_bound']:.3g}; "
          f"segment of {k2['segment_merges']} merges in "
          f"{k2['segment_steps']} steps: {k2['ms']:.3f} ms on the card "
          f"({k2['us_per_step']:.3f} us per step), "
          f"plain {k2['plain_ms']:.1f} ms, bound {k2['bound_ms']:.6f} ms "
          f"({k2['bound_by']}), max_abs_err {k2['max_abs_err']}",
          flush=True)
    k2["depth"] = k2d = check_k2_depth(tok)
    print(f"K2 at depth: segment of {k2d['segment_merges']} merges in "
          f"{k2d['segment_steps']} steps from {k2d['rows']} rows: "
          f"{k2d['ms']:.3f} ms ({k2d['us_per_step']:.3f} us per step), "
          f"bound {k2d['bound_ms']:.6f} ms ({k2d['bound_by']}); lockstep "
          f"{k2d['lockstep']} over {k2d['lockstep_merges']} merges in "
          f"{k2d['lockstep_steps']} steps, reorders {k2d['reorders']} "
          f"dist_ties {k2d['dist_ties']} partner_ties "
          f"{k2d['partner_ties']} row_err_over_tol "
          f"{k2d['row_err_over_tol']:.3g} gram_gap_over_bound "
          f"{k2d['gram_gap_over_bound']:.3g}", flush=True)
    k2["hashed"] = k2h = check_k2_hashed(tok)
    print(f"K2 hashed (n_buckets {k2h['n_buckets']}) at {k2h['rows']} rows: "
          f"lockstep {k2h['lockstep']} over {k2h['lockstep_merges']} merges "
          f"in {k2h['lockstep_steps']} steps (reorders {k2h['reorders']}, "
          f"row_err_over_tol {k2h['row_err_over_tol']:.3g}); segment of "
          f"{k2h['segment_merges']} merges in {k2h['segment_steps']} steps: "
          f"hashed {k2h['ms']:.3f} ms ({k2h['us_per_step']:.3f} us per "
          f"step), lexicographic {k2h['lex_ms']:.3f} ms "
          f"({k2h['lex_us_per_step']:.3f} us per step), same merges "
          f"{k2h['same_merges_as_lex']}, pairs dropped "
          f"{k2h['pairs_dropped']}", flush=True)
    k3, computed["pairwise_min_best"] = check_k3(
        int(start.base.vocab_size))
    k3["launches"] = alls["launches"]["pairwise_min_best"]
    print(f"K3 at {k3['rows']} active rows: {k3['ms']:.3f} ms on the card, "
          f"plain {k3['plain_ms']:.1f} ms, bound {k3['bound_ms']:.3f} ms "
          f"({k3['bound_by']}; "
          f"{computed['pairwise_min_best']['bound_fp32_cuda_ms']:.3f} ms at "
          f"the fp32 rate), max_abs_err {k3['max_abs_err']}, gram_err_fp64 "
          f"{k3['gram_err_fp64']:.3g}, ties {k3['ties']}; at the "
          f"constructors' {k3['ctor_rows']} and {k3['dist_ctor_rows']} rows "
          f"{k3['ctor_ms']:.4f} and {k3['dist_ctor_ms']:.4f} ms, "
          f"max_abs_err {k3['ctor_max_abs_err']} and "
          f"{k3['dist_ctor_max_abs_err']}, ties {k3['ctor_ties']} and "
          f"{k3['dist_ctor_ties']}", flush=True)
    del tok, start

    tok, trained, dist = main_path_distance(lines)
    for name, n in dist["launches"].items():
        if n <= 0:
            fail(f"the distance-only path never launched kernel {name}")
    print(f"distance-only: ctor_s {dist['ctor_s']:.3f} "
          f"train_s {dist['train_s']:.3f} steps {dist['steps']} "
          f"merges {dist['merges']} vocab {dist['vocab']} "
          f"longest token {dist['max_len']} "
          f"steps_per_s {dist['steps_per_s']} "
          f"thresholds {dist['thresholds']} "
          f"controller {json.dumps(dist['startup'])} "
          f"after_load {dist['after_load_merges']} merges in "
          f"{dist['after_load_s']:.3f} s "
          f"launches {json.dumps(dist['launches'])}", flush=True)
    k4 = check_k4(trained, tok.config)
    k4["launches"] = dist["launches"]["merge_loop"]
    k3["launches"] += dist["launches"]["pairwise_min_best"]
    k3["launches_by_path"] = {
        "all_features": alls["launches"]["pairwise_min_best"],
        "distance_only": dist["launches"]["pairwise_min_best"]}
    print(f"K4 lockstep: {k4['lockstep']} over {k4['lockstep_merges']} "
          f"merges in {k4['lockstep_steps']} steps, pair_ties "
          f"{k4['pair_ties']} partner_ties {k4['partner_ties']} "
          f"row_err_over_tol {k4['row_err_over_tol']:.3g} "
          f"gram_gap_over_bound {k4['gram_gap_over_bound']:.3g}; "
          f"chunk check (512 rows, d=100): {k4['chunk_check']} over "
          f"{k4['chunk_check_merges']} merges ({k4['chunk_check_ties']}); "
          f"{k4['chunk_steps']}-step chunk of {k4['chunk_merges']} merges "
          f"at mean vocab {k4['mean_vocab']:.0f}: {k4['ms']:.3f} ms on the "
          f"card ({k4['us_per_step']:.3f} us per step, grid {k4['grid']}), "
          f"plain {k4['plain_ms']:.1f} ms, bound {k4['bound_ms']:.4f} ms "
          f"({k4['bound_us_per_step']:.3f} us per step, {k4['bound_by']}), "
          f"max_abs_err {k4['max_abs_err']}; step floor "
          f"{k4['floor_us_per_step']:.3f} us", flush=True)
    del tok, trained
    k4["depth"] = k4d = check_k4_depth()
    print(f"K4 at depth: {k4d['chunk_steps']}-step chunk of "
          f"{k4d['chunk_merges']} merges from {k4d['rows']} rows (mean "
          f"vocab {k4d['mean_vocab']:.0f}): {k4d['ms']:.3f} ms "
          f"({k4d['us_per_step']:.3f} us per step), step floor "
          f"{k4d['floor_us_per_step']:.3f} us, bound {k4d['bound_ms']:.4f} "
          f"ms ({k4d['bound_by']}); lockstep {k4d['lockstep']} over "
          f"{k4d['lockstep_merges']} merges in {k4d['lockstep_steps']} "
          f"steps, pair_ties {k4d['pair_ties']} partner_ties "
          f"{k4d['partner_ties']} row_err_over_tol "
          f"{k4d['row_err_over_tol']:.3g} gram_gap_over_bound "
          f"{k4d['gram_gap_over_bound']:.3g}", flush=True)
    head, diag, rec, depth, bench_s = bench_phase(lines)
    print(json.dumps(head), flush=True)
    for ln in diag:
        print(ln, flush=True)
    enh, allf = rec["enhanced"], rec["allfeatures"]
    print(f"bench: wall_s {bench_s:.1f} corpus-only {enh['merges']} merges "
          f"(vocab {enh['vocab']}, stop {enh['stop']}), all-features "
          f"{allf['merges']} merges (vocab {allf['vocab']}, stop "
          f"{allf['stop']}, curvature {allf['curvature']:.6f}), "
          f"distance-only {rec['distance_only']['steps']} steps; full "
          f"depth {json.dumps(depth)}", flush=True)
    k1["full_depth"] = depth["enhanced"]["enhanced_loop"]
    k2["full_depth"] = depth["allfeatures"]["enhanced_loop_dense"]
    k3["full_depth"] = {
        "all_features": depth["allfeatures"]["pairwise_min_best"],
        "distance_only": depth["distance_only"]["pairwise_min_best"]}
    k4["full_depth"] = depth["distance_only"]["merge_loop"]
    for k in (k1, k2, k3, k4):
        fd = k["full_depth"]
        k["launches_full_depth"] = (fd["launches"] if "launches" in fd else
                                    sum(v["launches"] for v in fd.values()))
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        cli = cli_phase(work, lines)
        cli_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mod = models_phase(work)
        models_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        par = parallel_phase(work, lines)
        par_s = time.perf_counter() - t0
    q, fl, rs, b = (cli["quickstart"], cli["flagship"], cli["resume"],
                    cli["train_tokenizer"])
    cli_kernels = {path: rec["kernels"] for path, rec in cli.items()
                   if "kernels" in rec}
    print(f"CLI phase {cli_s:.1f} s: Quick start {q['merges']} merges "
          f"(vocab {q['vocab']}, phase {q['phase']}, curvature "
          f"{q['curvature']:.6f}) in {q['wall_s']:.2f} s: pretraining "
          f"{q['pretrain_steps']} steps {q['pretrain_s']:.3f} s (loss "
          f"{q['pretrain_loss'][0]:.4f} -> {q['pretrain_loss'][1]:.4f}), "
          f"training {q['train_s']:.3f} s, supervision "
          f"{q['supervision_s']:.3f} s; flagship CLI {fl['merges']} merges "
          f"(vocab {fl['vocab']}, stop {fl['stop']}) in {fl['wall_s']:.2f} "
          f"s; resume exact over {rs['merges']} merges (checkpoint at "
          f"{rs['checkpoint_at']}, curvature {rs['curvature']:.6f}, "
          f"processes {json.dumps(rs['process_s'])}); train_tokenizer "
          f"{b['merges']} merges in {b['steps']} steps, {b['wall_s']:.2f} s, "
          f"{b['vocab_bytes']} vocabulary bytes (longest {b['longest']}); "
          f"kernels {json.dumps(cli_kernels)}", flush=True)
    for k, name in ((k1, "enhanced_loop"), (k2, "enhanced_loop_dense"),
                    (k3, "pairwise_min_best"), (k4, "merge_loop")):
        k["launches_cli"] = {path: rec["launches"][name]
                             for path, rec in cli.items()
                             if name in rec.get("launches", {})}
    k3["launches_models"] = {path: rec["k3_launches"]
                             for path, rec in mod.items()
                             if "k3_launches" in rec}
    print(f"models phase {models_s:.1f} s: train_nlp_tasks "
          f"{mod['nlp']['wall_s']:.2f} s, train_retrieval "
          f"{mod['retrieval']['wall_s']:.2f} s, benchmark_efficiency "
          f"{mod['benchmark_efficiency']['wall_s']:.2f} s, "
          f"compare_tokenizers {mod['compare_tokenizers']['wall_s']:.2f} s; "
          f"K3 launches {json.dumps(k3['launches_models'])}", flush=True)
    print(f"parallel phase {par_s:.1f} s", flush=True)
    fl_mesh = par["flagship_mesh"]["launches"]
    for k, name in ((k1, "enhanced_loop"), (k2, "enhanced_loop_dense"),
                    (k3, "pairwise_min_best"), (k4, "merge_loop")):
        k["launches_parallel"] = {
            "flagship_mesh": fl_mesh.get(name, 0),
            "rank0": {w: rec["launches"][name] for w, rec in
                      par["two_ranks"]["ranks"][0].items()},
            "world_one": {w: rec["launches"][name] for w, rec in
                          par["world_one"].items()}}
    k1["flagship_mesh"] = par["flagship_mesh"]["kernels"].get(
        "enhanced_loop")
    print(json.dumps({"collectives_us": {
        "nccl_world_one": par["nccl_all_reduce_us"],
        "gloo_world_two": par["gloo_all_reduce_us"]}}), flush=True)
    print(f"wall_s {time.perf_counter() - t_all:.1f}", flush=True)
    print(json.dumps({"computed": computed}), flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k4, rs, rp, s1, c1]}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if "--parallel-rank" in sys.argv:
        # A rank of the parallel phase (parallel_phase starts two).
        if HERE not in sys.path:
            sys.path.insert(0, HERE)
        argv = sys.argv
        parallel_child(int(argv[argv.index("--parallel-rank") + 1]),
                       argv[argv.index("--coordinator") + 1],
                       argv[argv.index("--out") + 1])
    else:
        main()
