"""Kernels K1 and K2 (the scored merge segment) and the chunk driver around
them.

Replaces ``hyptokenizer_tpu/ops/pallas/enhanced_loop.py``: the Pallas
``_kernel`` (:156) in its two configurations, ``_run_segment`` (:623) and
``_run_chunk_fused`` (:790). Both kernels are ``csrc/enhanced_loop.cu`` (see
the note at its top for their design and bounds): K1 runs the corpus-only
configuration (``use_dense_channel=False`` with a corpus), K2 every
configuration with the dense channel (``use_dense_channel`` or no corpus
feature). Their plain version is ``tokenizer/enhanced_state.enhanced_step``,
looped to the same halt conditions by :func:`run_segment_plain`.

:func:`run_segment` launches the configuration's kernel for a state on the
card and runs the plain version for a state on the CPU; for a CUDA state it
launches or raises, never falls back. ``launches`` counts K1's launches,
``dense_launches`` K2's. K1 is one thread block that keeps the phase queues
in shared memory for the launch (:func:`smem_plan`); K2 is a cooperative
grid (:func:`dense_grid_size`) whose block 0 runs the steps and whose
blocks fold their own rows. K2 reads the pair table in the layout
``config.pair_table_hashed`` names: one lexicographically sorted table, or
the v3 sharded sync's hash partitions (``parallel/sharded.py``).

:func:`run_chunk` is the segment relaunch loop: one corpus sync, then
segments that halt at every adaptive-curvature event, with the curvature
Adam step in PyTorch between them. It keeps the JAX loop's bounds (merge
budget ``n_steps``, step budget ``n_steps + 1024``) and raises if a
segment leaves the step counter unchanged without halting, so a kernel
that fails to advance cannot loop forever.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.tokenizer import enhanced_state as E
from hyptokenizer_tpu_torch.tokenizer import scoring
from hyptokenizer_tpu_torch.utils import metrics

SOURCE = "enhanced_loop"
MAX_BATCH = 8192        # the batch's arrays fill shared memory beyond this
SEGMENT_STEPS = 1024    # steps per launch (the JAX package's segment_grid)
NO_CURVATURE_STOP = 1 << 30
SMEM_LIMIT = 232_448    # shared memory a block may use on sm_90 (227 KB)
SMEM_RESERVE = 22_528   # kept for K1's static shared memory (pair tables)
PHASE_ENTRY_BYTES = 16  # q_i, q_j, q_dist and q_score of one queue entry
MERGE_WARPS = 16        # K1's merge warps (csrc kMergeWarps)
MIN_RING = 512          # fewest merges K1's ring holds

launches = 0            # K1 launches since the last reset_launches()
dense_launches = 0      # K2 launches since the last reset_launches()
_GRID: dict = {}        # (device index, merge_batch) -> K2's grid blocks


def reset_launches() -> None:
    global launches, dense_launches
    launches = 0
    dense_launches = 0


def uses_dense(config) -> bool:
    """Whether a configuration runs the dense channel (kernel K2)."""
    return config.use_dense_channel or not config.needs_corpus


@dataclasses.dataclass(frozen=True)
class SmemPlan:
    """What K1 keeps in dynamic shared memory for a launch."""

    ring: int         # merges the ring holds (pair and distance, 12 B each)
    resident: int     # phase queues held on chip (0-3), from the launch's
                      # phase on; the others are read in global memory
    bytes: int        # dynamic shared memory per block


def smem_plan(queue_size: int, merge_batch: int) -> SmemPlan:
    """The shared-memory plan of K1: the ring of posted merges (at least
    two batches and ``MIN_RING`` merges, in whole rounds of its
    ``MERGE_WARPS`` merge warps), then, 8-byte aligned, as many whole phase
    queues (``PHASE_ENTRY_BYTES`` per entry) as fit beside it. At the
    flagship's 4096 entries and batch 16 all three fit (196,608 B); what
    does not fit stays in global memory, so any ``queue_size`` and any
    ``merge_batch`` up to ``MAX_BATCH`` run."""
    nb = max(1, merge_batch)
    ring = -(-max(2 * nb, MIN_RING) // MERGE_WARPS) * MERGE_WARPS
    ring_bytes = -(-ring * 12 // 8) * 8
    room = max(SMEM_LIMIT - SMEM_RESERVE - ring_bytes, 0)
    per_phase = PHASE_ENTRY_BYTES * max(1, queue_size)
    resident = min(3, room // per_phase)
    return SmemPlan(ring=ring, resident=resident,
                    bytes=ring_bytes + resident * per_phase)


def _launcher(dense: bool):
    lib = _build.load(SOURCE)
    fn = lib.enhanced_loop_dense_launch if dense else lib.enhanced_loop_launch
    if fn.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        args = [ptr] * 14 + [i] * 9 + [f] * 3 + [i, i, f, i, f, i]
        if dense:
            args += [ptr] * 7 + [i] * 9 + [f] * 5 + [i] + [ptr] * 5
        else:
            args += [i, i]                   # resident phase queues, ring
        fn.argtypes = args + [ptr]
        fn.restype = ctypes.c_int
        lib.enhanced_loop_dense_grid.argtypes = [ctypes.c_int]
        lib.enhanced_loop_dense_grid.restype = ctypes.c_int
    return fn


def dense_grid_size(device: torch.device, config) -> int:
    """Blocks of K2's cooperative grid on ``device`` for the
    configuration's ``merge_batch``: the occupancy query times the SM
    count. Raises if the query fails."""
    nb = max(1, config.merge_batch)
    key = (device.index, nb)
    if key not in _GRID:
        _launcher(True)
        with torch.cuda.device(device):
            g = _build.load(SOURCE).enhanced_loop_dense_grid(nb)
        if g < 1:
            raise RuntimeError(f"enhanced_loop_dense: the occupancy query "
                               f"failed ({g})")
        _GRID[key] = g
    return _GRID[key]


def _halted(sc: dict, m_budget: int, s_budget: int, curv_stop: int) -> bool:
    return bool(sc["stopped"] or sc["needs_resync"]
                or sc["num_merges"] >= m_budget or sc["step"] >= s_budget
                or sc["num_merges"] >= curv_stop)


def run_segment_plain(st, config, m_budget: int, s_budget: int,
                      curv_stop: int, sampler,
                      n_steps: int = SEGMENT_STEPS):
    """The plain version of the kernel: ``enhanced_step`` looped until a
    halt condition holds or ``n_steps`` steps ran. The sampler is never
    drawn from inside a segment (it halts at curvature events)."""
    for _ in range(n_steps):
        if _halted(E.state_scalars(st), m_budget, s_budget, curv_stop):
            break
        st = E.enhanced_step(st, config, sampler)
    return st


def _check_tensors(obj, want: dict, prefix: str = "") -> None:
    for name, dtype in want.items():
        t = getattr(obj, name)
        if t.device.type != "cuda" or t.dtype != dtype or \
                not t.is_contiguous():
            raise ValueError(f"{prefix}{name}: need a contiguous {dtype} CUDA "
                             f"tensor, got {t.dtype} on {t.device}")


def _check_cuda_state(st, config) -> None:
    nb = max(1, config.merge_batch)
    dense = uses_dense(config)
    if nb > MAX_BATCH:
        raise ValueError(f"merge_batch {nb} > {MAX_BATCH}: the batch's "
                         "arrays would outgrow shared memory")
    want = {
        "emb": torch.float32, "lengths": torch.int32,
        "merges": torch.int32, "merge_dists": torch.float32,
    }
    if dense:
        want.update(best_dist=torch.float32, best_j=torch.int32)
    _check_tensors(st.base, want, "base.")
    want = {
        "byte_lengths": torch.int32, "has_vowel": torch.bool,
        "token_hash": torch.int32, "q_i": torch.int32, "q_j": torch.int32,
        "q_dist": torch.float32, "q_score": torch.float32,
        "hash_powers": torch.int32,
    }
    if dense:
        want.update(pair_keys=torch.int32, pair_counts=torch.int32,
                    morph_table=torch.int32, word_table=torch.int32,
                    coh_samples=torch.int32)
    _check_tensors(st, want)
    if st.q_i.shape != (3, config.queue_size):
        raise ValueError(f"queues of shape {tuple(st.q_i.shape)}, expected "
                         f"(3, {config.queue_size})")


def run_segment_cuda(st, config, m_budget: int, s_budget: int,
                     curv_stop: int, n_steps: int = SEGMENT_STEPS,
                     counts=None):
    """One launch of the configuration's kernel (K1, or K2 with the dense
    channel): up to ``n_steps`` steps, in place (span ``segment.launch``).
    ``counts``, two int32s on the card or None: K2 adds its dense merges
    and its empty-round threshold growths to them (K1 counts nothing)."""
    with metrics.span("segment.launch"):
        return _launch_segment(st, config, m_budget, s_budget, curv_stop,
                               n_steps, counts)


def _launch_segment(st, config, m_budget: int, s_budget: int,
                    curv_stop: int, n_steps: int, counts=None):
    global launches, dense_launches
    _check_cuda_state(st, config)
    dense = uses_dense(config)
    base = st.base
    dev = base.emb.device
    si = torch.cat([
        torch.stack([base.vocab_size, base.num_merges, base.step,
                     base.empty_rounds, base.stopped.int(), st.phase,
                     st.needs_resync.int(), st.corpus_synced]).int(),
        torch.tensor([m_budget, s_budget, curv_stop], dtype=torch.int32,
                     device=dev),
        st.q_valid_total.int(),
        torch.stack([st.morph_size, st.word_size, st.corpus_tokens,
                     st.max_pair_count]).int()]).contiguous()
    sf = torch.stack([base.threshold, base.curvature]).float().contiguous()
    b = config.base
    thr = config.phase_thresholds
    plan = smem_plan(config.queue_size, config.merge_batch)
    extra = [plan.resident, plan.ring]
    if dense:
        extra = [
            base.best_dist.data_ptr(), base.best_j.data_ptr(),
            st.pair_keys.data_ptr(), st.pair_counts.data_ptr(),
            st.morph_table.data_ptr(), st.word_table.data_ptr(),
            st.coh_samples.data_ptr(), st.pair_keys.shape[0],
            st.morph_table.shape[0], st.word_table.shape[0],
            st.coh_samples.shape[0], int(config.needs_corpus),
            int(config.use_frequency), int(config.use_compression),
            b.max_token_len, config.pair_table_hashed,
            *config.weights()]
        g = dense_grid_size(dev, config)
        part_v = torch.empty((g,), dtype=torch.float32, device=dev)
        part_i = torch.empty((g,), dtype=torch.int32, device=dev)
        # Block 0's event (4 ints) and the count of finished events.
        sync = torch.zeros((5,), dtype=torch.int32, device=dev)
        extra += [g, part_v.data_ptr(), part_i.data_ptr(), sync.data_ptr(),
                  sync[4:].data_ptr(),
                  None if counts is None else counts.data_ptr()]
    rc = _launcher(dense)(
        base.emb.data_ptr(), base.lengths.data_ptr(),
        st.byte_lengths.data_ptr(), st.has_vowel.data_ptr(),
        st.token_hash.data_ptr(), base.merges.data_ptr(),
        base.merge_dists.data_ptr(), st.q_i.data_ptr(), st.q_j.data_ptr(),
        st.q_dist.data_ptr(), st.q_score.data_ptr(),
        st.hash_powers.data_ptr(), si.data_ptr(), sf.data_ptr(),
        base.emb.shape[0], base.emb.shape[1], config.queue_size,
        max(1, config.merge_batch), n_steps, st.hash_powers.shape[1],
        int(config.use_hierarchical), config.phase2_step,
        config.phase3_step, thr[0], thr[1], thr[2],
        int(b.adaptive_threshold), b.threshold_growth_every,
        b.threshold_growth, b.empty_growth_after, b.empty_growth,
        b.empty_stop_after, *extra, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"enhanced_loop{'_dense' if dense else ''} kernel "
                           f"launch failed: CUDA error {rc}")
    if dense:
        dense_launches += 1
    else:
        launches += 1
    return dataclasses.replace(
        st, phase=si[5], needs_resync=si[6].bool(),
        base=dataclasses.replace(
            base, vocab_size=si[0], num_merges=si[1], step=si[2],
            empty_rounds=si[3], stopped=si[4].bool(), threshold=sf[0]))


def run_segment(st, config, m_budget: int, s_budget: int, curv_stop: int,
                sampler, n_steps: int = SEGMENT_STEPS, plain: bool = False,
                counts=None):
    """A segment on the state's own device: kernel K1 or K2 on the card,
    their plain version on the CPU, or everywhere when ``plain`` is asked
    for (the oracle of ``evals/selfcheck.py``). ``counts``: the kernel's
    (:func:`run_segment_cuda`); the plain version counts its own."""
    if plain or st.base.emb.device.type == "cpu":
        return run_segment_plain(st, config, m_budget, s_budget, curv_stop,
                                 sampler, n_steps)
    return run_segment_cuda(st, config, m_budget, s_budget, curv_stop,
                            n_steps, counts=counts)


def _segment_end(sc: dict, m_budget: int, s_budget: int,
                 curv_stop: int) -> str:
    """Why a segment ended, from the scalars after it: the first halt
    condition that holds, else ``cap`` (it ran all its steps)."""
    for reason, hit in (("stopped", sc["stopped"]),
                        ("resync", sc["needs_resync"]),
                        ("merges", sc["num_merges"] >= m_budget),
                        ("steps", sc["step"] >= s_budget),
                        ("curvature", sc["num_merges"] >= curv_stop)):
        if hit:
            return reason
    return "cap"


def run_chunk(st, config, n_steps: int, sampler,
              segment_steps: int = SEGMENT_STEPS, plain: bool = False,
              sync=None):
    """One sync, then segments until ``n_steps`` merges, a resync, a stop or
    the step budget. ``plain`` runs the plain version on any device;
    ``sync`` replaces ``enhanced_state.sync_corpus`` (the sharded syncs of
    ``parallel/sharded.py``, same arguments). Spans: ``sync`` (the sync and
    the scalars' read that waits for it), ``segment.wait`` (the scalars'
    read after each segment); counters ``segment.end.<reason>``
    (:func:`_segment_end`) and, while tracing, K2's ``merge.dense`` and
    ``threshold.empty_growth`` (the plain version counts its own in
    ``enhanced_step``; K1 counts neither)."""
    with metrics.span("sync"):
        st = (sync or E.sync_corpus)(st, config, sampler)
        sc = E.state_scalars(st)
    m_budget = sc["num_merges"] + n_steps
    s_budget = sc["step"] + n_steps + 1024
    freq = config.curvature_freq if config.use_adaptive_curvature else 0
    while not _halted(sc, m_budget, s_budget, NO_CURVATURE_STOP):
        if config.use_adaptive_curvature:
            st = E._maybe_update_curvature(st, config, sampler)
        curv_stop = ((int(st.curv_last) // freq + 1) * freq if freq > 0
                     else NO_CURVATURE_STOP)
        tracing = metrics.tracing()
        counts = None
        if tracing and uses_dense(config) and not plain and \
                st.base.emb.device.type == "cuda":
            counts = torch.zeros((2,), dtype=torch.int32,
                                 device=st.base.emb.device)
        st = run_segment(st, config, m_budget, s_budget, curv_stop, sampler,
                         segment_steps, plain, counts=counts)
        with metrics.span("segment.wait"):
            now = E.state_scalars(st)
        if tracing:
            metrics.count("segment.end." + _segment_end(
                now, m_budget, s_budget, curv_stop))
            if counts is not None:
                dense_merges, growths = counts.tolist()
                metrics.count("merge.dense", dense_merges)
                metrics.count("threshold.empty_growth", growths)
        if now["step"] == sc["step"] and not (now["stopped"]
                                              or now["needs_resync"]):
            raise RuntimeError(
                f"merge segment made no progress at step {now['step']} "
                f"(merges {now['num_merges']}): the kernel did not advance")
        sc = now
    return st


def segment_bytes(st, config, n_merges: int, dense_rows: int = 0) -> int:
    """Bytes a segment of ``n_merges`` merges must move, each input read
    once and each output written once, whatever the kernel reads again: the
    three phase queues read and their scores written back, the token
    features of two rows read per merge, and the new row, features and
    history written.

    With the dense channel, ``dense_rows`` is the active prefix at the
    segment's start: its rows' coordinates and lengths are read once, and
    ``best_dist``/``best_j`` over the final prefix are read and written
    back once. Without it (K1), the merged pairs' coordinates are read per
    merge."""
    k3 = 3 * config.queue_size
    d1 = st.base.emb.shape[1]
    queues = k3 * (4 + 4 + 4 + 4) + k3 * 4
    features = 4 + 4 + 8 + 1                      # len, bytes, hash, vowel
    per_merge_in = 2 * (features + (0 if dense_rows else d1 * 4))
    per_merge_out = d1 * 4 + features + 8 + 4     # + history pair, dist
    powers = 2 * scoring.MAX_HASH_LEN * 4
    dense = 0
    if dense_rows:
        v1 = dense_rows + n_merges
        dense = dense_rows * (d1 * 4 + 4) + v1 * 2 * (4 + 4)
    return (queues + powers + n_merges * (per_merge_in + per_merge_out)
            + dense)


def segment_bytes_rereading(st, config, n_merges: int,
                            fold_rows: int = 0) -> int:
    """The traffic of a kernel that keeps nothing on chip between steps,
    for the reader (not a bound): :func:`segment_bytes` of K1, plus, for
    ``fold_rows`` (the sum over the segment's steps of the rows below the
    post-batch vocabulary), each step's argmin reading their ``best_dist``
    and its fold reading their rows, lengths and ``best_dist``/``best_j``
    and writing ``best_dist``/``best_j``."""
    d1 = st.base.emb.shape[1]
    per_fold_row = 4 + d1 * 4 + 4 + 2 * (4 + 4)
    return segment_bytes(st, config, n_merges) + fold_rows * per_fold_row


def segment_ops(config, d1: int, n_merges: int, n_steps: int,
                dense_rows: int = 0) -> int:
    """Operations a segment needs on its data: per step a compare per entry
    of the phase's queue (the scan), per merge a compare per entry of the
    three queues (consumption) and about 12 FLOP per coordinate (dot,
    midpoint, projection). With the dense channel (``dense_rows`` active
    rows at the start), every step's argmin compares at least those rows,
    and the k-th merge's column is folded into each of its
    dense_rows + k rows: a d1-long dot (2 d1 FLOP) and an acosh (8)."""
    k = config.queue_size
    ops = n_steps * k * 2 + n_merges * (3 * k + 12 * d1)
    if dense_rows:
        rows = n_merges * dense_rows + n_merges * (n_merges - 1) // 2
        ops += n_steps * dense_rows + rows * (2 * d1 + 8)
    return ops
