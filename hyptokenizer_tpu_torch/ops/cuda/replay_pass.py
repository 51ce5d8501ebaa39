"""The corpus sync's replay on the card: every pass of match, selection,
substitution and compaction of one merge window, to its fixpoint, in one
cooperative launch with no host read (kernel R2).

Replaces no ``pl.pallas_call``: the JAX package replays a window with XLA
ops in ``batch_rank_replay`` and ``batch_fixpoint_replay``
(``hyptokenizer_tpu/tokenizer/scoring.py`` :569 and :502). The kernel is
``csrc/replay_pass.cu`` (see the note at its top for its design and its
bound); its plain version is the pass loop ``tokenizer/scoring._replay``.

:func:`replay` launches the kernel for CUDA tensors, or raises; it never
falls back (``scoring`` takes the plain loop for CPU tensors).
:func:`launch_plan` sizes the grid and the blocks' slices from the shapes
alone. ``launches`` counts kernel launches; while a profiler records, each
launch also counts ``replay.kernel_launches`` (``utils/metrics.py``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from hyptokenizer_tpu_torch.ops.cuda import _build
from hyptokenizer_tpu_torch.utils import metrics

SOURCE = "replay_pass"
THREADS = 1024          # threads a block (csrc kThreads)
RECORD = 16             # ints a block posts before each grid barrier
LOCAL_TABLE = 512       # rule-table slots a block holds itself (csrc
                        # kLocalTable): windows of up to 128 rules
MAX_N = 2**31 - 2**20   # int32 slot indices with room for the last slice

launches = 0            # kernel launches since the last reset_launches()
# (device index, stream) -> scratch: the grid barrier's word (zero before
# the first launch; each launch leaves it as it found it), the blocks'
# records, the rule table and the counts. Launches that share one are
# ordered by their stream.
_SCRATCH: dict = {}
_DEVICE: dict = {}      # device index -> (SMs, shared memory a block may take)
_PER_SM: dict = {}      # (device index, shared bytes) -> blocks an SM holds


class Plan(NamedTuple):
    """A launch: ``blocks`` blocks of ``THREADS``, each owning ``slice``
    input slots; the blocks' state in ``smem_bytes`` of dynamic shared
    memory (``shared``) or in a global buffer of ``work_words`` ints."""
    blocks: int
    slice: int
    shared: bool
    smem_bytes: int
    work_words: int


def reset_launches() -> None:
    global launches
    launches = 0


def state_words(slice_: int) -> int:
    """Ints of one block's state (csrc ``state_words``): a token and a rule
    id a slot, and five bit or scan words every 32 slots."""
    return 2 * slice_ + 5 * (slice_ // 32)


def _slice(n: int, blocks: int) -> int:
    per_block = -(-n // blocks)
    return max(32, -(-per_block // 32) * 32)


def launch_plan(n: int, sm_count: int, smem_limit: int,
                per_sm: Callable[[int], int]) -> Plan:
    """The grid for a corpus of ``n`` slots on a card of ``sm_count`` SMs
    whose blocks may take ``smem_limit`` bytes of dynamic shared memory;
    ``per_sm(bytes)`` is how many blocks of that much shared memory an SM
    holds (the occupancy query). The blocks keep their state in shared
    memory when a slice of ``n`` over one block an SM fits, else in
    global memory."""
    s = _slice(n, sm_count)
    if 4 * state_words(s) <= smem_limit:
        blocks = sm_count * per_sm(4 * state_words(s))
        s = _slice(n, blocks)
        return Plan(blocks, s, True, 4 * state_words(s), 0)
    blocks = sm_count * per_sm(0)
    s = _slice(n, blocks)
    return Plan(blocks, s, False, 0, blocks * state_words(s))


def table_capacity(merge_rows: int) -> int:
    """Slots of the rule table: a power of two, four or more a rule."""
    cap = 32
    while cap < 4 * merge_rows:
        cap *= 2
    return cap


def _launcher():
    lib = _build.load(SOURCE)
    if lib.replay_pass_launch.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.replay_pass_launch.argtypes = ([ptr, ptr, i, ptr, i, ptr, ptr]
                                           + [i] * 6 + [ptr, i, ptr, ptr, i]
                                           + [ptr] * 4)
        lib.replay_pass_launch.restype = i
        for name in ("replay_pass_threads", "replay_pass_sm_count",
                     "replay_pass_smem_limit"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.replay_pass_state_words.argtypes = [i]
        lib.replay_pass_state_words.restype = i
        lib.replay_pass_blocks_per_sm.argtypes = [i]
        lib.replay_pass_blocks_per_sm.restype = i
        if lib.replay_pass_threads() != THREADS or any(
                lib.replay_pass_state_words(s) != state_words(s)
                for s in (32, 4096, 21984)):
            raise RuntimeError("replay_pass: the library's block or state "
                               "layout differs from the wrapper's")
    return lib


def _plan(lib, dev: torch.device, n: int) -> Plan:
    if dev.index not in _DEVICE:
        limit = lib.replay_pass_smem_limit()
        sms = lib.replay_pass_sm_count()
        if limit < 0 or sms < 1:
            raise RuntimeError(f"replay_pass: device query failed "
                               f"(CUDA error {-limit})")
        _DEVICE[dev.index] = (sms, limit)
    sms, limit = _DEVICE[dev.index]

    def per_sm(smem: int) -> int:
        key = (dev.index, smem)
        if key not in _PER_SM:
            k = lib.replay_pass_blocks_per_sm(smem)
            if k < 1:
                raise RuntimeError(f"replay_pass: no block of {smem} bytes "
                                   f"fits an SM (CUDA error {-k})")
            _PER_SM[key] = k
        return _PER_SM[key]

    return launch_plan(n, sms, limit, per_sm)


def _scratch(dev: torch.device, stream: int, plan: Plan, cap: int) -> dict:
    key = (dev.index, stream)
    s = _SCRATCH.get(key)
    if s is None:
        s = {"arrived": torch.zeros((1,), dtype=torch.int32, device=dev),
             "stats": torch.zeros((2,), dtype=torch.int32, device=dev),
             "posts": torch.empty((0,), dtype=torch.int32, device=dev),
             "keys": torch.empty((0,), dtype=torch.int64, device=dev),
             "vals": torch.empty((0,), dtype=torch.int32, device=dev),
             "work": torch.empty((0,), dtype=torch.int32, device=dev)}
        _SCRATCH[key] = s
    if s["posts"].numel() < 2 * plan.blocks * RECORD:
        s["posts"] = torch.empty((2 * plan.blocks * RECORD,),
                                 dtype=torch.int32, device=dev)
    if s["keys"].numel() < cap:
        s["keys"] = torch.empty((cap,), dtype=torch.int64, device=dev)
        s["vals"] = torch.empty((cap,), dtype=torch.int32, device=dev)
    if s["work"].numel() < plan.work_words:
        s["work"] = torch.empty((plan.work_words,), dtype=torch.int32,
                                device=dev)
    return s


def _launched(rc: int) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"replay_pass kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    metrics.count("replay.kernel_launches")


def replay(corpus: torch.Tensor, merges: torch.Tensor, start, end,
           n_init: int, *, rank: bool) -> tuple:
    """``corpus`` (n,) int32 with merges ``[start, end)`` of ``merges``
    (R, 2) int32 replayed to the window's fixpoint, merge r making id
    ``n_init + r``: the rank replay's matching rounds (``rank``) or the
    fixpoint replay's leftmost take, in one launch. ``start`` and ``end``
    are ints or one-element int32 tensors on the card, read there (no
    host synchronisation). Returns a fresh corpus and a (2,) int32 tensor
    on the card, the passes and matching rounds (0, 0 for an empty window,
    whose corpus is the input as it is), which the next launch on the
    stream overwrites. The input is never written."""
    _build.check("corpus", corpus, torch.int32, (None,))
    _build.check("merges", merges, torch.int32, (None, 2))
    bounds = []
    for name, v in (("start", start), ("end", end)):
        if isinstance(v, torch.Tensor):
            _build.check(name, v, torch.int32, None)
            bounds.append((name, v))
        elif not -2**31 <= int(v) < 2**31:
            raise ValueError(f"{name}: {v} is not an int32")
    dev = corpus.device
    _build.check_devices([("corpus", corpus), ("merges", merges)] + bounds,
                         dev)
    n = corpus.shape[0]
    if n > MAX_N:
        raise ValueError(f"corpus: {n} slots, at most {MAX_N}")
    lib = _launcher()
    cap = table_capacity(merges.shape[0])
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(corpus)

    def ptr(v):
        return v.data_ptr() if isinstance(v, torch.Tensor) else None

    def val(v):
        return 0 if isinstance(v, torch.Tensor) else int(v)

    with torch.cuda.device(dev):
        plan = _plan(lib, dev, n)
        s = _scratch(dev, stream, plan, cap)
        rc = lib.replay_pass_launch(
            corpus.data_ptr(), out.data_ptr(), n, merges.data_ptr(),
            merges.shape[0], ptr(start), ptr(end), val(start), val(end),
            int(n_init), int(rank), plan.blocks, plan.slice,
            None if plan.shared else s["work"].data_ptr(), plan.smem_bytes,
            s["keys"].data_ptr(), s["vals"].data_ptr(), cap,
            s["posts"].data_ptr(), s["arrived"].data_ptr(),
            s["stats"].data_ptr(), stream)
    _launched(rc)
    return out, s["stats"]
