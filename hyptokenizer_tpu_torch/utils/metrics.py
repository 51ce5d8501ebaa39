"""Observability: structured metrics, profiling traces, NaN debugging.

Port of ``hyptokenizer_tpu/utils/metrics.py``. ``MetricsWriter`` (a JSONL
metrics stream, the source of ``--metrics-path``) is copied, and ``span``
logs ``<name>_seconds`` as the JAX package's does (and traces, below).
The JAX-only parts have these counterparts:

- ``profile_trace`` is a ``torch.profiler`` window (CPU, and the card when
  there is one) that writes a Chrome trace, ``trace.json``, into
  ``log_dir``, and beside it ``spans.json``, the window's
  :func:`trace_snapshot`;
- ``enable_nan_checks`` turns on ``torch.autograd.set_detect_anomaly``
  (the embedding trainers' backward passes raise at the operation that made
  a NaN) and makes the tokenizers' ``optimize_merges`` check their state
  for non-finite values after each chunk (:func:`check_finite`), raising
  ``FloatingPointError``;
- ``compile_seconds`` and ``cache_hit_counts`` read the kernels' build
  (``ops/cuda/_build.py``): wall seconds spent in ``nvcc`` in this process,
  and the libraries found already built against those asked for.

Tracing. :class:`span` and :func:`count` mark the program's layers. They
trace only while a ``torch.profiler`` records (the profiler's own flag, a
plain bool): a span then opens ``record_function`` (the profiler's clock,
which the device's activity shares) and, once CUDA is initialised, records
a timing event at its entry and at its exit on the current stream, so that
its ``elapsed`` runs until the last kernel it enqueued has ended; a counter
then adds up. With no profiler recording, a span takes the host clock only
and a counter does nothing: no ``record_function``, no event, no read from
the device. :func:`trace_snapshot` gives the spans and counters of the most
recent profiler session, resolving the events when it is read.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)


class MetricsWriter:
    """Append-only JSONL metrics stream + in-memory history."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.history = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, metrics: Dict) -> None:
        record = {"time": time.time(), **metrics}
        self.history.append(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def summary(self) -> Dict:
        if not self.history:
            return {}
        last = self.history[-1]
        return {k: v for k, v in last.items() if k != "time"}


class _Trace:
    """What the spans and counters of the current (or last) profiler
    session recorded: per span its count, host seconds, elapsed seconds
    and the (entry, exit) event pairs not yet resolved; per counter its
    sum. ``on`` is whether the profiler recorded at the last look."""

    def __init__(self):
        self.on = False
        self.clear()

    def clear(self) -> None:
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}


_TRACE = _Trace()
_PROFILER = torch.autograd.profiler


def tracing() -> bool:
    """Whether a ``torch.profiler`` is recording. The first look (a span, a
    counter or this call) that finds one after a look that found none
    starts a new session's record; two sessions with no look between them
    share one."""
    on = _PROFILER._is_profiler_enabled
    if on != _TRACE.on:
        _TRACE.on = on
        if on:
            _TRACE.clear()
    return on


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, while tracing."""
    if tracing():
        _TRACE.counters[name] = _TRACE.counters.get(name, 0) + n


class span:
    """Timing span around a layer of the program; logs ``<name>_seconds``
    to ``metrics`` when one is given. ``host_s`` holds the host seconds
    once the span has closed. While tracing (:func:`tracing`) it is also a
    ``record_function`` and, with CUDA initialised, a pair of timing
    events on the current stream."""

    __slots__ = ("name", "metrics", "host_s", "_t0", "_rf", "_ev")

    def __init__(self, name: str, metrics: Optional[MetricsWriter] = None):
        self.name = name
        self.metrics = metrics
        self.host_s = 0.0
        self._rf = self._ev = None

    def __enter__(self) -> "span":
        if tracing():
            self._rf = _PROFILER.record_function(self.name)
            self._rf.__enter__()
            if torch.cuda.is_initialized():
                self._ev = torch.cuda.Event(enable_timing=True)
                self._ev.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.host_s = dt = time.perf_counter() - self._t0
        if self._rf is not None:
            rec = _TRACE.spans.setdefault(self.name, [0, 0.0, 0.0, []])
            rec[0] += 1
            rec[1] += dt
            if self._ev is None:
                rec[2] += dt
            else:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec[3].append((self._ev, end))
            self._rf.__exit__(*exc)
        logger.debug("%s took %.3fs", self.name, dt)
        if self.metrics is not None:
            self.metrics.log({f"{self.name}_seconds": dt})
        return False


def trace_snapshot() -> Dict[str, dict]:
    """``{"spans": {name: {"count", "host_s", "elapsed_s"}}, "counters":
    {name: n}}`` of the most recent profiler session. ``elapsed_s`` is the
    event time from each span's entry to the end of the work it enqueued
    (the host time where no event was recorded); reading it waits for
    that work."""
    spans = {}
    for name, rec in _TRACE.spans.items():
        for start, end in rec[3]:
            end.synchronize()
            rec[2] += start.elapsed_time(end) * 1e-3
        rec[3].clear()
        spans[name] = {"count": rec[0], "host_s": rec[1],
                       "elapsed_s": rec[2]}
    return {"spans": spans, "counters": dict(_TRACE.counters)}


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """``torch.profiler`` trace of the enclosed work, written to
    ``log_dir/trace.json`` (open in Perfetto or ``chrome://tracing``), the
    program's spans among its events; and the window's
    :func:`trace_snapshot`, written to ``log_dir/spans.json``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    tracing()   # a look with none recording: the window gets its own record
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(trace_snapshot(), f, indent=1)


_NAN_CHECKS = {"on": False}


def enable_nan_checks(enable: bool = True) -> None:
    """Debug-NaN mode for the process: autograd anomaly detection, and a
    finiteness check of the merge state after every training chunk."""
    torch.autograd.set_detect_anomaly(enable)
    _NAN_CHECKS["on"] = bool(enable)


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS["on"]


def check_finite(state, where: str) -> None:
    """Raise ``FloatingPointError`` when the merge state (a ``MergeState``
    or an ``EnhancedState``) holds a non-finite value where none may be:
    an active embedding row, the curvature, the threshold, or a NaN among
    the candidate distances and scores (whose empty slots are +-inf)."""
    base = getattr(state, "base", state)
    v = int(base.vocab_size)
    checks = {
        "emb": torch.isfinite(base.emb[:v]).all(),
        "curvature": torch.isfinite(base.curvature),
        "threshold": torch.isfinite(base.threshold),
        "best_dist": ~torch.isnan(base.best_dist).any(),
    }
    for name in ("q_dist", "q_score", "curv_m", "curv_v"):
        if hasattr(state, name):
            checks[name] = ~torch.isnan(getattr(state, name)).any()
    bad = [name for name, ok in zip(checks, torch.stack(
        list(checks.values())).tolist()) if not ok]
    if bad:
        raise FloatingPointError(
            f"non-finite values in the merge state after {where}: {bad}")


def compile_seconds() -> float:
    """Wall seconds this process spent in ``nvcc`` building the kernels;
    callers diff consecutive readings to attribute build time to a phase."""
    from hyptokenizer_tpu_torch.ops.cuda import _build
    return _build.STATS["nvcc_s"]


def cache_hit_counts() -> Dict[str, int]:
    """{hits, requests} of the kernels' build cache in this process: the
    libraries found already built under ``_build/`` against those asked
    for."""
    from hyptokenizer_tpu_torch.ops.cuda import _build
    return {"hits": _build.STATS["hits"],
            "requests": _build.STATS["requests"]}
