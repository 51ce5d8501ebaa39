"""Observability: structured metrics, profiling traces, NaN debugging.

Port of ``hyptokenizer_tpu/utils/metrics.py``. ``MetricsWriter`` (a JSONL
metrics stream, the source of ``--metrics-path``) and ``span`` are copied.
The JAX-only parts have these counterparts:

- ``profile_trace`` is a ``torch.profiler`` window (CPU, and the card when
  there is one) that writes a Chrome trace, ``trace.json``, into
  ``log_dir``;
- ``enable_nan_checks`` turns on ``torch.autograd.set_detect_anomaly``
  (the embedding trainers' backward passes raise at the operation that made
  a NaN) and makes the tokenizers' ``optimize_merges`` check their state
  for non-finite values after each chunk (:func:`check_finite`), raising
  ``FloatingPointError``;
- ``compile_seconds`` and ``cache_hit_counts`` read the kernels' build
  (``ops/cuda/_build.py``): wall seconds spent in ``nvcc`` in this process,
  and the libraries found already built against those asked for.
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


@contextlib.contextmanager
def span(name: str, metrics: Optional[MetricsWriter] = None) -> Iterator[None]:
    """Host-side timing span; logs `<name>_seconds`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        logger.debug("%s took %.3fs", name, dt)
        if metrics is not None:
            metrics.log({f"{name}_seconds": dt})


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """``torch.profiler`` trace of the enclosed work, written to
    ``log_dir/trace.json`` (open in Perfetto or ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
