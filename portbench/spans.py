"""The program's own spans and counters in the traced training, for the
readers under ``metrics/``: the program's ``trace_snapshot()``
(``hyptokenizer_tpu_torch/utils/metrics.py``), which holds the profiler
session that traced the window's first job. A program without it gives
None, as does a run whose traced job is not a training."""

from __future__ import annotations

from portbench.readings import traced


def snapshot(run: dict):
    """The snapshot of the run's traced training, or None."""
    if run.get("job_kind") != "enhanced_training" or traced(run) is None:
        return None
    try:
        from hyptokenizer_tpu_torch.utils.metrics import trace_snapshot
    except ImportError:
        return None
    return trace_snapshot()


def per(run: dict, num, span: str, scale: float = 1.0):
    """``scale`` x ``num`` over the count of span ``span``, or None where
    either is missing. ``num`` is ``("span", name)`` (its elapsed seconds)
    or ``("counter", name)``."""
    snap = snapshot(run)
    if snap is None:
        return None
    den = snap["spans"].get(span, {}).get("count", 0)
    kind, name = num
    if kind == "span":
        value = snap["spans"].get(name, {}).get("elapsed_s")
    else:
        value = snap["counters"].get(name)
    if not den or value is None:
        return None
    return float(scale * value / den)
