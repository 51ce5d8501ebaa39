"""The program's spans and counters in the traced all-features training,
for the readers of the ``dense_training`` cells: the program's
``trace_snapshot()`` (``hyptokenizer_tpu_torch/utils/metrics.py``) after
the window's first job. A program without it or without the span or
counter, and a run whose traced job is no such training, give None."""

from __future__ import annotations

from portbench.readings import traced

KIND = "dense_training"


def traced_job(run: dict):
    """The record of the run's traced training of this kind, or None."""
    if run.get("job_kind") != KIND or traced(run) is None:
        return None
    return next(j for j in run["jobs"] if j.get("trace") is not None)


def snapshot(run: dict):
    """The program's snapshot of the traced training, or None."""
    if traced_job(run) is None:
        return None
    try:
        from hyptokenizer_tpu_torch.utils.metrics import trace_snapshot
    except ImportError:
        return None
    return trace_snapshot()


def counter(run: dict, name: str):
    """Counter ``name`` of the traced training, or None."""
    snap = snapshot(run)
    return None if snap is None else snap["counters"].get(name)


def per_span(run: dict, name: str, scale: float = 1.0):
    """``scale`` x span ``name``'s elapsed seconds over its count, or
    None."""
    snap = snapshot(run)
    span = None if snap is None else snap["spans"].get(name)
    if not span or not span.get("count"):
        return None
    return float(scale * span["elapsed_s"] / span["count"])
