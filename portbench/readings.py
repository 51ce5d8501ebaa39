"""What a metric's reader may read of a run (``run`` is a dict):
``setup_s``, ``window_s``, ``jobs`` (each job's record: its work counts,
host timings and, for the traced job, ``trace``, :func:`trace.summarize`'s
summary) and ``device``."""

from __future__ import annotations


def traced(run: dict):
    """The traced job's trace summary, or None."""
    for j in run["jobs"]:
        if j.get("trace") is not None:
            return j["trace"]
    return None


def host_timed(run: dict) -> list:
    """The jobs whose host timings stand: the untraced ones, or all when
    every job was traced."""
    plain = [j for j in run["jobs"] if not j.get("traced")]
    return plain or run["jobs"]


def window_rate(run: dict, key: str):
    """All of the window's ``key`` work over all of its time."""
    if not run["jobs"] or any(key not in j for j in run["jobs"]):
        return None
    return sum(j[key] for j in run["jobs"]) / run["window_s"]


def idle_percent(run: dict, kind: str):
    """100 x (1 - the device's busy seconds over the traced job's span),
    for a traced job of the given kind."""
    t = traced(run)
    if (t is None or run.get("job_kind") != kind or t["span_s"] <= 0
            or not t["launches"]):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
