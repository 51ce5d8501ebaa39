"""Launches of kernel K2 (``dense_loop_kernel``) in the traced training:
the marked launches of the segment kernel with active rows. Every sync
and curvature step ends a segment, so the storm's resyncs each cost one."""
from portbench.dense_spans import traced_job


def read(run):
    job = traced_job(run)
    if job is None:
        return None
    n = sum(1 for m in job["trace"].get("launches_marked", [])
            if m["dense_rows"])
    return float(n) if n else None
