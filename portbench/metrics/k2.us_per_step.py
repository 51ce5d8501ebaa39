"""Microseconds per step of kernel K2 (``dense_loop_kernel``): its device
time in the traced training over the steps its launches advanced."""
from portbench import trace
from portbench.readings import traced


def read(run):
    t = traced(run)
    if t is None:
        return None
    launches = [m for m in t.get("launches_marked", []) if m["dense_rows"]]
    steps = sum(m["steps"] for m in launches)
    sec = trace.kernel_seconds(t, "dense_loop_kernel")
    return sec * 1e6 / steps if steps and sec else None
