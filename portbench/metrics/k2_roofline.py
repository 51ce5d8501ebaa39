"""Kernel K2's share of its roofline, in percent: the sum over its launches
of the larger of operations over the float32 peak and bytes over the HBM
peak (the frozen counts at each launch's merges, steps and active rows),
over K2's device time in the traced training."""
from portbench import peaks, trace
from portbench.counts import enhanced_loop as K
from portbench.readings import traced


def read(run):
    t = traced(run)
    if t is None:
        return None
    launches = [m for m in t.get("launches_marked", []) if m["dense_rows"]]
    sec = trace.kernel_seconds(t, "dense_loop_kernel")
    if not launches or not sec:
        return None
    bound = sum(peaks.roofline_seconds(
        K.segment_ops(m["queue_size"], m["d1"], m["merges"], m["steps"],
                      m["dense_rows"]),
        K.segment_bytes(m["queue_size"], m["d1"], m["merges"],
                        m["dense_rows"]))
        for m in launches)
    return 100.0 * bound / sec
