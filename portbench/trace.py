"""One job under ``torch.profiler``, and what its trace says: device busy
time, idle gaps, the heaviest device operations and kernel times."""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

JOB_MARK = "portbench.job"
NON_KERNELS = ("Memcpy", "Memset")


def profile_call(fn, device: torch.device):
    """``fn()`` inside a profiler window that records the host's operations
    and the device's activity, the job marked ``JOB_MARK``. Returns
    (``fn``'s result, :func:`summarize` of the trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(JOB_MARK):
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return out, summarize(events(prof))


def events(prof) -> list:
    """(name, on_device, start_ns, end_ns) of every event of the trace,
    less the device's copies of host annotations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        if on_device and (e.is_user_annotation() or e.name() == JOB_MARK):
            continue   # a host annotation's image on the device timeline
        start = e.start_ns()
        out.append((e.name(), on_device, start, start + e.duration_ns()))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(evts: list, top: int = 10) -> dict:
    """The job's span (its ``JOB_MARK``), the seconds in which the device
    ran an operation within it, its kernel launches, the device time and
    count of each operation, the ``top`` heaviest operations and the
    ``top`` longest idle gaps, each named by the innermost host operation
    that was running at the gap's middle."""
    marks = [(s, e) for n, dev, s, e in evts if n == JOB_MARK and not dev]
    if not marks:
        raise RuntimeError("the trace holds no job mark")
    t0, t1 = marks[0]
    dev_iv = []
    per_op = defaultdict(lambda: [0.0, 0])
    launches = 0
    for n, dev, s, e in evts:
        if not dev:
            continue
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        dev_iv.append((s, e))
        per_op[n][0] += (e - s) * 1e-9
        per_op[n][1] += 1
        if not n.startswith(NON_KERNELS):
            launches += 1
    busy = _union(dev_iv)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((t1 - prev, prev, t1))
    gaps.sort(reverse=True)
    host = sorted((s, e, n) for n, dev, s, e in evts
                  if not dev and n != JOB_MARK and s >= t0 and e <= t1)
    starts = [h[0] for h in host]

    def doing(mid):
        i = bisect.bisect_right(starts, mid)
        for s, e, n in reversed(host[max(0, i - 4096):i]):
            if e >= mid:
                return n
        return "host"

    heavy = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "span_s": (t1 - t0) * 1e-9,
        "busy_s": busy_s,
        "launches": launches,
        "ops": {n: tuple(v) for n, v in per_op.items()},
        "device_ops": [[n, v[0]] for n, v in heavy],
        "idle_gaps": [[doing((a + b) // 2), g * 1e-9]
                      for g, a, b in gaps[:top]],
    }


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Device seconds of the operations whose name holds ``fragment``."""
    return sum(v[0] for n, v in summary["ops"].items() if fragment in n)


class Spans:
    """Host spans, named for the layer they enter, around program functions
    for the length of one traced job: ``targets`` are (module or class,
    attribute, span name). The benchmark marks the layers from its own
    files; the program is left as it is once the job ends."""

    def __init__(self, targets):
        self.targets = targets
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function

        for owner, attr, name in self.targets:
            fn = getattr(owner, attr)

            def spanned(*args, _fn=fn, _name=name, **kw):
                with record_function(_name):
                    return _fn(*args, **kw)

            self.saved.append((owner, attr, owner.__dict__.get(attr)))
            setattr(owner, attr, spanned)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self.saved = []
        return False
