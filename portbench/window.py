"""The measured window: whole jobs back to back."""

from __future__ import annotations

import time


def run_window(job, seconds: float, sync=None, clock=time.perf_counter,
               records: list = None):
    """Run ``job(k)`` for k = 0, 1, ... and start another only while less
    than ``seconds`` has passed; the window ends when the last job ends
    (after ``sync()``, which waits for the device). Returns the jobs'
    records (appended to ``records`` as they end, when it is given) and
    the window's length in seconds."""
    records = [] if records is None else records
    t0 = clock()
    while clock() - t0 < seconds:
        records.append(job(len(records)))
    if sync is not None:
        sync()
    return records, clock() - t0
