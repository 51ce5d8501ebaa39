"""Milliseconds per corpus sync in the traced all-features training: the
program's ``sync`` span (``run_chunk``: the sync and the read that waits
for it, the storm's resyncs included), in event time, over its count."""
from portbench.dense_spans import per_span


def read(run):
    return per_span(run, "sync", 1e3)
