"""Milliseconds per corpus sync in the traced training: the program's
``sync`` span (``run_chunk``: the sync and the read that waits for it), in
event time from its entry to the end of its last kernel, over its count."""
from portbench.spans import per


def read(run):
    return per(run, ("span", "sync"), "sync", 1e3)
