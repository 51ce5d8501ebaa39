"""Milliseconds per chunk spent bringing the chunk's merges to the host as
vocabulary strings in the traced training: the program's ``chunk.strings``
span, in event time, over its count."""
from portbench.spans import per


def read(run):
    return per(run, ("span", "chunk.strings"), "chunk.strings", 1e3)
