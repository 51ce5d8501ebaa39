"""Milliseconds per corpus sync spent replaying the merges onto the corpus
in the traced training: the program's ``sync.replay`` span
(``sync_corpus``), in event time, over the count of ``sync``."""
from portbench.spans import per


def read(run):
    return per(run, ("span", "sync.replay"), "sync", 1e3)
