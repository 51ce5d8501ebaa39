"""Matching rounds of the replay per corpus sync in the traced training:
the program's ``replay.match_rounds`` counter (each round one ``cummax``
over the corpus) over the count of ``sync``."""
from portbench.spans import per


def read(run):
    return per(run, ("counter", "replay.match_rounds"), "sync")
