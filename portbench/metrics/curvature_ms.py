"""Milliseconds per curvature Adam step taken in the traced training: the
program's ``curvature_adam`` span (only steps that fire), in event time,
over its count."""
from portbench.spans import per


def read(run):
    return per(run, ("span", "curvature_adam"), "curvature_adam", 1e3)
