"""Milliseconds per curvature Adam step in the traced all-features
training: the program's ``curvature_adam`` span (only steps that fire), in
event time, over its count."""
from portbench.dense_spans import per_span


def read(run):
    return per_span(run, "curvature_adam", 1e3)
