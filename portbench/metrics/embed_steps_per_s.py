"""RSGD steps of the window's whole pretrainings over the window's
seconds."""
from portbench.readings import window_rate


def read(run):
    return window_rate(run, "steps")
