"""Percent of the traced all-features training's span in which the device
ran nothing."""
from portbench.readings import idle_percent


def read(run):
    return idle_percent(run, "dense_training")
