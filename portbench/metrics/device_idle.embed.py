"""Percent of the traced pretraining's span in which the device ran
nothing."""
from portbench.readings import idle_percent


def read(run):
    return idle_percent(run, "embed_pretrain")
