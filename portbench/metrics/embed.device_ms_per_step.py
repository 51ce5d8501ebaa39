"""Device-busy milliseconds per step of the traced pretraining."""
from portbench.readings import traced


def read(run):
    t = traced(run)
    if t is None or not t.get("steps") or not t["launches"]:
        return None
    return t["busy_s"] * 1e3 / t["steps"]
