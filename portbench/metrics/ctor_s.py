"""Mean seconds of a training's constructor, on the benchmark's clock
around it, the device synchronised."""
from portbench.readings import host_timed


def read(run):
    jobs = [j for j in host_timed(run) if "ctor_s" in j]
    return sum(j["ctor_s"] for j in jobs) / len(jobs) if jobs else None
