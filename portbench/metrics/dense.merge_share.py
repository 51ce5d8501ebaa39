"""Percent of the traced training's merges that the dense channel made:
the program's ``merge.dense`` counter over the training's merges."""
from portbench.dense_spans import counter, traced_job


def read(run):
    n = counter(run, "merge.dense")
    job = traced_job(run)
    if n is None or not job.get("merges"):
        return None
    return 100.0 * n / job["merges"]
