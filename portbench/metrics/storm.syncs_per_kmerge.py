"""Corpus syncs per 1,000 merges of the second phase in the traced
training: the program's ``sync.phase2`` counter (syncs at a merge count in
the second phase) over the training's merges from ``phase2_step`` to
``phase3_step``, times 1,000."""
from portbench.dense_spans import counter, traced_job


def read(run):
    n = counter(run, "sync.phase2")
    job = traced_job(run)
    if n is None or not job.get("phase2_merges"):
        return None
    return 1000.0 * n / job["phase2_merges"]
