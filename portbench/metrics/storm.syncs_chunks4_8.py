"""Corpus syncs in chunks 4 to 8 of the traced training (its merges from
3 x to 8 x ``log_every``, 3,000-8,000 in the Quick start), where the
second phase's resync storm was first seen: the sum of the program's
``chunk_syncs`` over those chunks."""
from portbench.dense_spans import traced_job


def read(run):
    job = traced_job(run)
    syncs = None if job is None else job.get("chunk_syncs")
    if not syncs or len(syncs) < 8:
        return None
    return float(sum(syncs[3:8]))
