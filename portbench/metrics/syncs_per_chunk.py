"""Corpus syncs per chunk: the trainings' ``chunk_syncs`` summed over
their chunks."""


def read(run):
    jobs = [j for j in run["jobs"] if "syncs" in j]
    chunks = sum(j["chunks"] for j in jobs)
    return sum(j["syncs"] for j in jobs) / chunks if chunks else None
