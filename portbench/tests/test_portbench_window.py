"""The window rule: whole jobs, a new one only while less than the
window's seconds has passed; the window ends when the last job ends."""

import pytest

from portbench.window import run_window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("job_s,seconds,jobs,length", [
    (1.0, 10.0, 10, 10.0), (3.0, 10.0, 4, 12.0), (12.0, 10.0, 1, 12.0),
    (0.4, 1.0, 3, 1.2)])
def test_whole_jobs(job_s, seconds, jobs, length):
    clock = Clock()
    synced = []

    def job(k):
        clock.t += job_s
        return {"k": k}

    records, took = run_window(job, seconds, sync=lambda: synced.append(1),
                               clock=clock)
    assert [r["k"] for r in records] == list(range(jobs))
    assert took == pytest.approx(length)
    assert synced == [1]
