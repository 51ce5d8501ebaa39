"""Each metric's arithmetic on made-up runs and traces."""

import pytest

from portbench import peaks, registry, trace
from portbench.counts import enhanced_loop as K

MARK = trace.JOB_MARK


def read(name, run):
    return registry.metric(name).read(run)


def _trace():
    evts = [
        (MARK, False, 0, 10_000),
        ("aten::sum", False, 100, 2_000), ("aten::item", False, 2_000, 6_000),
        ("cudaLaunchKernel", False, 6_100, 6_200),
        ("(anonymous)::corpus_loop_kernel(Params)", True, 1_000, 3_000),
        ("(anonymous)::corpus_loop_kernel(Params)", True, 2_500, 4_000),
        ("Memcpy HtoD", True, 7_000, 7_500),
        ("reduce_kernel", True, 9_000, 12_000),   # runs past the job's end
        ("before", True, -500, -100),             # before the job
    ]
    t = trace.summarize(evts)
    t["launches_marked"] = [
        {"steps": 10, "merges": 100, "queue_size": 4096, "d1": 101,
         "dense_rows": 0},
        {"steps": 30, "merges": 200, "queue_size": 4096, "d1": 101,
         "dense_rows": 0}]
    t["steps"] = 3
    return t


def test_summarize_a_made_up_trace():
    t = _trace()
    assert t["span_s"] == pytest.approx(10_000e-9)
    # device busy: [1000, 4000] + [7000, 7500] + [9000, 10000]
    assert t["busy_s"] == pytest.approx(4_500e-9)
    assert t["launches"] == 3
    assert trace.kernel_seconds(t, "corpus_loop_kernel") == \
        pytest.approx(3_500e-9)
    gaps = dict((round(s * 1e9), n) for n, s in t["idle_gaps"])
    assert gaps == {1000: "aten::sum", 3000: "aten::item", 1500: "host"}
    assert t["device_ops"][0][0].endswith("corpus_loop_kernel(Params)")


def _run(kind="enhanced_training", traced=True):
    jobs = [{"merges": 45_000, "ctor_s": 0.5, "chunks": 24, "syncs": 30,
             "steps": 3000, "traced": True, "trace": _trace() if traced
             else None},
            {"merges": 45_000, "ctor_s": 0.1, "chunks": 24, "syncs": 26,
             "steps": 3000, "traced": False, "trace": None},
            {"merges": 44_000, "ctor_s": 0.2, "chunks": 22, "syncs": 22,
             "steps": 3000, "traced": False, "trace": None}]
    return {"job_kind": kind, "setup_s": 7.5, "window_s": 2.0, "jobs": jobs}


def test_end_to_end_metrics():
    run = _run()
    assert read("merges_per_s", run) == pytest.approx(134_000 / 2.0)
    assert read("embed_steps_per_s", run) == pytest.approx(9_000 / 2.0)
    assert read("setup_s", run) == 7.5
    assert read("merges_per_s", dict(run, jobs=[{"steps": 1}])) is None


def test_host_and_counter_metrics():
    run = _run()
    assert read("ctor_s", run) == pytest.approx(0.15)   # the traced one out
    assert read("syncs_per_chunk", run) == pytest.approx(78 / 70)


def test_kernel_metrics():
    run = _run()
    sec = 3_500e-9
    assert read("k1.us_per_step", run) == pytest.approx(sec * 1e6 / 40)
    bound = sum(peaks.roofline_seconds(K.segment_ops(4096, 101, m, s),
                                       K.segment_bytes(4096, 101, m))
                for m, s in ((100, 10), (200, 30)))
    assert read("k1_roofline", run) == pytest.approx(100 * bound / sec)


def test_device_metrics():
    run = _run()
    assert read("device_idle.merge", run) == pytest.approx(55.0)
    assert read("device_idle.embed", run) is None
    emb = _run("embed_pretrain")
    assert read("device_idle.embed", emb) == pytest.approx(55.0)
    assert read("embed.launches_per_step", emb) == pytest.approx(1.0)
    assert read("embed.device_ms_per_step", emb) == pytest.approx(
        4_500e-9 * 1e3 / 3)


@pytest.mark.parametrize("name", [m["name"] for m in
                                  registry.benchmark()["per_layer"]])
def test_nothing_to_read_reads_nothing(name):
    assert read(name, _run(traced=False)) is None or name in (
        "ctor_s", "syncs_per_chunk")


def test_roofline_arithmetic():
    assert peaks.roofline_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.roofline_seconds(0, 3.35e12) == pytest.approx(1.0)
