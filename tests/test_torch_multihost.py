"""The port's multi-process training: two OS processes, one gloo rank
each, meet at a localhost coordinator through ``initialize_multihost``
(the counterpart of tests/test_multihost.py). Both the distance-only and
the enhanced sharded loops (the v3 sync included) give the same merges on
both processes as one process alone; ``bench_scaling --multihost`` prints
each rank's lines, the JAX CLI's JSON, and the single process's merges.
"""

import json
import os
import re
import socket
import subprocess
import sys

_RANK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_multihost_rank.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _run_all(cmds):
    """Start every command together; (returncode, output) of each."""
    procs = [subprocess.Popen(c, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def test_two_process_merge_sequences_match_single_process(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"proc{pid}.json") for pid in range(2)]
    oracle = str(tmp_path / "single.json")
    runs = _run_all(
        [[sys.executable, _RANK, coord, "2", str(pid), outs[pid]]
         for pid in range(2)]
        + [[sys.executable, _RANK, "", "1", "0", oracle]])
    for rc, log in runs:
        assert rc == 0, log[-4000:]
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    with open(oracle) as f:
        single = json.load(f)
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["process_count"] == 2 for r in results)
    assert single["process_count"] == 1
    assert results[0]["v3_path"] == "v3" and single["v3_path"] == "v3"
    for key, least in (("merges", 10), ("enhanced_merges", 5),
                       ("v3_merges", 5)):
        assert results[0][key] == results[1][key] == single[key], key
        assert len(single[key]) > least, key


def test_bench_scaling_multihost_two_process(tmp_path):
    """Each rank prints ``host r/2``, a world of 2, the JAX CLI's JSON
    line, and the merge count and history checksum of a single process."""
    coord = f"127.0.0.1:{_free_port()}"
    args = ["--device", "cpu", "--n-init", "64", "--embedding-dim", "8",
            "--max-vocab-size", "256", "--steps", "16", "--warmup", "4"]
    cmd = [sys.executable, "-m", "hyptokenizer_tpu_torch.cli.bench_scaling"]
    runs = _run_all(
        [cmd + args + ["--multihost", "--coordinator-address", coord,
                       "--num-processes", "2", "--process-id", str(pid)]
         for pid in range(2)] + [cmd + args])
    for rc, out in runs:
        assert rc == 0, out[-4000:]
    merged = []
    for pid, (_, out) in enumerate(runs[:2]):
        assert f"host {pid}/2" in out, out[-2000:]
        assert "2 global devices" in out, out[-2000:]
        rec = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
        assert rec["n_processes"] == 2 and rec["process"] == pid
        assert rec["loop"] == "base"
        assert rec["steps_per_sec_by_devices"]["2"] > 0
        merged.append(re.search(r"merges=(\d+) checksum=(-?\d+)",
                                out).groups())
    single = runs[2][1]
    assert "host 0/1" in single
    assert merged[0] == merged[1] == re.search(
        r"merges=(\d+) checksum=(-?\d+)", single).groups()
    assert int(merged[0][0]) > 0
