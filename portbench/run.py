"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the card, the kernels' load, the cell's corpus, inputs
and warm-up) is timed from the process's start; then the window runs whole
jobs back to back (:mod:`portbench.window`), the device synchronised at its
end. With ``--trace 1`` the window's first job runs under the profiler and
the per-layer metrics are reported; with ``--trace 0`` the end-to-end ones.
Once the window has closed and the peak memory is read, the cell's job
kind judges one job of the window against the plain reference; each number
compared is printed beside its limit as the last lines of standard error
and under ``compared``, the result's last key. The last line of standard
output is the result. Exits non-zero, with no result, without a card (or
with fewer cards than the cell asks for), or when ``jax``, ``jaxlib``,
``flax`` or ``hyptokenizer_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hyptokenizer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def pieces(name: str, overrides: dict = None):
    """Cell ``name``'s file, its configuration and its traffic, each with
    the keys of ``overrides[piece]`` replaced (``cell``, ``config``,
    ``traffic``: the tests' small sizes). A cell that ``BENCHMARK.json``
    lists has to name the configuration and traffic that it lists."""
    from portbench import registry

    over = overrides or {}
    cell = dict(registry.cell(name), **over.get("cell", {}))
    listed = [w for w in registry.benchmark()["workloads"]
              if w["name"] == name]
    for w in listed:
        if (w["config"], w["traffic"]) != (cell["config"], cell["traffic"]):
            raise SystemExit(f"cells/{name}.json names {cell['config']!r}, "
                             f"{cell['traffic']!r}; BENCHMARK.json lists "
                             f"{w['config']!r}, {w['traffic']!r}")
    cfg = dict(registry.config(cell["config"]), **over.get("config", {}))
    traffic = dict(registry.traffic(cell["traffic"]),
                   **over.get("traffic", {}))
    return cell, cfg, traffic


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict = None, t_start: float = None) -> dict:
    """Set-up, window and judgement of cell ``name`` on ``device``, its
    pieces with ``overrides`` (:func:`pieces`). Returns the result,
    ``compared`` last."""
    import torch

    from portbench import registry
    from portbench.draws import sub_seed
    from portbench.window import run_window

    t_start = T_START if t_start is None else t_start
    device = torch.device(device)
    bench = registry.benchmark()
    cell, cfg, traffic = pieces(name, overrides)
    kind = registry.job(cell["job"])

    ctx = kind.set_up(cell, cfg, traffic, seed, device)
    setup_s = time.perf_counter() - t_start
    gc.freeze()   # set-up's objects: no collection scans them again

    failed = []
    pick = random.Random(sub_seed(seed, 3))
    judged = {}

    def one(k):
        t0, c0 = time.perf_counter(), time.process_time()
        try:
            rec = kind.job(ctx, k, traced=trace and k == 0)
        except Exception:  # a job that raises ends the window, recorded
            failed.append(traceback.format_exc())
            raise _Stop
        rec["seconds"] = time.perf_counter() - t0
        rec["cpu_s"] = time.process_time() - c0
        # One job of the window, uniform over however many run, drawn from
        # the seed (a reservoir of one); the others' outputs are dropped.
        outputs = {h: rec.pop(h) for h in kind.OUTPUTS}
        if pick.random() * (k + 1) < 1.0:
            judged.clear()
            judged.update(outputs)
        return rec

    jobs = []
    try:
        _, window_s = run_window(
            one, seconds, sync=(lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else None, records=jobs)
    except _Stop:
        window_s = float("nan")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    limits = cell["limits"]
    numbers = kind.judge(ctx, judged) if jobs and not failed else {}
    correct = (not failed and bool(jobs)
               and all(numbers.get(k, float("inf")) <= v
                       for k, v in limits.items()))
    run = {"cell": name, "job_kind": cell["job"], "config": cfg,
           "setup_s": setup_s, "window_s": window_s, "jobs": jobs}
    metrics = {}
    entries = registry.cell_metrics(bench, name,
                                    "per_layer" if trace else "end_to_end")
    for m in entries:
        value = (registry.metric(m["name"]).read(run)
                 if jobs and not failed else None)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(jobs) + len(failed),
              "failed": len(failed), "metrics": metrics, "device": dev}
    summary = next((j["trace"] for j in jobs if j.get("trace")), None)
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["span_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["errors"] = failed
    result["jobs"] = [{k: j[k] for k in ("seconds", "cpu_s", "merges", "steps",
                                         "syncs") if k in j} for j in jobs]
    result["compared"] = {k: {"value": numbers.get(k), "limit": v}
                          for k, v in limits.items()}
    return result


class _Stop(Exception):
    pass


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import registry

    torch.set_num_threads(1)
    chips = _workload(registry.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s); {found} "
              "found", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the benchmark's process: {found}",
              file=sys.stderr)
        return 3
    for err in result.pop("errors"):
        print(err, file=sys.stderr)
    print(f"# jobs: {json.dumps(result.pop('jobs'))}", file=sys.stderr)
    result["device"]["power_limit"] = power_limit()
    print(f"# card: {result['device']['power_limit']}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
