"""The controls of a cell's comparison: the plain reference put in the
program's place, computed in a lower precision than the configuration
states, judged as the program is. Each must come out not correct.

    python3 -m portbench.controls --workload <cell> --seeds 1 2 3 \\
        [--precision bfloat16|tf32|float32]

``bfloat16`` is the control. ``tf32`` is the reference in float32 with
TF32 allowed for matrix products (none of the references takes one, so it
reads as ``float32``, the reference judged against itself). Prints one
JSON line per seed: the numbers compared and whether each is within the
cell's limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

PRECISIONS = ("bfloat16", "tf32", "float32")


def run_control(name: str, seed: int, precision: str, device,
                overrides: dict = None) -> dict:
    import torch

    from portbench import registry
    from portbench.run import pieces

    cell, cfg, traffic = pieces(name, overrides)
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    numbers = registry.job(cell["job"]).control(
        cell, cfg, traffic, seed, torch.device(device), dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    within = {k: numbers[k] <= v for k, v in cell["limits"].items()}
    return {"workload": name, "seed": seed, "precision": precision,
            "numbers": numbers, "within": within,
            "correct": all(within.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", choices=PRECISIONS, default="bfloat16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = run_control(args.workload, seed, args.precision, args.device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
