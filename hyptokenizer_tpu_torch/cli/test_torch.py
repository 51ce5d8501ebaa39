"""Device smoke test: backend, matmul timing, Minkowski-dot check.

    python -m hyptokenizer_tpu_torch.cli.test_torch [--kernel-check]
        [--device cpu]

The port of ``hyptokenizer_tpu/cli/test_tpu.py``: the backend and its
devices; a 2048^3 float32 ``torch.matmul`` (TF32 off) timed over ten
products, with its TFLOP/s and the card's name and power limit beside it;
``<x,x>_L = 1`` within 1e-5 on ``lorentz.random_points``. With
``--kernel-check`` it prints ``evals/selfcheck.kernel_selfcheck()`` as
JSON. Exits nonzero when a check fails or a selfcheck verdict is not
"pass". The default device is the card; without one it raises unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from hyptokenizer_tpu_torch import _device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel-check", action="store_true",
                   help="also hold every kernel to its plain version on "
                        "this device (evals/selfcheck.kernel_selfcheck)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    dev = _device.resolve(args.device)
    print(f"backend: {dev.type}")
    if dev.type == "cuda":
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        print(f"devices: {names}")
    else:
        print(f"devices: [cpu x {torch.get_num_threads()} threads]")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    x = torch.ones((2048, 2048), dtype=torch.float32, device=dev)
    x @ x
    sync()
    t0 = time.perf_counter()
    for _ in range(10):
        y = x @ x
    sync()
    dt = (time.perf_counter() - t0) / 10
    del y
    flops = 2 * 2048 ** 3
    card = _device.card(dev)
    print(f"2048^3 matmul: {dt * 1e3:.2f} ms ({flops / dt / 1e12:.1f} "
          f"TFLOP/s) on {card['name']}, power limit {card['power_limit']}")

    from hyptokenizer_tpu_torch.ops import lorentz as L
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    pts = L.random_points(gen, 8, 10, sigma=0.5, device=dev)
    err = float((L.minkowski_dot(pts, pts) - 1.0).abs().max())
    ok = err <= 1e-5
    print(f"minkowski <x,x>=1 on manifold: {'OK' if ok else 'FAIL'} "
          f"(max err {err:.2e})")

    if args.kernel_check:
        from hyptokenizer_tpu_torch.evals import selfcheck
        report = selfcheck.kernel_selfcheck(dev)
        print(json.dumps(report))
        ok = ok and not selfcheck.selfcheck_failures(report)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
