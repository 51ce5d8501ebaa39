"""Device selection and the float32 matmul policy of the port.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Without a card, a call that did not ask for ``"cpu"`` raises: the port never
drops silently to the CPU.

TF32 is off for every gram. The JAX package evaluates every inner product
at ``Precision.HIGHEST`` (``hyptokenizer_tpu/ops/lorentz.py`` ``DOT_PREC``):
``acosh`` near 1 needs absolute gram errors far below what TF32's ten-bit
mantissa gives (``ops/pallas/KERNELS.md``, "Cross-path fp equivalence").
Importing this module sets both switches once, for the whole process.
"""

from __future__ import annotations

import subprocess

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """The device a call runs on: ``device``, or the card when it is None.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is present.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def card(dev: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reads them, or
    ``{"name": "cpu", "power_limit": None}`` for the CPU."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    line = out.stdout.strip().splitlines()[dev.index or 0]
    name, limit = line.rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}
