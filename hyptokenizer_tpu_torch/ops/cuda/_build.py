"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and includes
no PyTorch header, so it compiles in seconds. It is built at first use into
``hyptokenizer_tpu_torch/_build/`` (listed in ``.gitignore``), into a file
named by the hash of its source and of the headers it includes from
``csrc/`` (``common.cuh``), so an edited source or header is never served
stale.
``build_all`` starts one nvcc per source, all at once. A failed build
raises; there is no fallback. :func:`check` and :func:`check_devices` are
the wrappers' checks of the tensors they hand a kernel.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
ARCH = "arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIBS: dict = {}       # name -> loaded ctypes.CDLL
BUILD_LOG: dict = {}   # name -> {"seconds": float, "ptxas": str}
# This process's builds: wall seconds inside nvcc, and libraries asked for
# against those found already built (utils/metrics.py reads them).
STATS = {"nvcc_s": 0.0, "requests": 0, "hits": 0}


def nvcc_path() -> str:
    """The nvcc of ``$CUDA_HOME``, ``/usr/local/cuda`` or the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _included(path: str, seen: set) -> None:
    """Add ``path`` and every file under ``csrc/`` that it includes, at any
    depth (quoted includes, resolved beside the including file)."""
    if path in seen:
        return
    seen.add(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        dep = os.path.normpath(os.path.join(os.path.dirname(path),
                                            inc.decode()))
        if os.path.exists(dep):
            _included(dep, seen)


def _target(name: str) -> tuple:
    """(source, library): the library is named by a hash of the source and
    of every header under ``csrc/`` it includes, so that an edit of either
    is never served a stale build."""
    src = os.path.join(CSRC, name + ".cu")
    files: set = set()
    _included(src, files)
    h = hashlib.sha256()
    for path in sorted(files):
        with open(path, "rb") as f:
            h.update(os.path.relpath(path, CSRC).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build_all(names=None) -> dict:
    """Compile every named source (default: all) that is not built yet, one
    nvcc process each, in parallel. Returns {name: seconds}."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        src, out = _target(name)
        STATS["requests"] += 1
        if os.path.exists(out):
            STATS["hits"] += 1
            continue
        # A temporary named by the process: ranks of one job that build
        # the same source at once each finish their own file, and the
        # rename is atomic.
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out, tmp)
    took = {}
    failed = []
    for name, (proc, out, tmp) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"seconds": took[name], "ptxas": log}
    if procs:
        STATS["nvcc_s"] += time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_target(name)[1])
            _LIBS[name] = lib
        return lib


def check(name: str, t, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` (a
    None entry: any length; ``shape`` None: one element)."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is None:
        if t.numel() != 1:
            raise ValueError(f"{name}: {t.numel()} elements, expected one")
    elif t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")


def check_devices(tensors, dev) -> None:
    """Raise unless every ``(name, tensor)`` of ``tensors`` lies on the CUDA
    device ``dev``."""
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: on {t.device}, the kernel needs a "
                             f"CUDA tensor")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the kernel's other "
                             f"inputs on {dev}")
