#!/usr/bin/env python3
"""Latency probes for the cooperative grids of the port's kernels K2 and K4
on one NVIDIA card.

    python3 tools/torch_sync_probe.py

Builds a small CUDA library (nvcc, sm_90a, into
``hyptokenizer_tpu_torch/_build/``) that includes the kernels' own
``csrc/common.cuh``, and times with CUDA events, over many iterations of
one cooperative launch of one 1024-thread block per SM:

* ``barrier_us``: one ``grid_barrier`` (the atomic counter with a
  generation word that K4 and K2 use);
* ``flag_gather_us``: an all-to-all exchange without a counter: every
  block writes its slot and a step number, every block's warp 0 polls all
  slots' step numbers (the exchange K4's step needs);
* ``leader_round_us``: block 0 publishes a step number that the other
  blocks poll, and each of them adds one to a counter that block 0 polls
  (a broadcast and a gather, the exchange K2's step needs);
* ``l2_load_ns``: one dependent load through L2 (``__ldcg``), from a
  pointer chase over a 4 MB random cycle.

Prints the card line and one JSON object. Exits nonzero without a card.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

SOURCE = r'''
#include <cuda_runtime.h>
#include "common.cuh"
using namespace hyptok;

__global__ void __launch_bounds__(1024, 1) barrier_k(unsigned* bar, int n) {
  for (int s = 0; s < n; ++s) grid_barrier(bar, gridDim.x);
}

__global__ void __launch_bounds__(1024, 1) flag_k(int* slots, int n) {
  // slots: (grid, 4) ints: value, row, partner, step number
  __shared__ int s_sum;
  const int b = blockIdx.x;
  const int g = gridDim.x;
  for (int s = 1; s <= n; ++s) {
    if (threadIdx.x == 0) {
      slots[4 * b] = s;
      slots[4 * b + 1] = b;
      slots[4 * b + 2] = -b;
      __threadfence();
      *(volatile int*)(slots + 4 * b + 3) = s;
    }
    if (threadIdx.x < 32) {
      int sum = 0;
      for (int q = threadIdx.x; q < g; q += 32) {
        while (*(volatile int*)(slots + 4 * q + 3) < s) {
        }
        __threadfence();
        sum += __ldcg(slots + 4 * q + 1);
      }
      sum = warp_sum_int(sum);
      if (threadIdx.x == 0) s_sum = sum;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024, 1) leader_k(int* flags, int n) {
  // flags[0]: block 0's step number; flags[1]: arrivals of the others
  const int g = gridDim.x;
  for (int s = 1; s <= n; ++s) {
    if (threadIdx.x == 0) {
      if (blockIdx.x == 0) {
        __threadfence();
        *(volatile int*)flags = s;
        while (*(volatile int*)(flags + 1) < (g - 1) * s) {
        }
        __threadfence();
      } else {
        while (*(volatile int*)flags < s) {
        }
        __threadfence();
        atomicAdd(flags + 1, 1);
      }
    }
    __syncthreads();
  }
}

__global__ void chase_k(const int* next, int n, int* out) {
  int i = 0;
  for (int s = 0; s < n; ++s) i = __ldcg(next + i);
  *out = i;
}

static int coop(const void* fn, void* a, int n, int grid, void* stream) {
  void* args[] = {&a, &n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(1024), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int probe_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}
extern "C" int probe_barrier(void* bar, int n, int grid, void* stream) {
  return coop((const void*)barrier_k, bar, n, grid, stream);
}
extern "C" int probe_flag(void* slots, int n, int grid, void* stream) {
  return coop((const void*)flag_k, slots, n, grid, stream);
}
extern "C" int probe_leader(void* flags, int n, int grid, void* stream) {
  return coop((const void*)leader_k, flags, n, grid, stream);
}
extern "C" int probe_chase(void* next, int n, void* out, void* stream) {
  chase_k<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, n,
                                             (int*)out);
  return (int)cudaGetLastError();
}
'''


def build():
    from hyptokenizer_tpu_torch.ops.cuda import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "sync_probe.cu")
    out = os.path.join(_build.BUILD_DIR, "sync_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.nvcc_path(), "-gencode", _build.ARCH,
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", _build.CSRC, "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("probe_barrier", "probe_flag", "probe_leader"):
        getattr(lib, name).argtypes = [p, i, i, p]
    lib.probe_chase.argtypes = [p, i, p, p]
    return lib


def timed(launch, n):
    """Microseconds per iteration of ``launch(n)``, after a warm-up."""
    launch(100)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    launch(n)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def main():
    if not torch.cuda.is_available():
        print("torch_sync_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = build()
    stream = torch.cuda.current_stream().cuda_stream
    g = lib.probe_sms()
    n = 20_000

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {rc}")

    def barrier(k):
        check(lib.probe_barrier(torch.zeros(2, dtype=torch.int32,
                                            device="cuda").data_ptr(),
                                k, g, stream))

    def flag(k):
        check(lib.probe_flag(torch.zeros(4 * g, dtype=torch.int32,
                                         device="cuda").data_ptr(),
                             k, g, stream))

    def leader(k):
        check(lib.probe_leader(torch.zeros(2, dtype=torch.int32,
                                           device="cuda").data_ptr(),
                               k, g, stream))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    size = 1 << 20
    perm = torch.randperm(size, generator=gen, device="cuda")
    nxt = torch.empty(size, dtype=torch.int32, device="cuda")
    nxt[perm] = torch.roll(perm, -1).int()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")

    def chase(k):
        check(lib.probe_chase(nxt.data_ptr(), k, out.data_ptr(), stream))

    chase(size)        # bring the cycle into L2
    result = {
        "grid": g, "iterations": n,
        "barrier_us": timed(barrier, n),
        "flag_gather_us": timed(flag, n),
        "leader_round_us": timed(leader, n),
        "l2_load_ns": timed(chase, n) * 1e3,
    }
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
