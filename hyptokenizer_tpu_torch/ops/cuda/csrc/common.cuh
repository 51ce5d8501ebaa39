// Device helpers shared by the port's kernels: the JAX package's clamp
// constants (hyptokenizer_tpu/ops/lorentz.py), the log-form acosh of the
// plain version (ops/lorentz.py `acosh`), warp sums and the (value, index)
// argmin with ties to the lower index.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hyptok {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kAcoshEps = 1e-8f;
constexpr float kGradEps = 1e-6f;  // coherence distance clamp
constexpr float kEpsNorm = 1e-8f;
constexpr float kExpZeroTol = 1e-6f;
constexpr float kThresholdCap = 1e6f;

// acosh(x) = log(x + sqrt(x^2 - 1)) for x >= 1, each operation rounded as
// the plain version rounds it (the square is not fused into the subtract).
__device__ __forceinline__ float acosh_log(float x) {
  return logf(x + sqrtf(__fmul_rn(x, x) - 1.0f));
}

__device__ __forceinline__ float warp_sum_float(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Keep the lower (value, index) pair; ties go to the lower index.
__device__ __forceinline__ void argmin_step(float& v, int& i, float ov,
                                            int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    argmin_step(v, i, __shfl_xor_sync(kFull, v, o),
                __shfl_xor_sync(kFull, i, o));
  }
}

}  // namespace hyptok
