// Device helpers shared by the port's kernels: the JAX package's clamp
// constants (hyptokenizer_tpu/ops/lorentz.py), the log-form acosh of the
// plain version (ops/lorentz.py `acosh`), warp sums, the (value, index)
// argmin with ties to the lower index, the geodesic point's coefficients,
// the token hashes' composition and the sorted-table membership (K1, K2
// and the sync's scoring), and the row ownership and grid barrier of the
// cooperative grids (K2's fold, K4).
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

// Coefficients of the length-weighted geodesic point of rows ci and cj
// (lorentz.geodesic_point):
// point = degenerate ? x_ci : (num_x * x_ci + num_y * x_cj) / den.
struct Geodesic {
  float num_x, num_y, den;
  bool degenerate;
};

// From the pair's Minkowski dot and token lengths.
__device__ inline Geodesic geodesic_coeffs(float dot, int li, int lj) {
  const float w = (float)lj / (float)max(li + lj, 1);
  const float d = acosh_log(fmaxf(dot, 1.0f + kAcoshEps));
  const float a = (1.0f - w) * d;
  const float b = w * d;
  Geodesic g;
  g.num_x = expf(-b) * (1.0f - expf(-2.0f * a));
  g.num_y = expf(-a) * (1.0f - expf(-2.0f * b));
  g.den = fmaxf(1.0f - expf(-2.0f * d), kEpsNorm);
  g.degenerate = d < kExpZeroTol;
  return g;
}

// The two rolling hashes' primes (tokenizer/scoring.py HASH_P1, HASH_P2).
constexpr int kHashP1 = 32749;
constexpr int kHashP2 = 32719;

// hash(a + b) from hash(a), hash(b) and the byte length of b
// (scoring.compose_hash), both residues: token_hash is (V, 2), powers
// (2, max_hash_len).
__device__ inline void compose_hash(const int* token_hash,
                                    const int* byte_lengths,
                                    const int* powers, int max_hash_len,
                                    int ci, int cj, int* h1, int* h2) {
  const int pw = min(byte_lengths[cj], max_hash_len - 1);
  *h1 = (token_hash[2 * ci] * powers[pw] + token_hash[2 * cj]) % kHashP1;
  *h2 = (token_hash[2 * ci + 1] * powers[max_hash_len + pw] +
         token_hash[2 * cj + 1]) % kHashP2;
}

// Membership of `key` in a sorted table of `len` entries whose first `size`
// are real (scoring.in_sorted_set).
__device__ inline bool in_sorted(const int* table, int len, int size,
                                 int key) {
  int a = 0;
  int b = len;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (table[mid] < key) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  const int pos = min(a, len - 1);
  return table[pos] == key && pos < size;
}

// Eight loads through L2 (ld.global.cg) of base[i[0..7]], sent back to
// back in one asm statement: left to itself, under register pressure the
// compiler moves each load next to its use and so serialises their
// latencies.
__device__ __forceinline__ void ldcg8(const float* base, const int (&i)[8],
                                      float (&x)[8]) {
  asm volatile(
      "ld.global.cg.f32 %0, [%8];\n\t"
      "ld.global.cg.f32 %1, [%9];\n\t"
      "ld.global.cg.f32 %2, [%10];\n\t"
      "ld.global.cg.f32 %3, [%11];\n\t"
      "ld.global.cg.f32 %4, [%12];\n\t"
      "ld.global.cg.f32 %5, [%13];\n\t"
      "ld.global.cg.f32 %6, [%14];\n\t"
      "ld.global.cg.f32 %7, [%15];"
      : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3]), "=f"(x[4]),
        "=f"(x[5]), "=f"(x[6]), "=f"(x[7])
      : "l"(base + i[0]), "l"(base + i[1]), "l"(base + i[2]),
        "l"(base + i[3]), "l"(base + i[4]), "l"(base + i[5]),
        "l"(base + i[6]), "l"(base + i[7])
      : "memory");
}

// Four loads through L2 from each of two rows, a[i[u]] and b[i[u]], sent
// back to back in one asm statement (as ldcg8).
__device__ __forceinline__ void ldcg_pair4(const float* a, const float* b,
                                           const int (&i)[4], float (&x)[4],
                                           float (&y)[4]) {
  asm volatile(
      "ld.global.cg.f32 %0, [%8];\n\t"
      "ld.global.cg.f32 %1, [%9];\n\t"
      "ld.global.cg.f32 %2, [%10];\n\t"
      "ld.global.cg.f32 %3, [%11];\n\t"
      "ld.global.cg.f32 %4, [%12];\n\t"
      "ld.global.cg.f32 %5, [%13];\n\t"
      "ld.global.cg.f32 %6, [%14];\n\t"
      "ld.global.cg.f32 %7, [%15];"
      : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3]), "=f"(y[0]),
        "=f"(y[1]), "=f"(y[2]), "=f"(y[3])
      : "l"(a + i[0]), "l"(a + i[1]), "l"(a + i[2]), "l"(a + i[3]),
        "l"(b + i[0]), "l"(b + i[1]), "l"(b + i[2]), "l"(b + i[3])
      : "memory");
}

// Rows are owned by the blocks of a cooperative grid in chunks of
// kOwnChunk rows: chunk c by block c % g.
constexpr int kOwnChunk = 32;

// Row of the k-th row owned by block b of a grid of g blocks.
__device__ __forceinline__ int owned_row(int k, int b, int g) {
  return ((k / kOwnChunk) * g + b) * kOwnChunk + (k % kOwnChunk);
}

// All blocks meet; writes before it are visible after it to loads that
// bypass L1 (__ldcg). `arrived` is one word, zeroed before the launch: each
// block adds 1 to it, block 0 adds 2^31 - (n_blocks - 1), so the last
// arrival flips its top bit and the low bits return to where they were (the
// scheme of cooperative_groups' grid sync: one atomic per block, no reset).
// The cooperative launch makes every block resident, so spinning cannot
// deadlock.
__device__ inline void grid_barrier(unsigned* arrived, unsigned n_blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (n_blocks - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(arrived, add);
    while (((old ^ *(volatile unsigned*)arrived) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Phase clock for tools/torch_step_profile.py. Built with -DHYPTOK_PROFILE,
// HYPTOK_MARK(k) makes thread 0 of block 0 add the SM cycles since its
// previous mark to phase k of `hyptok_profile` (k = -1 only restarts the
// clock), read back and zeroed by hyptok_profile_read; in the kernels' own
// build it is empty. A mark costs a clock read, a shared-memory word and
// one reduction sent to global memory without waiting for it.
#ifdef HYPTOK_PROFILE
constexpr int kProfilePhases = 16;
__device__ unsigned long long hyptok_profile[kProfilePhases];

__device__ __forceinline__ void profile_mark(int k) {
  __shared__ unsigned long long last;
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    const unsigned long long now = clock64();
    if (k >= 0) atomicAdd(&hyptok_profile[k], now - last);
    last = now;
  }
}
#define HYPTOK_MARK(k) hyptok::profile_mark(k)
#else
#define HYPTOK_MARK(k) ((void)0)
#endif

}  // namespace hyptok

#ifdef HYPTOK_PROFILE
extern "C" int hyptok_profile_read(unsigned long long* out) {
  const size_t n = sizeof(unsigned long long) * hyptok::kProfilePhases;
  cudaError_t err = cudaMemcpyFromSymbol(out, hyptok::hyptok_profile, n);
  if (err == cudaSuccess) {
    const unsigned long long zero[hyptok::kProfilePhases] = {};
    err = cudaMemcpyToSymbol(hyptok::hyptok_profile, zero, n);
  }
  return (int)err;
}
#endif
