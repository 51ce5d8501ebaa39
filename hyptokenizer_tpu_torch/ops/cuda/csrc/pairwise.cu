// Kernel K3: every row's closest partner j > i over a Minkowski gram that is
// never written out.
//
// Replaces the TPU kernel hyptokenizer_tpu/ops/pallas/pairwise.py:44
// (`_kernel`, reached through `pairwise_min_best` :88). Semantics are those
// of the plain version, hyptokenizer_tpu_torch/tokenizer/search.py
// `full_pass_best` with an empty history: for each row i < vocab_size,
// best_j[i] = argmin over vocab_size > j > i of <x_i, x_j>_L clamped to
// >= 1 + ACOSH_EPS (lowest column on ties), and
// best_dist[i] = acosh(min) / sqrt(c); a row with no valid column keeps
// (inf, 0), which the wrapper writes before the launch.
//
// Design (simple first). A block owns a tile of kTile rows, kept in shared
// memory pre-multiplied by the metric signature for its whole sweep (when
// d1 <= kDepth; a wider state is staged in slabs of kDepth coordinates,
// the row tile's slab beside each column tile's, so any d1 fits), and
// sweeps column tiles of kTile rows staged in shared memory, from the
// diagonal tile to the last tile of the active prefix: tiles wholly below
// the diagonal or wholly outside the prefix are skipped, as the TPU kernel
// skips them. Each of the 256 threads holds a 4 x 4 register micro-tile of
// the gram (rows ty + 16a, columns tx + 16b), summed in fp32 FFMA over the
// whole depth: no TF32 and no bf16 tensor-core path, since the JAX kernel
// runs at Precision.HIGHEST and TF32 erases acosh's resolution near 1.
// Each thread keeps a running (min, argmin) per row over its columns in
// increasing column order with a strict <; the 16 threads of a row merge
// theirs with ties to the lower column. The distance is recovered once per
// row with the log-form acosh of the port (the JAX kernel uses
// jnp.arccosh here; the two agree to fp32 rounding). A block takes row
// tiles i and n-1-i, so every block sweeps about n+1 column tiles.
//
// Bound. With all V = 50,176 rows active the upper triangle is about
// V^2/2 x 101 x 2 = 2.5e11 FLOP; at 67 TFLOP/s fp32 outside the tensor
// cores that is 3.8 ms, bound by operations (the bytes are a few MB). This
// design reads two shared-memory words per two FFMAs and does not reach
// that rate; a 3xTF32 split on the tensor cores is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace hyptok;

constexpr int kTile = 64;            // rows and columns per tile
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 each
constexpr int kStride = kTile + 1;   // padded shared row: conflict-free
constexpr int kDepth = 128;          // coordinates staged at a time

// Stage coordinates [k0, k1) of rows [tile * kTile, +kTile) of emb,
// transposed to [k - k0][row], into `dst`, times the signature when
// `signed_rows`. Rows past max_v are zero.
__device__ void stage(float* dst, const float* emb, int tile, int max_v,
                      int d1, int k0, int k1, bool signed_rows) {
  const int row0 = tile * kTile;
  const int w = k1 - k0;
  const int n = kTile * w;
  for (int f = threadIdx.x; f < n; f += kThreads) {
    const int r = f / w;
    const int k = k0 + f - r * w;
    float v = 0.0f;
    if (row0 + r < max_v) {
      v = emb[(size_t)(row0 + r) * d1 + k];
      if (signed_rows && k > 0) v = -v;
    }
    dst[(k - k0) * kStride + r] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const float* __restrict__ emb, float* __restrict__ best_dist,
                int* __restrict__ best_j, int max_v, int d1, int vocab,
                float sqrt_c) {
  extern __shared__ float smem[];
  const int depth = min(d1, kDepth);
  const bool resident = d1 <= kDepth;   // the row tile stays staged
  float* xs = smem;                     // [depth][kStride] signed row tile
  float* ys = smem + depth * kStride;   // [depth][kStride] column tile
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int n_tiles = (vocab + kTile - 1) / kTile;

  for (int pass = 0; pass < 2; ++pass) {
    const int it = pass == 0 ? blockIdx.x : n_tiles - 1 - blockIdx.x;
    if (pass == 1 && it <= (int)blockIdx.x) break;
    __syncthreads();
    if (resident) stage(xs, emb, it, max_v, d1, 0, d1, true);

    float run_min[4];
    int run_arg[4];
    for (int a = 0; a < 4; ++a) {
      run_min[a] = INFINITY;
      run_arg[a] = 0x7fffffff;
    }
    for (int jt = it; jt < n_tiles; ++jt) {
      float acc[4][4];
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      // The feature axis in slabs of `depth` coordinates (one slab, and the
      // row tile staged once per sweep, when d1 <= kDepth).
      for (int k0 = 0; k0 < d1; k0 += depth) {
        const int k1 = min(k0 + depth, d1);
        __syncthreads();
        if (!resident) stage(xs, emb, it, max_v, d1, k0, k1, true);
        stage(ys, emb, jt, max_v, d1, k0, k1, false);
        __syncthreads();
        for (int k = 0; k < k1 - k0; ++k) {
          float xv[4], yv[4];
          for (int a = 0; a < 4; ++a) xv[a] = xs[k * kStride + ty + 16 * a];
          for (int b = 0; b < 4; ++b) yv[b] = ys[k * kStride + tx + 16 * b];
          for (int a = 0; a < 4; ++a)
            for (int b = 0; b < 4; ++b)
              acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
        }
      }
      for (int a = 0; a < 4; ++a) {
        const int row = it * kTile + ty + 16 * a;
        for (int b = 0; b < 4; ++b) {
          const int col = jt * kTile + tx + 16 * b;
          if (col > row && col < vocab) {
            const float m = fmaxf(acc[a][b], 1.0f + kAcoshEps);
            if (m < run_min[a]) {
              run_min[a] = m;
              run_arg[a] = col;
            }
          }
        }
      }
    }
    // Merge the 16 threads of each row (lanes of one half-warp).
    for (int a = 0; a < 4; ++a) {
      float m = run_min[a];
      int j = run_arg[a];
      for (int o = 8; o > 0; o >>= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m, o);
        const int oj = __shfl_xor_sync(0xffffffffu, j, o);
        if (om < m || (om == m && oj < j)) {
          m = om;
          j = oj;
        }
      }
      const int row = it * kTile + ty + 16 * a;
      if (tx == 0 && row < vocab && row < max_v) {
        const bool found = m < INFINITY;
        best_dist[row] =
            found ? acosh_log(fmaxf(m, 1.0f + kAcoshEps)) / sqrt_c : INFINITY;
        best_j[row] = found ? j : 0;
      }
    }
  }
}

}  // namespace

extern "C" int pairwise_smem_bytes(int d1) {
  return 2 * (d1 < kDepth ? d1 : kDepth) * kStride * (int)sizeof(float);
}

extern "C" int pairwise_min_best_launch(void* emb, void* best_dist,
                                        void* best_j, int max_v, int d1,
                                        int vocab, float c, void* stream) {
  if (vocab <= 0) return (int)cudaSuccess;
  const int smem = pairwise_smem_bytes(d1);
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (vocab + kTile - 1) / kTile;
  const int blocks = (n_tiles + 1) / 2;
  pairwise_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<float*>(best_dist),
      static_cast<int*>(best_j), max_v, d1, vocab, sqrtf(c));
  return (int)cudaGetLastError();
}
