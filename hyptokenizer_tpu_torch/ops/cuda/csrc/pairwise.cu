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
// Design: the tensor cores, for states whose d+1 padded to a multiple of 8
// is at most kTcMaxDepth (the flagship's 101 -> 104). The JAX kernel runs
// its product at Precision.HIGHEST, and TF32 alone erases acosh's
// resolution near 1, so the gram is summed from a 3xTF32 split: a pre-pass
// (`split_kernel`) writes hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi)
// of every active row, zero-padded to the depth and to whole 128-row tiles,
// in the layout `wgmma` reads without swizzle: 64-row blocks of 8-coordinate
// steps of 8 x 4-float core matrices (ops/cuda/pairwise.tile_plan). A block
// of 256 threads (two warpgroups) takes work items of ops/cuda/pairwise.py's
// plan, largest first, from a counter: a 128-row tile (hi and lo, 106,496 B
// at depth 104, its spatial coordinates negated in shared memory, an exact
// sign flip) and a run of 64-row column tiles from the diagonal on, which
// one thread streams through a two-stage ring with bulk copies
// (cp.async.bulk, completion on an mbarrier), the next tile's copy in
// flight during a tile's products. Each warpgroup sums its 64 x 64 gram with
// `wgmma.m64n64k8.f32.tf32.tf32`, per 8 coordinates lo*hi, hi*lo, then
// hi*hi, into one fp32 accumulator (the small terms first, as CUTLASS's
// fast-accurate fp32 does; lo*lo is dropped, about 2^-22 of each product).
// The epilogue clamps, masks col > row and col < vocab, and keeps a running
// (min, argmin) per row on the accumulator fragments (strict <, columns in
// increasing order); at the end of an item the four lanes of a row merge
// theirs, and one atomicMin per row on the 64-bit key
// (float bits << 32 | col) keeps the lowest value and, among equal values,
// the lowest column across blocks (the clamped value is positive, so its
// bits order like unsigned integers). A last pass (`finish_kernel`) writes
// acosh(min)/sqrt(c). Wider states run the earlier fp32 FFMA kernel
// (`pairwise_kernel` below), which stages any depth in slabs.
//
// Bound. With all V = 50,176 rows active the upper triangle is about
// V^2/2 x 101 x 2 = 2.5e11 fp32-accurate FLOP. At the card's fastest
// fp32-accurate rate, three TF32 products per product at 495 TFLOP/s
// dense, that is 1.54 ms; at 67 TFLOP/s fp32 outside the tensor cores,
// 3.8 ms. The bytes are a few MB (42 MB of split operands, mostly served
// from L2).
//
// The FFMA kernel: a block owns a tile of kTile rows, kept in shared memory
// pre-multiplied by the metric signature for its whole sweep (when
// d1 <= kDepth; a wider state is staged in slabs of kDepth coordinates,
// the row tile's slab beside each column tile's, so any d1 fits), and
// sweeps column tiles of kTile rows staged in shared memory, from the
// diagonal tile to the last tile of the active prefix. Each of the 256
// threads holds a 4 x 4 register micro-tile of the gram (rows ty + 16a,
// columns tx + 16b), summed in fp32 FFMA over the whole depth. Each thread
// keeps a running (min, argmin) per row over its columns in increasing
// column order with a strict <; the 16 threads of a row merge theirs with
// ties to the lower column. The distance is recovered once per row with the
// log-form acosh of the port (the JAX kernel uses jnp.arccosh here; the two
// agree to fp32 rounding). A block takes row tiles i and n-1-i, so every
// block sweeps about n+1 column tiles.

#include <cuda_runtime.h>
#include <limits.h>
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

namespace {

using namespace hyptok;

// ---------------------------------------------------------------- tensor cores

constexpr int kTcThreads = 256;   // two warpgroups, 64 rows each
constexpr int kSubRows = 64;      // rows of a block of the split layout
constexpr int kRowTile = 128;     // rows of a work item's tile
constexpr int kColTile = 64;      // columns of a streamed tile (wgmma's N)
constexpr int kTcMaxDepth = 112;  // depth whose tiles fit shared memory
constexpr int kStepFloats = kSubRows * 8;  // one 8-coordinate step, a block
// Descriptor strides of the unswizzled K-major layout, in bytes: between
// the two core matrices of a step along K (LBO) and between 8-row groups
// (SBO).
constexpr int kLbo = 128;
constexpr int kSbo = 256;

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// The 3xTF32 operands of the active rows in the split layout (rows past
// vocab and coordinates past d1 are zero), and the row keys (all ones) and
// the work counter (zero).
__global__ void split_kernel(const float* __restrict__ emb, float* hi,
                             float* lo, unsigned long long* keys,
                             int* next_item, int d1, int vocab, int kp,
                             int n_rows) {
  const int block_floats = kSubRows * kp;
  const int n = n_rows * kp;
  for (int f = blockIdx.x * blockDim.x + threadIdx.x; f < n;
       f += gridDim.x * blockDim.x) {
    const int b = f / block_floats;
    const int g = f % block_floats;
    const int rem = g % kStepFloats;
    const int row = b * kSubRows + (rem >> 6) * 8 + ((rem & 31) >> 2);
    const int k = (g / kStepFloats) * 8 + ((rem >> 5) & 1) * 4 + (rem & 3);
    const float x =
        (row < vocab && k < d1) ? emb[(size_t)row * d1 + k] : 0.0f;
    const float h = tf32_rna(x);
    hi[f] = h;
    lo[f] = tf32_rna(x - h);
    if (f < n_rows) keys[f] = ~0ull;
    if (f == 0) *next_item = 0;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The wgmma descriptor of an operand tile at `p` in the split layout.
__device__ __forceinline__ uint64_t desc_of(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(kLbo >> 4) << 16) | ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Keeps the compiler from moving accesses of the accumulator across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a * b over 8 coordinates: a 64 x 64 tile of the warpgroup.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kTcThreads, 1)
pairwise_tc_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                   unsigned long long* keys, const int* __restrict__ items,
                   int n_items, int* next_item, int kp, int vocab) {
  extern __shared__ __align__(128) float tc_smem[];
  __shared__ __align__(8) uint64_t bars[3];  // the row tile, two stages
  __shared__ int s_item;
  const int block_floats = kSubRows * kp;
  const uint32_t block_bytes = (uint32_t)block_floats * 4;
  float* a_hi = tc_smem;                     // 2 blocks
  float* a_lo = a_hi + 2 * block_floats;     // 2 blocks
  float* stage0 = a_lo + 2 * block_floats;   // per stage: hi, then lo
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int wrow = ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int n_steps = kp / 8;

  if (tid == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint32_t a_par = 0;
  uint32_t b_par = 0;  // bit s: the parity stage s's barrier waits for

  auto load_col = [&](int s, int ct) {
    float* dst = stage0 + (size_t)s * 2 * block_floats;
    mbar_expect(&bars[1 + s], 2 * block_bytes);
    bulk_load(dst, hi + (size_t)ct * block_floats, block_bytes, &bars[1 + s]);
    bulk_load(dst + block_floats, lo + (size_t)ct * block_floats, block_bytes,
              &bars[1 + s]);
  };

  for (;;) {
    // Every warpgroup is done with the last item's tiles.
    if (tid == 0) s_item = atomicAdd(next_item, 1);
    __syncthreads();
    const int it = s_item;
    if (it >= n_items) break;
    const int rt = items[3 * it];
    const int ct0 = items[3 * it + 1];
    const int ct1 = items[3 * it + 2];
    if (tid == 0) {
      mbar_expect(&bars[0], 4 * block_bytes);
      bulk_load(a_hi, hi + (size_t)rt * 2 * block_floats, 2 * block_bytes,
                &bars[0]);
      bulk_load(a_lo, lo + (size_t)rt * 2 * block_floats, 2 * block_bytes,
                &bars[0]);
      for (int j = 0; j < 2 && ct0 + j < ct1; ++j) load_col(j, ct0 + j);
    }
    mbar_wait(&bars[0], a_par);
    a_par ^= 1;
    // The metric signature on the row operand: negate the spatial
    // coordinates (an exact sign flip) of hi and lo, which lie back to back.
    for (int f = tid; f < 4 * block_floats; f += kTcThreads) {
      const int g = f % block_floats;
      const int rem = g % kStepFloats;
      const int k = (g / kStepFloats) * 8 + ((rem >> 5) & 1) * 4 + (rem & 3);
      if (k != 0) a_hi[f] = -a_hi[f];
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    const int row0 = rt * kRowTile + wg * kSubRows + wrow;
    float run_m[2] = {INFINITY, INFINITY};
    int run_j[2] = {INT_MAX, INT_MAX};
    const float* ah = a_hi + wg * block_floats;
    const float* al = a_lo + wg * block_floats;
    for (int ct = ct0, n = 0; ct < ct1; ++ct, ++n) {
      const int s = n & 1;
      const float* bh = stage0 + (size_t)s * 2 * block_floats;
      const float* bl = bh + block_floats;
      mbar_wait(&bars[1 + s], (b_par >> s) & 1u);
      b_par ^= 1u << s;
      float acc[32];
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      for (int ks = 0; ks < n_steps; ++ks) {
        const int o = ks * kStepFloats;
        wgmma_tf32(acc, desc_of(al + o), desc_of(bh + o), ks > 0);
        wgmma_tf32(acc, desc_of(ah + o), desc_of(bl + o), 1);
        wgmma_tf32(acc, desc_of(ah + o), desc_of(bh + o), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);
      // Both warpgroups are done with stage s: refill it.
      __syncthreads();
      if (tid == 0 && ct + 2 < ct1) load_col(s, ct + 2);
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int r = (v >> 1) & 1;
        const int row = row0 + 8 * r;
        const int col = ct * kColTile + (lane & 3) * 2 + (v & 1) + 8 * (v >> 2);
        if (col > row && col < vocab) {
          const float m = fmaxf(acc[v], 1.0f + kAcoshEps);
          if (m < run_m[r]) {
            run_m[r] = m;
            run_j[r] = col;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = run_m[r];
      int j = run_j[r];
      for (int o = 1; o < 4; o <<= 1) {
        argmin_step(m, j, __shfl_xor_sync(kFull, m, o),
                    __shfl_xor_sync(kFull, j, o));
      }
      if ((lane & 3) == 0 && j != INT_MAX) {
        atomicMin(&keys[row0 + 8 * r],
                  ((unsigned long long)__float_as_uint(m) << 32) |
                      (unsigned)j);
      }
    }
  }
}

// best_dist/best_j of the active rows from their keys.
__global__ void finish_kernel(const unsigned long long* __restrict__ keys,
                              float* best_dist, int* best_j, int vocab,
                              float sqrt_c) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= vocab) return;
  const unsigned long long key = keys[row];
  if (key == ~0ull) {
    best_dist[row] = INFINITY;
    best_j[row] = 0;
  } else {
    best_dist[row] = acosh_log(__uint_as_float((unsigned)(key >> 32))) / sqrt_c;
    best_j[row] = (int)(key & 0xffffffffu);
  }
}

}  // namespace

extern "C" int pairwise_tc_smem_bytes(int kp) {
  return 8 * kSubRows * kp * (int)sizeof(float);
}

// The tensor-core path (tile_plan in ops/cuda/pairwise.py): the split
// pre-pass into hi/lo (n_rows x kp floats each, n_rows a multiple of
// kRowTile), keys (n_rows) and the work counter, the products over the
// plan's n_items items (row tile, first and end column tile) on `grid`
// blocks, and the finishing pass.
extern "C" int pairwise_tc_launch(void* emb, void* best_dist, void* best_j,
                                  int d1, int vocab, float c, void* hi,
                                  void* lo, void* keys, void* items,
                                  int n_items, void* next_item, int n_rows,
                                  int kp, int grid, void* stream) {
  if (vocab <= 0) return (int)cudaSuccess;
  if (kp % 8 != 0 || kp < d1 || kp > kTcMaxDepth || n_rows % kRowTile != 0 ||
      n_rows < vocab || (long long)n_rows * kp > INT_MAX || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  split_kernel<<<264, 256, 0, st>>>(
      static_cast<const float*>(emb), static_cast<float*>(hi),
      static_cast<float*>(lo), static_cast<unsigned long long*>(keys),
      static_cast<int*>(next_item), d1, vocab, kp, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = pairwise_tc_smem_bytes(kp);
  err = cudaFuncSetAttribute(pairwise_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_items > 0) {
    pairwise_tc_kernel<<<grid, kTcThreads, smem, st>>>(
        static_cast<const float*>(hi), static_cast<const float*>(lo),
        static_cast<unsigned long long*>(keys), static_cast<const int*>(items),
        n_items, static_cast<int*>(next_item), kp, vocab);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  finish_kernel<<<(vocab + 255) / 256, 256, 0, st>>>(
      static_cast<const unsigned long long*>(keys),
      static_cast<float*>(best_dist), static_cast<int*>(best_j), vocab,
      sqrtf(c));
  return (int)cudaGetLastError();
}
