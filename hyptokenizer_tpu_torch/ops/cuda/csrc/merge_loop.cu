// Kernel K4: a chunk of the distance-only greedy merge loop, in one launch.
//
// Replaces the TPU kernel hyptokenizer_tpu/ops/pallas/merge_loop.py:81
// (`_kernel`, reached through `_run_chunk` :245 and `run_merges_chunk`
// :348). Semantics are those of the plain version,
// hyptokenizer_tpu_torch/tokenizer/state.py `run_merges_plain` (the port of
// the JAX package's `_run_merges_xla`), to the same halts: up to n_steps
// steps while not `stopped`, each
//
//   global argmin of best_dist (lowest index on ties) -> if best < thr and
//   vocab < cap: the length-weighted geodesic midpoint of (i, j = best_j[i])
//   re-projected onto the sheet and written at row vocab; history, length,
//   merge distance; row i invalidated iff best_j[i] == j; the new column
//   folded into every row r < vocab with a strict < (the length gate when
//   max_token_len > 0) -> else the adaptive-threshold escape (x empty_growth
//   after empty_after empty rounds) or, without adaptation, a stop after
//   empty_stop -> step += 1, periodic threshold growth, stop at capacity.
//
// The TPU kernel ignores max_token_len; its XLA oracle applies it, and so do
// this kernel and its plain version. The (n8, 128) lane layout, the masked
// sum reads and writes, the 128-lane padded rows and the (G, 128, 128) fold
// tiles of the TPU kernel are TPU workarounds and are gone: this kernel works
// on the (max_v, d1) buffers directly, with no limit on d1: the new row sits
// in shared memory up to kSmemRow coordinates, beyond that in a per-block
// row of a global scratch buffer.
//
// Design (simple first): one cooperative persistent grid per chunk, sized by
// the occupancy query times the SM count. Rows are owned in 32-row chunks,
// chunk c by block c % grid, for both the argmin and the fold, so best_dist
// and best_j of a row are only ever touched by one block and a step needs
// ONE grid-wide barrier: each block writes its partial (best, i, best_j[i])
// to a buffer indexed by step parity, all blocks meet, and every block
// reduces all partials itself and so holds the same (best, i, j) and the
// same loop scalars (kept in shared memory, updated identically). On a
// merge, warp 0 of every block computes the midpoint into shared memory,
// block 0 writes it out with the bookkeeping, and each block's warps fold
// the new column into its rows below vocab, one row per warp at a time
// (coalesced lanes over the coordinates). Rows and lengths written by block
// 0 are read by the others only after a later barrier, through L2 (__ldcg).
//
// Bound. One step reads every active row once (d1 x 4 B) and reads and
// writes its best_dist/best_j: about 428 B per active row at d=100. At a
// full 50,176-row vocabulary that is 21.5 MB per step, 6.4 us at 3.35 TB/s;
// at 10k rows 1.3 us. The fold's 2 x d1 FLOP per row are far below the fp32
// rate. At small vocabularies the per-step grid barrier and the serial
// scalar work dominate; that is expected here and is not tuned.
//
// Numerics: float32 with the plain version's formulas (lorentz
// geodesic_point, project_to_hyperboloid, the log-form acosh with the
// 1 + ACOSH_EPS clamp, division by sqrt(c)); the midpoint's products and
// sums use __fmul_rn/__fadd_rn so that nvcc cannot fuse them out of the
// plain version's order. The grams are summed in another order than the
// plain version's matmul, so rows and candidate distances agree to float32
// rounding (evals/selfcheck.py's step-level lockstep bounds the gap).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace hyptok;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // rows per ownership chunk
constexpr int kSmemRow = 8192;  // the new row in shared memory up to this d1

inline int row_smem_bytes(int d1) {
  return d1 <= kSmemRow ? d1 * (int)sizeof(float) : 0;
}

// Loop scalars, in this order in the `si` and `sf` arrays (merge_loop.py).
enum { S_VOCAB, S_NM, S_STEP, S_EMPTY, S_STOPPED, S_COUNT };
enum { F_THR, F_C, F_COUNT };

struct Params {
  float* emb;          // (max_v, d1)
  int* lengths;        // (max_v,)
  float* best_dist;    // (max_v,)
  int* best_j;         // (max_v,)
  int* merges;         // (max_v, 2)
  float* merge_dists;  // (max_v,)
  int* si;             // (S_COUNT,)
  float* sf;           // (F_COUNT,)
  float* part_v;       // (2, grid) partial minima, by step parity
  int* part_i;         // (2, grid) their rows
  int* part_j;         // (2, grid) their rows' best_j
  unsigned* barrier;   // (2,) arrival count, generation
  float* x_scratch;    // (grid, d1) the new row per block, when d1 > kSmemRow
  int max_v, d1, cap, n_steps, max_token_len;
  int adaptive, growth_every, empty_after, empty_stop;
  float growth, empty_growth;
};

// Row of the k-th row owned by block b of a grid of g blocks.
__device__ __forceinline__ int owned_row(int k, int b, int g) {
  return ((k / kChunk) * g + b) * kChunk + (k % kChunk);
}

// All blocks meet; writes before it are visible after it (the cooperative
// launch makes every block resident, so spinning cannot deadlock).
__device__ void grid_barrier(unsigned* barrier, unsigned n_blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = barrier + 1;
    const unsigned my_gen = *gen;
    __threadfence();
    if (atomicAdd(barrier, 1u) == n_blocks - 1) {
      atomicExch(barrier, 0u);
      __threadfence();
      atomicAdd(barrier + 1, 1u);
    } else {
      while (*gen == my_gen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) merge_loop_kernel(Params p) {
  extern __shared__ float s_row[];  // (d1,) the new row, d1 <= kSmemRow
  __shared__ int s_i[S_COUNT];
  __shared__ float s_f[F_COUNT];
  __shared__ float s_red_v[kWarps];
  __shared__ int s_red_i[kWarps];
  __shared__ float s_best;
  __shared__ int s_bi, s_bj;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int g = gridDim.x;
  float* s_x = p.x_scratch ? p.x_scratch + (size_t)b * p.d1 : s_row;
  if (tid < S_COUNT) s_i[tid] = p.si[tid];
  if (tid < F_COUNT) s_f[tid] = p.sf[tid];
  __syncthreads();

  for (int s = 0; s < p.n_steps; ++s) {
    if (s_i[S_STOPPED]) break;
    const int par = s & 1;

    // 1. This block's partial argmin over its rows (all max_v rows, as the
    // plain version's argmin), lowest row on ties.
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int k = tid;; k += kThreads) {
      const int r = owned_row(k, b, g);
      if (r >= p.max_v) break;
      const float v = p.best_dist[r];
      if (v < bv) {
        bv = v;
        bi = r;
      }
    }
    warp_argmin(bv, bi);
    if (lane == 0) {
      s_red_v[warp] = bv;
      s_red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = s_red_v[lane];
      bi = s_red_i[lane];
      warp_argmin(bv, bi);
      if (lane == 0) {
        p.part_v[par * g + b] = bv;
        p.part_i[par * g + b] = bi;
        p.part_j[par * g + b] = bi == INT_MAX ? 0 : p.best_j[bi];
      }
    }
    grid_barrier(p.barrier, (unsigned)g);

    // 2. Every block reduces all partials to the same (best, i, j).
    // Rows are owned by one block each, so the winning row names its
    // partial, which carries its best_j.
    if (warp == 0) {
      float v = INFINITY;
      int i = INT_MAX;
      int j = 0;
      for (int q = lane; q < g; q += 32) {
        const float qv = __ldcg(p.part_v + par * g + q);
        const int qi = __ldcg(p.part_i + par * g + q);
        if (qv < v || (qv == v && qi < i)) {
          v = qv;
          i = qi;
          j = __ldcg(p.part_j + par * g + q);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, o);
        const int oi = __shfl_xor_sync(kFull, i, o);
        const int oj = __shfl_xor_sync(kFull, j, o);
        if (ov < v || (ov == v && oi < i)) {
          v = ov;
          i = oi;
          j = oj;
        }
      }
      if (lane == 0) {
        s_best = v;
        s_bi = i;
        s_bj = j;
      }
    }
    __syncthreads();

    const int vocab = s_i[S_VOCAB];
    const bool has = s_best < s_f[F_THR] && vocab < p.cap;
    int n_merged = 0;
    if (has) {
      n_merged = 1;
      const int i = s_bi;
      const int j = s_bj;
      const float c = s_f[F_C];
      const int len_new = __ldcg(p.lengths + i) + __ldcg(p.lengths + j);
      // 3. The midpoint (lorentz.geodesic_point, then the projection), by
      // warp 0 of every block, into shared memory.
      if (warp == 0) {
        const float* xi = p.emb + (size_t)i * p.d1;
        const float* xj = p.emb + (size_t)j * p.d1;
        float dot = 0.0f;
        for (int e = lane; e < p.d1; e += 32) {
          const float t = __fmul_rn(__ldcg(xi + e), __ldcg(xj + e));
          dot = e == 0 ? __fadd_rn(dot, t) : __fsub_rn(dot, t);
        }
        dot = warp_sum_float(dot);
        const int li = __ldcg(p.lengths + i);
        const int lj = __ldcg(p.lengths + j);
        const float w = (float)lj / (float)max(li + lj, 1);
        const float d = acosh_log(fmaxf(dot, 1.0f + kAcoshEps));
        const float a = __fmul_rn(1.0f - w, d);
        const float bb = __fmul_rn(w, d);
        const float num_x = __fmul_rn(expf(-bb), 1.0f - expf(-2.0f * a));
        const float num_y = __fmul_rn(expf(-a), 1.0f - expf(-2.0f * bb));
        const float den = fmaxf(1.0f - expf(-2.0f * d), kEpsNorm);
        const bool degenerate = d < kExpZeroTol;
        float sq = 0.0f;
        for (int e = lane; e < p.d1; e += 32) {
          if (e == 0) continue;
          const float x = __ldcg(xi + e);
          const float v =
              degenerate ? x
                         : __fadd_rn(__fmul_rn(num_x, x),
                                     __fmul_rn(num_y, __ldcg(xj + e))) / den;
          s_x[e] = v;
          sq = __fadd_rn(sq, __fmul_rn(v, v));
        }
        sq = warp_sum_float(sq);
        if (lane == 0) s_x[0] = sqrtf(__fadd_rn(1.0f, __fmul_rn(c, sq)));
      }
      __syncthreads();
      if (b == 0) {
        float* out = p.emb + (size_t)vocab * p.d1;
        for (int e = tid; e < p.d1; e += kThreads) out[e] = s_x[e];
        if (tid == 0) {
          const int nm = s_i[S_NM];
          p.lengths[vocab] = len_new;
          p.merges[2 * nm] = i;
          p.merges[2 * nm + 1] = j;
          p.merge_dists[nm] = s_best;
        }
      }
      // 4. The fold: each warp takes this block's rows below vocab, one at
      // a time. Row i is invalidated iff its tracked best was consumed.
      const float sqrt_c = sqrtf(c);
      const float x0 = s_x[0];
      for (int k = warp;; k += kWarps) {
        const int r = owned_row(k, b, g);
        if (r >= vocab) break;
        const float* row = p.emb + (size_t)r * p.d1;
        float acc = 0.0f;
        for (int e = lane + 1; e < p.d1; e += 32) {
          acc = fmaf(s_x[e], __ldcg(row + e), acc);
        }
        acc = warp_sum_float(acc);
        if (lane == 0) {
          const float gram = __fmul_rn(x0, __ldcg(row)) - acc;
          float best = p.best_dist[r];
          const bool inval = r == i && p.best_j[r] == j;
          if (inval) best = INFINITY;
          const bool gate = p.max_token_len <= 0 ||
                            __ldcg(p.lengths + r) + len_new <= p.max_token_len;
          const float dnew =
              acosh_log(fmaxf(gram, 1.0f + kAcoshEps)) / sqrt_c;
          if (gate && dnew < best) {
            p.best_dist[r] = dnew;
            p.best_j[r] = vocab;
          } else if (inval) {
            p.best_dist[r] = INFINITY;
          }
        }
      }
    }
    __syncthreads();

    // 5. The loop scalars, identically in every block (state.merge_step).
    if (tid == 0) {
      float thr = s_f[F_THR];
      if (n_merged) {
        s_i[S_VOCAB] += 1;
        s_i[S_NM] += 1;
        s_i[S_EMPTY] = 0;
      } else {
        const int empty = s_i[S_EMPTY] + 1;
        if (p.adaptive) {
          const bool grow = empty >= p.empty_after;
          thr = fminf(grow ? thr * p.empty_growth : thr, kThresholdCap);
          s_i[S_EMPTY] = grow ? 0 : empty;
        } else {
          s_i[S_EMPTY] = empty;
          s_i[S_STOPPED] = empty >= p.empty_stop;
        }
      }
      const int step = s_i[S_STEP] + 1;
      s_i[S_STEP] = step;
      if (p.adaptive && p.growth_every > 0) {
        thr = fminf(step % p.growth_every == 0 ? thr * p.growth : thr,
                    kThresholdCap);
      }
      s_f[F_THR] = thr;
      if (s_i[S_VOCAB] >= p.cap) s_i[S_STOPPED] = 1;
    }
    __syncthreads();
  }

  if (b == 0) {
    if (tid < S_COUNT) p.si[tid] = s_i[tid];
    if (tid < F_COUNT) p.sf[tid] = s_f[tid];
  }
}

}  // namespace

// Blocks of the cooperative grid on the current device (0 on error): the
// wrapper sizes the partials and passes the count back to the launch.
extern "C" int merge_loop_grid_size(int d1) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return 0;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, merge_loop_kernel, kThreads, row_smem_bytes(d1)) !=
      cudaSuccess) {
    return 0;
  }
  return per_sm * sms;
}

extern "C" int merge_loop_launch(
    void* emb, void* lengths, void* best_dist, void* best_j, void* merges,
    void* merge_dists, void* si, void* sf, void* part_v, void* part_i,
    void* part_j, void* barrier, void* x_scratch, int grid, int max_v,
    int d1, int cap, int n_steps, int max_token_len, int adaptive,
    int growth_every, float growth, int empty_after, float empty_growth,
    int empty_stop, void* stream) {
  if (grid < 1 || d1 < 1 || max_v < 1) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.emb = static_cast<float*>(emb);
  p.lengths = static_cast<int*>(lengths);
  p.best_dist = static_cast<float*>(best_dist);
  p.best_j = static_cast<int*>(best_j);
  p.merges = static_cast<int*>(merges);
  p.merge_dists = static_cast<float*>(merge_dists);
  p.si = static_cast<int*>(si);
  p.sf = static_cast<float*>(sf);
  p.part_v = static_cast<float*>(part_v);
  p.part_i = static_cast<int*>(part_i);
  p.part_j = static_cast<int*>(part_j);
  p.barrier = static_cast<unsigned*>(barrier);
  const int smem = row_smem_bytes(d1);
  p.x_scratch = smem > 0 ? nullptr : static_cast<float*>(x_scratch);
  p.max_v = max_v;
  p.d1 = d1;
  p.cap = cap;
  p.n_steps = n_steps;
  p.max_token_len = max_token_len;
  p.adaptive = adaptive;
  p.growth_every = growth_every;
  p.growth = growth;
  p.empty_after = empty_after;
  p.empty_growth = empty_growth;
  p.empty_stop = empty_stop;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)merge_loop_kernel, dim3(grid), dim3(kThreads), args,
      (size_t)smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
