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
// tiles of the TPU kernel are TPU workarounds and are gone. The TPU kernel
// streams the embedding from HBM every step because VMEM cannot hold it;
// the card's shared memory (132 x 227 KB) holds the whole active
// embedding at d+1 = 101, so this kernel reads each row once per launch.
//
// Design. One cooperative persistent grid per chunk, one block of 1024
// threads per SM. Rows are owned in 32-row chunks, chunk c by block c % g
// (common.cuh `owned_row`), so a row's best_dist/best_j are only ever
// touched by its block. At launch each block copies the first `resident`
// of its owned rows (coordinates at a stride of 4 mod 8 floats, zero
// padded, best_dist, best_j, lengths) into dynamic shared memory;
// merge_loop.py `smem_plan` sizes that in whole chunks (all 384 owned rows
// per block at 50,176 slots and d+1 = 101, about 170 KB). Owned rows beyond
// it stay in global memory and take a warp per row, lanes over the
// coordinates, so no d is refused.
//
// A step: every block has published its partial (best, row, best_j[row])
// over its rows, in a buffer indexed by step parity; ONE grid barrier;
// every block reduces all partials to the same (best, i, j) and keeps the
// same loop scalars. On a merge, warp 0 of every block computes the
// midpoint from rows i and j in global memory (through L2, __ldcg) into
// shared memory; the block that owns slot vocab writes the new row, its
// length and the history to global memory and the row into its slab too;
// then each block folds the new column into its rows below vocab, one
// thread per resident row reading 16 bytes at a time (the stride puts a
// quarter warp's 8 rows in distinct banks; the new row's loads are
// broadcasts), and in the same pass takes its partial argmin for the next
// step: its rows
// change only in its own fold, so no block scans best_dist apart from its
// fold. A step without a merge changes no row and republishes the same
// partial. At the end each block writes its resident best_dist/best_j
// back.
//
// Bound. Read once, the chunk's data are small: at 28.9k active rows,
// d+1 = 101 and 4096 merges about 14 MB (4 us at 3.35 TB/s), so the bound
// is the fold's operations, 2 d1 + 8 per active row per merge (about
// 2.7e10 FLOP, 0.40 ms at 67 TFLOP/s, or 0.1 us per step). A step is
// bound by latency instead: the grid barrier (one L2 atomic per block, the
// scheme of cooperative_groups' grid sync), the partials' reduction and
// the midpoint's dependent L2 reads, a serial chain that no SM count
// shortens. Keeping the rows on chip and fusing the argmin into the fold
// take the per-step re-read of every row and the scan of all slots out of
// that chain; global loads that a step waits on go out together.
//
// A chain of per-step kernels in a CUDA graph was not built: a step needs
// at least two dependent kernels (the argmin, then the fold), two graph
// launches cost about what this design's whole step costs, and rows
// could no longer stay on chip between steps.
//
// Numerics: float32 with the plain version's formulas (lorentz
// geodesic_point, project_to_hyperboloid, the log-form acosh with the
// 1 + ACOSH_EPS clamp, division by sqrt(c)); the midpoint's products and
// sums use __fmul_rn/__fadd_rn so that nvcc cannot fuse them out of the
// plain version's order. The fold's grams are summed per thread in two
// chains (odd and even coordinates), another order than the plain
// version's matmul, so rows and candidate distances agree to float32
// rounding (evals/selfcheck.py's step-level lockstep bounds the gap).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace hyptok;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;  // loads in flight per lane before use
constexpr int kPartBatch = 8;  // partials a lane loads at once (32 x 8)

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
  unsigned* barrier;   // (1,) arrivals (common.cuh grid_barrier), zeroed
  float* x_scratch;    // (grid, d1) the new row per block, if not in smem
  int max_v, d1, cap, n_steps, max_token_len;
  int adaptive, growth_every, empty_after, empty_stop;
  float growth, empty_growth;
  int resident;        // owned rows per block kept in shared memory
  int stride;          // floats per resident row: d1 rounded up to 4 mod 8
  int row_floats;      // the new row in shared memory (d1), or 0
};

// This block's rows in shared memory, and the new row as the fold reads it.
struct Slab {
  float* emb;  // (resident, stride), zero past d1
  float* y;    // (stride,) the new row's spatial part: y[0] and past d1 zero
  float* bd;   // (resident,)
  int* bj;     // (resident,)
  int* len;    // (resident,)
  int n4;      // float4s per row that hold coordinates
};

// Keep the lower (value, row) pair, with the row's best_j.
__device__ __forceinline__ void argmin3(float& v, int& i, int& j, float ov,
                                        int oi, int oj) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
    j = oj;
  }
}

__device__ __forceinline__ void warp_argmin3(float& v, int& i, int& j) {
  for (int o = 16; o > 0; o >>= 1) {
    argmin3(v, i, j, __shfl_xor_sync(kFull, v, o),
            __shfl_xor_sync(kFull, i, o), __shfl_xor_sync(kFull, j, o));
  }
}

// The new column's distance to a row whose Minkowski gram with it is
// `gram`, then the row's candidate update (state.merge_pair): row i is
// invalidated iff its tracked best was the consumed pair, and the column
// replaces the candidate iff it passes the length gate and is strictly
// closer. Returns whether best/bj changed.
__device__ __forceinline__ bool fold_row(const Params& p, float gram, int r,
                                         int len_r, int i, int j, int vocab,
                                         int len_new, float sqrt_c,
                                         float& best, int& bj) {
  const bool inval = r == i && bj == j;
  if (inval) best = INFINITY;
  const bool gate =
      p.max_token_len <= 0 || len_r + len_new <= p.max_token_len;
  const float dnew = acosh_log(fmaxf(gram, 1.0f + kAcoshEps)) / sqrt_c;
  if (gate && dnew < best) {
    best = dnew;
    bj = vocab;
    return true;
  }
  return inval;
}

// One pass over this block's rows: with `merge`, fold the new column (slot
// `vocab`, coordinates s_x) into its rows below vocab; in the same pass,
// the block's (best, row, best_j[row]) over all its rows, lowest row on
// ties, into s_own (valid after the closing __syncthreads).
__device__ void fold_pass(const Params& p, const Slab& sl, bool merge,
                          int i, int j, int vocab, int len_new, float sqrt_c,
                          const float* s_x, float* s_red_v, int* s_red_i,
                          int* s_red_j, float* s_own_v, int* s_own_i,
                          int* s_own_j) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int g = gridDim.x;
  float bv = INFINITY;
  int bi = INT_MAX;
  int bjv = 0;
  const float x0 = s_x[0];

  // Resident rows: a thread per row, its coordinates in shared memory.
  for (int k = tid; k < p.resident; k += kThreads) {
    const int r = owned_row(k, b, g);
    if (r >= p.max_v) break;
    float best = sl.bd[k];
    int bj = sl.bj[k];
    if (merge && r < vocab) {
      // 16-byte loads: the new row's is a broadcast, and the rows' stride
      // (4 mod 8 floats) puts a quarter warp's 8 rows in distinct banks.
      const float* row = sl.emb + (size_t)k * p.stride;
      const float4* x4 = reinterpret_cast<const float4*>(row);
      const float4* y4 = reinterpret_cast<const float4*>(sl.y);
      // Two chains, even and odd coordinates, each in increasing order.
      float a0 = 0.0f;
      float a1 = 0.0f;
      for (int q = 0; q < sl.n4; ++q) {
        const float4 x = x4[q];
        const float4 y = y4[q];
        a0 = fmaf(y.z, x.z, fmaf(y.x, x.x, a0));
        a1 = fmaf(y.w, x.w, fmaf(y.y, x.y, a1));
      }
      const float gram = __fmul_rn(x0, row[0]) - (a1 + a0);
      if (fold_row(p, gram, r, sl.len[k], i, j, vocab, len_new, sqrt_c,
                   best, bj)) {
        sl.bd[k] = best;
        sl.bj[k] = bj;
      }
    }
    argmin3(bv, bi, bjv, best, r, bj);
  }

  // Rows past the slab: a warp per row, lanes over the coordinates, the
  // candidates in global memory (only this block touches them).
  for (int k = p.resident + warp;; k += kWarps) {
    const int r = owned_row(k, b, g);
    if (r >= p.max_v) break;
    if (merge && r < vocab) {
      const float* row = p.emb + (size_t)r * p.d1;
      float acc = 0.0f;
      for (int e0 = 1 + lane; e0 < p.d1; e0 += 32 * kPer) {
        float x[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int e = e0 + 32 * u;
          x[u] = e < p.d1 ? __ldcg(row + e) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int e = e0 + 32 * u;
          if (e < p.d1) acc = fmaf(s_x[e], x[u], acc);
        }
      }
      acc = warp_sum_float(acc);
      if (lane == 0) {
        float best = p.best_dist[r];
        int bj = p.best_j[r];
        const float gram = __fmul_rn(x0, __ldcg(row)) - acc;
        if (fold_row(p, gram, r, __ldcg(p.lengths + r), i, j, vocab,
                     len_new, sqrt_c, best, bj)) {
          p.best_dist[r] = best;
          p.best_j[r] = bj;
        }
        argmin3(bv, bi, bjv, best, r, bj);
      }
    } else if (lane == 0) {
      argmin3(bv, bi, bjv, p.best_dist[r], r, p.best_j[r]);
    }
  }

  HYPTOK_MARK(6);
  warp_argmin3(bv, bi, bjv);
  if (lane == 0) {
    s_red_v[warp] = bv;
    s_red_i[warp] = bi;
    s_red_j[warp] = bjv;
  }
  __syncthreads();
  if (warp == 0) {
    bv = s_red_v[lane];
    bi = s_red_i[lane];
    bjv = s_red_j[lane];
    warp_argmin3(bv, bi, bjv);
    if (lane == 0) {
      *s_own_v = bv;
      *s_own_i = bi;
      *s_own_j = bi == INT_MAX ? 0 : bjv;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) merge_loop_kernel(Params p) {
  extern __shared__ float s_dyn[];
  __shared__ int s_i[S_COUNT];
  __shared__ float s_f[F_COUNT];
  __shared__ float s_red_v[kWarps];
  __shared__ int s_red_i[kWarps];
  __shared__ int s_red_j[kWarps];
  __shared__ float s_best, s_own_v;
  __shared__ int s_win_i, s_win_j, s_own_i, s_own_j, s_len_new;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int g = gridDim.x;
  // Dynamic shared memory: the slab and the fold's copy of the new row
  // (16-byte aligned), the new row, then the slab's candidates and lengths.
  Slab sl;
  sl.emb = s_dyn;
  sl.y = sl.emb + (size_t)p.resident * p.stride;
  float* s_row = sl.y + (p.resident ? p.stride : 0);
  sl.bd = s_row + p.row_floats;
  sl.bj = reinterpret_cast<int*>(sl.bd + p.resident);
  sl.len = sl.bj + p.resident;
  sl.n4 = (p.d1 + 3) / 4;
  float* s_x = p.row_floats ? s_row : p.x_scratch + (size_t)b * p.d1;
  if (tid < S_COUNT) s_i[tid] = p.si[tid];
  if (tid < F_COUNT) s_f[tid] = p.sf[tid];

  // This block's resident rows into shared memory, coalesced, zero past
  // d1 up to a whole float4; the fold's new row zero.
  const int d4 = 4 * sl.n4;
  for (int f = tid; f < p.resident * d4; f += kThreads) {
    const int k = f / d4;
    const int e = f - k * d4;
    const int r = owned_row(k, b, g);
    sl.emb[(size_t)k * p.stride + e] =
        r < p.max_v && e < p.d1 ? p.emb[(size_t)r * p.d1 + e] : 0.0f;
  }
  if (p.resident) {
    for (int e = tid; e < p.stride; e += kThreads) sl.y[e] = 0.0f;
  }
  for (int k = tid; k < p.resident; k += kThreads) {
    const int r = owned_row(k, b, g);
    const bool in = r < p.max_v;
    sl.bd[k] = in ? p.best_dist[r] : INFINITY;
    sl.bj[k] = in ? p.best_j[r] : 0;
    sl.len[k] = in ? p.lengths[r] : 0;
  }
  __syncthreads();

  // The first step's partial.
  fold_pass(p, sl, false, 0, 0, 0, 0, 1.0f, s_x, s_red_v, s_red_i, s_red_j,
            &s_own_v, &s_own_i, &s_own_j);
  if (tid == 0) {
    p.part_v[b] = s_own_v;
    p.part_i[b] = s_own_i;
    p.part_j[b] = s_own_j;
  }

  const float c = s_f[F_C];
  const float sqrt_c = sqrtf(c);
  HYPTOK_MARK(-1);
  for (int s = 0; s < p.n_steps; ++s) {
    if (s_i[S_STOPPED]) break;
    const int par = s & 1;
    grid_barrier(p.barrier, (unsigned)g);
    HYPTOK_MARK(0);

    // Every block reduces all partials to the same (best, i, j). Rows are
    // owned by one block each, so the winning row names its partial, which
    // carries its best_j.
    if (warp == 0) {
      float v = INFINITY;
      int i = INT_MAX;
      int j = 0;
      for (int q0 = par * g + lane; q0 < (par + 1) * g;
           q0 += 32 * kPartBatch) {
        float qv[kPartBatch];
        int qi[kPartBatch];
        int qj[kPartBatch];
#pragma unroll
        for (int u = 0; u < kPartBatch; ++u) {
          const int q = q0 + 32 * u;
          const bool in = q < (par + 1) * g;
          qv[u] = in ? __ldcg(p.part_v + q) : INFINITY;
          qi[u] = in ? __ldcg(p.part_i + q) : INT_MAX;
          qj[u] = in ? __ldcg(p.part_j + q) : 0;
        }
#pragma unroll
        for (int u = 0; u < kPartBatch; ++u) {
          argmin3(v, i, j, qv[u], qi[u], qj[u]);
        }
      }
      warp_argmin3(v, i, j);
      if (lane == 0) {
        s_best = v;
        s_win_i = i;
        s_win_j = j;
      }
    }
    __syncthreads();
    HYPTOK_MARK(1);

    const int vocab = s_i[S_VOCAB];
    const bool has = s_best < s_f[F_THR] && vocab < p.cap;
    if (has) {
      const int i = s_win_i;
      const int j = s_win_j;
      // The midpoint (lorentz.geodesic_point, then the projection), by
      // warp 0 of every block, into s_x. A lane loads kPer coordinates of
      // both rows at once; up to d1 = 32 kPer they stay in registers for
      // the second pass.
      if (warp == 0) {
        const float* xi = p.emb + (size_t)i * p.d1;
        const float* xj = p.emb + (size_t)j * p.d1;
        const int li = __ldcg(p.lengths + i);
        const int lj = __ldcg(p.lengths + j);
        if (lane == 0) s_len_new = li + lj;
        float ri[kPer];
        float rj[kPer];
        float dot = 0.0f;
        for (int e0 = lane; e0 < p.d1; e0 += 32 * kPer) {
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int e = e0 + 32 * u;
            ri[u] = e < p.d1 ? __ldcg(xi + e) : 0.0f;
            rj[u] = e < p.d1 ? __ldcg(xj + e) : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int e = e0 + 32 * u;
            if (e < p.d1) {
              const float t = __fmul_rn(ri[u], rj[u]);
              dot = e == 0 ? __fadd_rn(dot, t) : __fsub_rn(dot, t);
            }
          }
        }
        dot = warp_sum_float(dot);
        const float w = (float)lj / (float)max(li + lj, 1);
        const float d = acosh_log(fmaxf(dot, 1.0f + kAcoshEps));
        const float a = __fmul_rn(1.0f - w, d);
        const float bb = __fmul_rn(w, d);
        const float num_x = __fmul_rn(expf(-bb), 1.0f - expf(-2.0f * a));
        const float num_y = __fmul_rn(expf(-a), 1.0f - expf(-2.0f * bb));
        const float den = fmaxf(1.0f - expf(-2.0f * d), kEpsNorm);
        const bool degenerate = d < kExpZeroTol;
        float sq = 0.0f;
        for (int e0 = lane; e0 < p.d1; e0 += 32 * kPer) {
          if (p.d1 > 32 * kPer) {
#pragma unroll
            for (int u = 0; u < kPer; ++u) {
              const int e = e0 + 32 * u;
              ri[u] = e < p.d1 ? __ldcg(xi + e) : 0.0f;
              rj[u] = e < p.d1 ? __ldcg(xj + e) : 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int e = e0 + 32 * u;
            if (e == 0 || e >= p.d1) continue;
            const float v =
                degenerate ? ri[u]
                           : __fadd_rn(__fmul_rn(num_x, ri[u]),
                                       __fmul_rn(num_y, rj[u])) / den;
            s_x[e] = v;
            if (p.resident) sl.y[e] = v;
            sq = __fadd_rn(sq, __fmul_rn(v, v));
          }
        }
        sq = warp_sum_float(sq);
        if (lane == 0) s_x[0] = sqrtf(__fadd_rn(1.0f, __fmul_rn(c, sq)));
      }
      __syncthreads();
      HYPTOK_MARK(2);
      const int len_new = s_len_new;
      // The owner of slot vocab writes the new row out, into its slab too,
      // with its length and the history.
      if (b == (vocab / kOwnChunk) % g) {
        const int k = (vocab / kOwnChunk / g) * kOwnChunk + vocab % kOwnChunk;
        float* out = p.emb + (size_t)vocab * p.d1;
        for (int e = tid; e < p.d1; e += kThreads) {
          out[e] = s_x[e];
          if (k < p.resident) sl.emb[(size_t)k * p.stride + e] = s_x[e];
        }
        if (tid == 0) {
          const int nm = s_i[S_NM];
          p.lengths[vocab] = len_new;
          if (k < p.resident) sl.len[k] = len_new;
          p.merges[2 * nm] = i;
          p.merges[2 * nm + 1] = j;
          p.merge_dists[nm] = s_best;
        }
      }
      HYPTOK_MARK(5);
      // The fold, and this block's partial for the next step.
      fold_pass(p, sl, true, i, j, vocab, len_new, sqrt_c, s_x, s_red_v,
                s_red_i, s_red_j, &s_own_v, &s_own_i, &s_own_j);
      HYPTOK_MARK(3);
    }

    // The loop scalars, identically in every block (state.merge_step), and
    // this block's partial for the next step (unchanged without a merge).
    if (tid == 0) {
      const int nxt = (par ^ 1) * g + b;
      p.part_v[nxt] = s_own_v;
      p.part_i[nxt] = s_own_i;
      p.part_j[nxt] = s_own_j;
      float thr = s_f[F_THR];
      if (has) {
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
    HYPTOK_MARK(4);
  }

  // The resident candidates back to global memory.
  for (int k = tid; k < p.resident; k += kThreads) {
    const int r = owned_row(k, b, g);
    if (r >= p.max_v) break;
    p.best_dist[r] = sl.bd[k];
    p.best_j[r] = sl.bj[k];
  }
  if (b == 0) {
    if (tid < S_COUNT) p.si[tid] = s_i[tid];
    if (tid < F_COUNT) p.sf[tid] = s_f[tid];
  }
}

}  // namespace

extern "C" int merge_loop_sm_count() {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return 0;
  }
  return sms;
}

// Allow `smem` bytes of dynamic shared memory, then the blocks of that size
// an SM can hold (the cooperative grid needs at least one); a negative
// CUDA error code if either call fails.
extern "C" int merge_loop_blocks_per_sm(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      merge_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, merge_loop_kernel, kThreads, (size_t)smem);
  if (err != cudaSuccess) return -(int)err;
  return per_sm;
}

extern "C" int merge_loop_launch(
    void* emb, void* lengths, void* best_dist, void* best_j, void* merges,
    void* merge_dists, void* si, void* sf, void* part_v, void* part_i,
    void* part_j, void* barrier, void* x_scratch, int grid, int max_v,
    int d1, int cap, int n_steps, int max_token_len, int adaptive,
    int growth_every, float growth, int empty_after, float empty_growth,
    int empty_stop, int resident, int stride, int row_floats, int smem,
    void* stream) {
  if (grid < 1 || d1 < 1 || max_v < 1 || resident < 0 || stride < d1 ||
      stride % 4 != 0 ||
      (row_floats != 0 && row_floats != d1)) {
    return (int)cudaErrorInvalidValue;
  }
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
  p.x_scratch = static_cast<float*>(x_scratch);
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
  p.resident = resident;
  p.stride = stride;
  p.row_floats = row_floats;
  cudaError_t err = cudaFuncSetAttribute(
      merge_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)merge_loop_kernel,
                                    dim3(grid), dim3(kThreads), args,
                                    (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
