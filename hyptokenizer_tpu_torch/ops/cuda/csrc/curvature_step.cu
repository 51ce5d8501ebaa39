// Kernel C1: the curvature Adam step, the loss's gradient in closed form,
// the Adam update and the rescale of the cached distances, in two launches
// that read nothing back to the host.
//
// Replaces no pl.pallas_call: the JAX package takes the step with XLA ops
// in `_maybe_update_curvature` (hyptokenizer_tpu/tokenizer/enhanced_state.py
// :427-445: `jax.grad` of `_curvature_losses`, then the Adam update and the
// rescale), and the port took them over one PyTorch op at a time, an
// autograd pass of about 240 launches and three blocking reads a step. The
// plain version is hyptokenizer_tpu_torch/tokenizer/enhanced_state.py
// `curvature_adam_plain`; the wrapper is ops/cuda/curvature_step.py.
//
// The closed form. Every distance the loss takes is
//   d = acosh(max(<x, y>_L, 1 + GRAD_EPS)) / sqrt(c) = A * s,  s = c^(-1/2),
// where A does not depend on c: the clamp acts on the Minkowski dot, which
// holds no c. So the loss depends on c through s alone, dL/dc = dL/ds *
// ds/dc with ds/dc = -0.5 s / c, and dL/ds is a sum over the A's with no
// autograd and no clamp in it. With pairs i (valid_i: i < min(nm, hp)),
// negatives k (not_self_ik: the negative is neither of the pair's tokens)
// and the hinge active where pair_d - d + 0.1 > 0 (strict, as relu's zero
// gradient at 0):
//   dhier/ds = sum_i valid_i [sum_k not_self_ik (act^x_ik (A_p,i - A^x_ik)
//              + act^y_ik (A_p,i - A^y_ik))] / max(sum_k not_self_ik, 1)
//              / (2 max(sum_i valid_i, 1));
//   over the distortion pairs q with ii_q != jj_q (n of them), muA =
//   sum A / max(n, 1) and varA = sum (A - muA)^2 / max(n, 1), in two passes:
//   dD/ds = -10 muA exp(-10 s muA) + 0.2 s varA;
//   g = (hierarchy_weight dhier/ds + distortion_weight dD/ds) (-0.5 s / c).
// Then Adam (b1 0.9, b2 0.999, eps 1e-8, powf bias corrections), c_new
// clamped to [curvature_min, curvature_max], and the cached distances
// rescaled by sqrt(c / c_new): every finite best_dist entry (a corpus-only
// state's -inf poison stays) and every q_dist entry. Distances scale as
// 1/sqrt(c), so they are rescaled, never recomputed.
//
// Bound. Latency: about hp hn 2 + hp + ds = 2,600 Lorentz distances of d1 =
// 101 floats, 0.9 MB gathered from L2 or HBM (0.3 us at 3.35 TB/s) and 5
// MFLOP, then a rescale of max_V + 3 K floats (0.45 MB read and written at
// the flagship's sizes, 0.3 us).
//
// Design. Launch 1 (terms_kernel): one block a merge pair i < hp, its warps
// taking the pair's negatives in turn, and one warp a distortion pair in the
// blocks after them; a warp reads its rows with coalesced 32-lane loads and
// sums each Minkowski dot with shuffles. A pair's block writes its term
// (the bracket above over its count) and a distortion warp its A (0 when
// ii == jj) to scratch, each to its own slot: no atomics. Launch 2
// (update_kernel): every block sums the scratch in one fixed tree order, so
// that every block derives the same bits of g, c_new and the scale; block 0
// writes the scalars and all blocks rescale a stride of the distances. Two
// launches on the same inputs give the same bits.
//
// Numerics. The Minkowski dots and the sums run in another order than the
// plain version's, so g differs from autograd's by float32 rounding (about
// 1e-6 relative); the hinge decisions, the Adam update and the rescale
// round as the plain version rounds them (__fmul_rn, __fadd_rn, __fdiv_rn:
// no contraction).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace hyptok;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;  // rescaled entries a thread, sizing launch 2
constexpr int kMaxUpdateBlocks = 132;  // one a streaming multiprocessor
constexpr float kMargin = 0.1f;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = (float)(1.0 - 0.9);
constexpr float kOneMinusB2 = (float)(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;

struct Params {
  const float* emb;         // (V, d1)
  const int* merges;        // (V, 2) merge history
  const int* num_merges;    // 0-d
  const int* negs;          // (hp, hn)
  const int* ii;            // (ds,)
  const int* jj;            // (ds,)
  const float* curvature;   // 0-d
  const float* curv_m;      // 0-d
  const float* curv_v;      // 0-d
  const int* curv_t;        // 0-d
  const float* best_dist;   // (n_best,)
  const float* q_dist;      // (n_q,)
  float* terms;             // (hp + ds,) scratch
  float* c_out;             // 0-d outputs
  float* m_out;
  float* v_out;
  int* t_out;
  int* last_out;
  float* best_out;          // (n_best,)
  float* q_out;             // (n_q,)
  int d1, hp, hn, ds, n_best, n_q;
  float hier_w, dist_w, lr, c_min, c_max;
};

// A = acosh(max(<x, y>_L, 1 + GRAD_EPS)) of rows x and y, on every lane of
// the warp.
__device__ float c_free_distance(const float* x, const float* y, int d1,
                                 int lane) {
  float dot = 0.0f;
  for (int e = lane; e < d1; e += 32) {
    const float v = __fmul_rn(x[e], y[e]);
    dot = (e == 0) ? __fadd_rn(dot, v) : __fsub_rn(dot, v);
  }
  return acosh_log(fmaxf(warp_sum_float(dot), 1.0f + kGradEps));
}

__global__ void __launch_bounds__(kThreads) terms_kernel(const Params p) {
  __shared__ float s_sum[kWarps];
  __shared__ int s_cnt[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d1 = p.d1;
  if ((int)blockIdx.x < p.hp) {
    const int i = blockIdx.x;
    const int nm = *p.num_merges;
    if (i >= min(nm, p.hp)) {
      if (threadIdx.x == 0) p.terms[i] = 0.0f;
      return;
    }
    const int take = min(max(nm - p.hp, 0) + i, max(nm - 1, 0));
    const int pi = p.merges[2 * (size_t)take];
    const int pj = p.merges[2 * (size_t)take + 1];
    const float* x = p.emb + (size_t)pi * d1;
    const float* y = p.emb + (size_t)pj * d1;
    const float sqrt_c = sqrtf(*p.curvature);
    const float a_p = c_free_distance(x, y, d1, lane);
    const float pair_d = __fdiv_rn(a_p, sqrt_c);
    float sum = 0.0f;
    int cnt = 0;
    for (int k = warp; k < p.hn; k += kWarps) {
      const int n = p.negs[(size_t)i * p.hn + k];
      if (n == pi || n == pj) continue;
      const float* z = p.emb + (size_t)n * d1;
      const float a_x = c_free_distance(x, z, d1, lane);
      const float a_y = c_free_distance(y, z, d1, lane);
      if (__fadd_rn(__fsub_rn(pair_d, __fdiv_rn(a_x, sqrt_c)), kMargin) >
          0.0f) {
        sum = __fadd_rn(sum, __fsub_rn(a_p, a_x));
      }
      if (__fadd_rn(__fsub_rn(pair_d, __fdiv_rn(a_y, sqrt_c)), kMargin) >
          0.0f) {
        sum = __fadd_rn(sum, __fsub_rn(a_p, a_y));
      }
      ++cnt;
    }
    if (lane == 0) {
      s_sum[warp] = sum;
      s_cnt[warp] = cnt;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      int n_self_free = 0;
      for (int w = 0; w < kWarps; ++w) {
        total = __fadd_rn(total, s_sum[w]);
        n_self_free += s_cnt[w];
      }
      p.terms[i] = __fdiv_rn(total, (float)max(n_self_free, 1));
    }
    return;
  }
  const int q = ((int)blockIdx.x - p.hp) * kWarps + warp;
  if (q >= p.ds) return;
  const int a = p.ii[q];
  const int b = p.jj[q];
  const float dist =
      c_free_distance(p.emb + (size_t)a * d1, p.emb + (size_t)b * d1, d1,
                      lane);
  if (lane == 0) p.terms[p.hp + q] = a != b ? dist : 0.0f;
}

// The block's sum of v, in one fixed tree order; every thread gets it.
__device__ float block_sum(float v, float* s) {
  s[threadIdx.x] = v;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if ((int)threadIdx.x < o) {
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + o]);
    }
    __syncthreads();
  }
  const float total = s[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads) update_kernel(const Params p) {
  __shared__ float s_red[kThreads];
  __shared__ float s_scale;
  const int tid = threadIdx.x;

  float h = 0.0f;
  float a_sum = 0.0f;
  float kept = 0.0f;
  for (int i = tid; i < p.hp; i += kThreads) h = __fadd_rn(h, p.terms[i]);
  for (int q = tid; q < p.ds; q += kThreads) {
    if (p.ii[q] != p.jj[q]) {
      a_sum = __fadd_rn(a_sum, p.terms[p.hp + q]);
      kept = __fadd_rn(kept, 1.0f);
    }
  }
  const float hier_sum = block_sum(h, s_red);
  const float n_kept = fmaxf(block_sum(kept, s_red), 1.0f);
  const float mu = __fdiv_rn(block_sum(a_sum, s_red), n_kept);
  float dev2 = 0.0f;
  for (int q = tid; q < p.ds; q += kThreads) {
    if (p.ii[q] != p.jj[q]) {
      const float e = __fsub_rn(p.terms[p.hp + q], mu);
      dev2 = __fadd_rn(dev2, __fmul_rn(e, e));
    }
  }
  const float var = __fdiv_rn(block_sum(dev2, s_red), n_kept);

  if (tid == 0) {
    const int nm = *p.num_merges;
    const float c = *p.curvature;
    const float s = __fdiv_rn(1.0f, sqrtf(c));
    const int n_valid = max(min(nm, p.hp), 1);
    const float d_hier = __fdiv_rn(hier_sum, (float)(2 * n_valid));
    const float d_dist = __fadd_rn(
        __fmul_rn(__fmul_rn(-10.0f, mu),
                  expf(__fmul_rn(__fmul_rn(-10.0f, s), mu))),
        __fmul_rn(__fmul_rn(0.2f, s), var));
    const float g = __fmul_rn(
        __fadd_rn(__fmul_rn(p.hier_w, d_hier), __fmul_rn(p.dist_w, d_dist)),
        __fdiv_rn(__fmul_rn(-0.5f, s), c));
    // The plain version's Adam update, operation for operation.
    const int t = *p.curv_t + 1;
    const float m = __fadd_rn(__fmul_rn(kB1, *p.curv_m),
                              __fmul_rn(kOneMinusB1, g));
    const float v = __fadd_rn(__fmul_rn(kB2, *p.curv_v),
                              __fmul_rn(__fmul_rn(kOneMinusB2, g), g));
    const float mhat = __fdiv_rn(m, __fsub_rn(1.0f, powf(kB1, (float)t)));
    const float vhat = __fdiv_rn(v, __fsub_rn(1.0f, powf(kB2, (float)t)));
    float c_new = __fsub_rn(
        c, __fdiv_rn(__fmul_rn(p.lr, mhat), __fadd_rn(sqrtf(vhat),
                                                        kAdamEps)));
    c_new = fminf(fmaxf(c_new, p.c_min), p.c_max);
    s_scale = sqrtf(__fdiv_rn(c, c_new));
    if (blockIdx.x == 0) {
      *p.c_out = c_new;
      *p.m_out = m;
      *p.v_out = v;
      *p.t_out = t;
      *p.last_out = nm;
    }
  }
  __syncthreads();
  const float scale = s_scale;
  const int n = p.n_best + p.n_q;
  for (int k = blockIdx.x * kThreads + tid; k < n; k += gridDim.x * kThreads) {
    if (k < p.n_best) {
      const float d = p.best_dist[k];
      p.best_out[k] = isfinite(d) ? __fmul_rn(d, scale) : d;
    } else {
      p.q_out[k - p.n_best] = __fmul_rn(p.q_dist[k - p.n_best], scale);
    }
  }
}

}  // namespace

// One curvature Adam step, two launches on `stream`. Every pointer is device
// memory: emb (V, d1) float32; merges (V, 2), the 0-d num_merges, negs (hp,
// hn), ii and jj (ds,) int32; the 0-d curvature, curv_m, curv_v float32 and
// curv_t int32; best_dist (n_best,) and q_dist (n_q,) float32; terms (hp +
// ds,) float32 scratch; the outputs c_out, m_out, v_out (0-d float32),
// t_out, last_out (0-d int32), best_out (n_best,) and q_out (n_q,).
extern "C" int curvature_step_launch(
    const void* emb, const void* merges, const void* num_merges,
    const void* negs, const void* ii, const void* jj, const void* curvature,
    const void* curv_m, const void* curv_v, const void* curv_t,
    const void* best_dist, const void* q_dist, void* terms, void* c_out,
    void* m_out, void* v_out, void* t_out, void* last_out, void* best_out,
    void* q_out, int d1, int hp, int hn, int ds, int n_best, int n_q,
    float hier_w, float dist_w, float lr, float c_min, float c_max,
    void* stream) {
  if (d1 < 1 || hp < 0 || hn < 0 || ds < 0 || n_best < 0 || n_q < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.emb = static_cast<const float*>(emb);
  p.merges = static_cast<const int*>(merges);
  p.num_merges = static_cast<const int*>(num_merges);
  p.negs = static_cast<const int*>(negs);
  p.ii = static_cast<const int*>(ii);
  p.jj = static_cast<const int*>(jj);
  p.curvature = static_cast<const float*>(curvature);
  p.curv_m = static_cast<const float*>(curv_m);
  p.curv_v = static_cast<const float*>(curv_v);
  p.curv_t = static_cast<const int*>(curv_t);
  p.best_dist = static_cast<const float*>(best_dist);
  p.q_dist = static_cast<const float*>(q_dist);
  p.terms = static_cast<float*>(terms);
  p.c_out = static_cast<float*>(c_out);
  p.m_out = static_cast<float*>(m_out);
  p.v_out = static_cast<float*>(v_out);
  p.t_out = static_cast<int*>(t_out);
  p.last_out = static_cast<int*>(last_out);
  p.best_out = static_cast<float*>(best_out);
  p.q_out = static_cast<float*>(q_out);
  p.d1 = d1;
  p.hp = hp;
  p.hn = hn;
  p.ds = ds;
  p.n_best = n_best;
  p.n_q = n_q;
  p.hier_w = hier_w;
  p.dist_w = dist_w;
  p.lr = lr;
  p.c_min = c_min;
  p.c_max = c_max;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int terms_grid = hp + (ds + kWarps - 1) / kWarps;
  if (terms_grid > 0) {
    terms_kernel<<<terms_grid, kThreads, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int per_block = kThreads * kPerThread;
  int grid = (n_best + n_q + per_block - 1) / per_block;
  grid = grid < 1 ? 1 : (grid > kMaxUpdateBlocks ? kMaxUpdateBlocks : grid);
  update_kernel<<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
