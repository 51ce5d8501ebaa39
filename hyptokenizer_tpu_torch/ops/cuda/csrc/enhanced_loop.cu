// Kernel K1: a segment of scored merge steps of the enhanced tokenizer's
// corpus-only loop, in one launch.
//
// Replaces the TPU kernel hyptokenizer_tpu/ops/pallas/enhanced_loop.py:156
// (`_kernel`, corpus-only configuration: use_dense=False, g=1), reached there
// through `_run_segment` and `_run_chunk_fused`. Semantics are those of the
// plain version, hyptokenizer_tpu_torch/tokenizer/enhanced_state.py
// `enhanced_step`, looped to the same halt conditions:
//
//   per step: [hierarchical phase from the merge count] -> rank the valid
//   entries of the phase's score-sorted queue (score > -inf, dist < thr) by
//   an exclusive block scan -> either flag a resync (truncated queue that
//   cannot fill a batch, or a fully consumed queue) or merge the first
//   `nb` entries: geodesic midpoint weighted by token length, re-projected,
//   written at row vocab+t; history; length, composed int32 hash, byte
//   length and vowel flag of the new token; every matching entry of all
//   three phase queues set to -inf -> empty-round and periodic threshold
//   growth -> stop when the vocabulary is full.
//
// The segment halts at `stopped`, at a resync, and at the merge budget, the
// step budget and the next curvature event (`curv_stop`); the corpus sync
// and the curvature Adam step run in PyTorch between launches.
//
// Design. One thread block, looping over the steps; the state stays in
// device memory (served from L2) and the loop scalars in shared memory.
// Each applied merge of a batch is one warp (the midpoint needs only the
// pre-batch rows, and a batch never refers to a token made in the same
// batch). The 128-lane row layout, the sum-extraction reads and the prefix
// sums done as matmuls of the TPU kernel are TPU workarounds and are gone.
//
// Bound. A serial chain of merge_batch-sized steps, each touching a few
// K-entry queues and at most 2*nb+nb embedding rows: it moves far too few
// bytes to be bandwidth-bound and is bound by the latency of its serial
// steps (block barriers and dependent global reads). Making it fast
// (several steps' queue scans in flight, a persistent kernel that also runs
// the sync) is later work.
//
// Numerics: float32 with the log-form acosh and the JAX package's clamp
// constants. The Minkowski dots are summed in another order than the
// plain version's, so rows agree to float32 rounding; the choice of merges
// depends only on the queue and the threshold, and agrees exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 32;  // one warp per applied merge
constexpr unsigned kFull = 0xffffffffu;

constexpr float kAcoshEps = 1e-8f;
constexpr float kEpsNorm = 1e-8f;
constexpr float kExpZeroTol = 1e-6f;
constexpr float kThresholdCap = 1e6f;
constexpr int kHashP1 = 32749;
constexpr int kHashP2 = 32719;

// Integer loop scalars, in this order in the `si` array (enhanced_loop.py).
enum {
  S_VOCAB, S_NM, S_STEP, S_EMPTY, S_STOPPED, S_PHASE, S_RESYNC, S_SYNCED,
  S_M_BUDGET, S_S_BUDGET, S_CURV_STOP, S_QV0, S_QV1, S_QV2, S_COUNT
};
// Float loop scalars, in this order in the `sf` array.
enum { F_THR, F_C, F_COUNT };

struct Params {
  float* emb;            // (max_v, d1)
  int* lengths;          // (max_v,)
  int* byte_lengths;     // (max_v,)
  uint8_t* has_vowel;    // (max_v,) bool
  int* token_hash;       // (max_v, 2)
  int* merges;           // (max_v, 2)
  float* merge_dists;    // (max_v,)
  const int* q_i;        // (3, k)
  const int* q_j;        // (3, k)
  const float* q_dist;   // (3, k)
  float* q_score;        // (3, k)
  const int* powers;     // (2, max_hash_len)
  int* si;               // (S_COUNT,)
  float* sf;             // (F_COUNT,)
  int max_v, d1, k, nb, n_steps, max_hash_len;
  int use_hier, phase2, phase3;
  float phase_thr[3];
  int adaptive, growth_every, empty_after, empty_stop;
  float growth, empty_growth;
};

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum_float(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float acosh_log(float x) {
  return logf(x + sqrtf(x * x - 1.0f));
}

// Warp `warp` merges queue entry `sel` = pair (ci, cj) into row `slot`.
__device__ void merge_one(const Params& p, int lane, int sel, int ci, int cj,
                          int slot, int hist, const float* qd, float c) {
  const float* xi = p.emb + (size_t)ci * p.d1;
  const float* xj = p.emb + (size_t)cj * p.d1;
  float dot = 0.0f;
  for (int e = lane; e < p.d1; e += 32) {
    const float t = xi[e] * xj[e];
    dot += (e == 0) ? t : -t;
  }
  dot = warp_sum_float(dot);
  const int li = p.lengths[ci];
  const int lj = p.lengths[cj];
  const float w = (float)lj / (float)max(li + lj, 1);
  const float d = acosh_log(fmaxf(dot, 1.0f + kAcoshEps));
  const float a = (1.0f - w) * d;
  const float b = w * d;
  const float num_x = expf(-b) * (1.0f - expf(-2.0f * a));
  const float num_y = expf(-a) * (1.0f - expf(-2.0f * b));
  const float den = fmaxf(1.0f - expf(-2.0f * d), kEpsNorm);
  const bool degenerate = d < kExpZeroTol;
  float* out = p.emb + (size_t)slot * p.d1;
  float sq = 0.0f;
  for (int e = lane; e < p.d1; e += 32) {
    if (e == 0) continue;
    const float v = degenerate ? xi[e] : (num_x * xi[e] + num_y * xj[e]) / den;
    out[e] = v;
    sq += v * v;
  }
  sq = warp_sum_float(sq);
  if (lane != 0) return;
  out[0] = sqrtf(1.0f + c * sq);
  p.lengths[slot] = li + lj;
  p.merges[2 * hist] = ci;
  p.merges[2 * hist + 1] = cj;
  p.merge_dists[hist] = qd[sel];
  const int blj = p.byte_lengths[cj];
  const int pw = min(blj, p.max_hash_len - 1);
  p.token_hash[2 * slot] =
      (p.token_hash[2 * ci] * p.powers[pw] + p.token_hash[2 * cj]) % kHashP1;
  p.token_hash[2 * slot + 1] =
      (p.token_hash[2 * ci + 1] * p.powers[p.max_hash_len + pw] +
       p.token_hash[2 * cj + 1]) % kHashP2;
  p.byte_lengths[slot] = p.byte_lengths[ci] + blj;
  p.has_vowel[slot] = (p.has_vowel[ci] | p.has_vowel[cj]) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads, 1)
enhanced_loop_kernel(Params p) {
  __shared__ int s_i[S_COUNT];
  __shared__ float s_f[F_COUNT];
  __shared__ int s_scan[kWarps];
  __shared__ int s_live[kWarps];
  __shared__ int s_sel[kMaxBatch];
  __shared__ int s_ci[kMaxBatch];
  __shared__ int s_cj[kMaxBatch];
  __shared__ int s_halt, s_need_rs, s_n_apply, s_n_valid, s_n_live;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < S_COUNT) s_i[tid] = p.si[tid];
  if (tid < F_COUNT) s_f[tid] = p.sf[tid];
  __syncthreads();

  const int per = (p.k + kThreads - 1) / kThreads;
  const int lo = min(tid * per, p.k);
  const int hi = min(lo + per, p.k);

  for (int s = 0; s < p.n_steps; ++s) {
    if (tid == 0) {
      const int nm = s_i[S_NM];
      const int halt = s_i[S_STOPPED] | s_i[S_RESYNC] |
                       (nm >= s_i[S_M_BUDGET]) |
                       (s_i[S_STEP] >= s_i[S_S_BUDGET]) |
                       (nm >= s_i[S_CURV_STOP]);
      s_halt = halt;
      if (!halt && p.use_hier) {
        const int phase = 1 + (nm >= p.phase2) + (nm >= p.phase3);
        if (phase != s_i[S_PHASE]) s_f[F_THR] = p.phase_thr[phase - 1];
        s_i[S_PHASE] = phase;
      }
    }
    __syncthreads();
    if (s_halt) break;

    const int pidx = min(max(s_i[S_PHASE] - 1, 0), 2);
    const float thr = s_f[F_THR];
    const int* qi = p.q_i + (size_t)pidx * p.k;
    const int* qj = p.q_j + (size_t)pidx * p.k;
    const float* qd = p.q_dist + (size_t)pidx * p.k;
    const float* qs = p.q_score + (size_t)pidx * p.k;

    // Rank the valid entries: exclusive block scan of per-thread counts
    // over contiguous runs of the queue, so ranks follow queue order.
    int my_valid = 0;
    int my_live = 0;
    for (int e = lo; e < hi; ++e) {
      const bool live = qs[e] > -INFINITY;
      my_live += live;
      my_valid += live && (qd[e] < thr);
    }
    int incl = my_valid;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int live_w = warp_sum_int(my_live);
    if (lane == 31) s_scan[warp] = incl;
    if (lane == 0) s_live[warp] = live_w;
    __syncthreads();
    if (warp == 0) {
      const int v = s_scan[lane];
      int inc = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += u;
      }
      const int live_all = warp_sum_int(s_live[lane]);
      __syncwarp();
      s_scan[lane] = inc - v;
      if (lane == 31) s_n_valid = inc;
      if (lane == 0) s_n_live = live_all;
    }
    __syncthreads();
    int rank = s_scan[warp] + incl - my_valid;
    for (int e = lo; e < hi && rank < p.nb; ++e) {
      if (qs[e] > -INFINITY && qd[e] < thr) {
        s_sel[rank] = e;
        ++rank;
      }
    }
    __syncthreads();

    if (tid == 0) {
      const int n_valid = s_n_valid;
      const bool consumed_any = s_i[S_NM] > s_i[S_SYNCED];
      const bool need_rs =
          (s_i[S_QV0 + pidx] > p.k && consumed_any && n_valid < p.nb) ||
          (s_n_live == 0 && consumed_any);
      const int n_apply =
          need_rs ? 0 : max(0, min(min(n_valid, p.nb), p.max_v - s_i[S_VOCAB]));
      for (int t = 0; t < n_apply; ++t) {
        s_ci[t] = qi[s_sel[t]];
        s_cj[t] = qj[s_sel[t]];
      }
      s_need_rs = need_rs;
      s_n_apply = n_apply;
    }
    __syncthreads();

    const int n_apply = s_n_apply;
    if (warp < n_apply) {
      merge_one(p, lane, s_sel[warp], s_ci[warp], s_cj[warp],
                s_i[S_VOCAB] + warp, s_i[S_NM] + warp, qd, s_f[F_C]);
    }
    if (n_apply > 0) {
      // Consume every applied ordered pair in all three phase queues.
      for (int e = tid; e < 3 * p.k; e += kThreads) {
        const int a = p.q_i[e];
        const int b = p.q_j[e];
        for (int t = 0; t < n_apply; ++t) {
          if (a == s_ci[t] && b == s_cj[t]) {
            p.q_score[e] = -INFINITY;
            break;
          }
        }
      }
    }
    __syncthreads();

    if (tid == 0) {
      float thr2 = s_f[F_THR];
      if (s_need_rs) {
        s_i[S_RESYNC] = 1;
      } else {
        const int nm0 = s_i[S_NM];
        s_i[S_VOCAB] += n_apply;
        s_i[S_NM] += n_apply;
        if (n_apply > 0) {
          s_i[S_EMPTY] = 0;
        } else {
          const int empty = s_i[S_EMPTY] + 1;
          if (p.adaptive) {
            const bool grow = empty >= p.empty_after;
            thr2 = fminf(grow ? thr2 * p.empty_growth : thr2, kThresholdCap);
            s_i[S_EMPTY] = grow ? 0 : empty;
          } else {
            s_i[S_EMPTY] = empty;
            s_i[S_STOPPED] = empty >= p.empty_stop;
          }
        }
        s_i[S_STEP] += 1;
        if (p.adaptive && p.growth_every > 0) {
          const bool grow =
              (s_i[S_NM] / p.growth_every) > (nm0 / p.growth_every);
          thr2 = fminf(grow ? thr2 * p.growth : thr2, kThresholdCap);
        }
      }
      if (p.adaptive && p.growth_every > 0) thr2 = fminf(thr2, kThresholdCap);
      s_f[F_THR] = thr2;
      if (s_i[S_VOCAB] >= p.max_v) s_i[S_STOPPED] = 1;
    }
    __syncthreads();
  }

  if (tid < S_COUNT) p.si[tid] = s_i[tid];
  if (tid < F_COUNT) p.sf[tid] = s_f[tid];
}

}  // namespace

extern "C" int enhanced_loop_launch(
    void* emb, void* lengths, void* byte_lengths, void* has_vowel,
    void* token_hash, void* merges, void* merge_dists, void* q_i, void* q_j,
    void* q_dist, void* q_score, void* powers, void* si, void* sf, int max_v,
    int d1, int k, int nb, int n_steps, int max_hash_len, int use_hier,
    int phase2, int phase3, float thr1, float thr2, float thr3, int adaptive,
    int growth_every, float growth, int empty_after, float empty_growth,
    int empty_stop, void* stream) {
  if (nb < 1 || nb > kMaxBatch) return (int)cudaErrorInvalidValue;
  Params p;
  p.emb = static_cast<float*>(emb);
  p.lengths = static_cast<int*>(lengths);
  p.byte_lengths = static_cast<int*>(byte_lengths);
  p.has_vowel = static_cast<uint8_t*>(has_vowel);
  p.token_hash = static_cast<int*>(token_hash);
  p.merges = static_cast<int*>(merges);
  p.merge_dists = static_cast<float*>(merge_dists);
  p.q_i = static_cast<const int*>(q_i);
  p.q_j = static_cast<const int*>(q_j);
  p.q_dist = static_cast<const float*>(q_dist);
  p.q_score = static_cast<float*>(q_score);
  p.powers = static_cast<const int*>(powers);
  p.si = static_cast<int*>(si);
  p.sf = static_cast<float*>(sf);
  p.max_v = max_v;
  p.d1 = d1;
  p.k = k;
  p.nb = nb;
  p.n_steps = n_steps;
  p.max_hash_len = max_hash_len;
  p.use_hier = use_hier;
  p.phase2 = phase2;
  p.phase3 = phase3;
  p.phase_thr[0] = thr1;
  p.phase_thr[1] = thr2;
  p.phase_thr[2] = thr3;
  p.adaptive = adaptive;
  p.growth_every = growth_every;
  p.growth = growth;
  p.empty_after = empty_after;
  p.empty_growth = empty_growth;
  p.empty_stop = empty_stop;
  enhanced_loop_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
