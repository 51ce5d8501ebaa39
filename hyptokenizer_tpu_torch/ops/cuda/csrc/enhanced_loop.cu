// Kernels K1 and K2: a segment of scored merge steps of the enhanced
// tokenizer's loop, in one launch.
//
// Replace the TPU kernel hyptokenizer_tpu/ops/pallas/enhanced_loop.py:156
// (`_kernel`), reached there through `_run_segment` and `_run_chunk_fused`,
// in its two configurations: K1 is the corpus-only one (use_dense=False,
// `enhanced_loop_launch`), K2 the dense one (use_dense=True,
// `enhanced_loop_dense_launch`). Both are instances of one template
// (kDense). Semantics are those of the plain version,
// hyptokenizer_tpu_torch/tokenizer/enhanced_state.py `enhanced_step`,
// looped to the same halt conditions:
//
//   per step: [hierarchical phase from the merge count] -> [K2: the dense
//   candidate: block-wide argmin of best_dist over the active rows (lowest
//   index on ties), its full score (pair count by binary search of the
//   lexicographic pair table, coherence of its midpoint against the sync's
//   samples, compression, morph/word membership of the composed hash)] ->
//   rank the valid entries of the phase's score-sorted queue (score > -inf,
//   dist < thr, [K2: not the dense pair]) by an exclusive block scan ->
//   either flag a resync (truncated queue that cannot fill a batch, or
//   [K1] a fully consumed queue) or merge the batch: the first `nb` queue
//   entries [K2: with the dense candidate at its rank among them, dense
//   first on ties]; geodesic midpoint weighted by token length,
//   re-projected, written at row vocab+t; history; length, composed int32
//   hash, byte length and vowel flag of the new token; every matching entry
//   of all three phase queues set to -inf; [K2: rows whose tracked best was
//   consumed set to inf, then the batched column fold] -> empty-round and
//   periodic threshold growth -> stop when the vocabulary is full.
//
// The segment halts at `stopped`, at a resync, and at the merge budget, the
// step budget and the next curvature event (`curv_stop`); the corpus sync
// and the curvature Adam step run in PyTorch between launches.
//
// Design. One thread block, looping over the steps; the state stays in
// device memory (served from L2) and the loop scalars in shared memory.
// The batch's arrays live in dynamic shared memory sized by merge_batch.
// The warps take the applied merges of a batch by warp stride, one merge
// at a time (the midpoint needs only the pre-batch rows, and a batch never
// refers to a token made in the same batch). K2's fold stages the <= nb+1
// new rows, signature-folded, in shared memory (all at once when they fit
// kNewFloats, else kFoldGroup rows at a time in chunks of coordinates);
// one thread per row r < vocab_post sums their grams with its row, applies
// the length gate, and keeps a strict < in increasing slot order (which
// gives the plain version's lowest-column tie break). It needs only the
// rows below vocab_post, where the TPU kernel streams the whole padded
// buffer; the output is the same. The dense candidate's coherence stages
// its midpoint in chunks of kMidChunk coordinates and holds kSampleBlock
// sample grams at a time, so neither d nor the sample count is bounded.
// The 128-lane row layout, the sum-extraction reads, the matmul prefix
// sums and the (g, 128, 128) fold tiles of the TPU kernel are TPU
// workarounds and are gone.
//
// Bound. K1: a serial chain of merge_batch-sized steps, each touching a few
// K-entry queues and at most 2*nb+nb embedding rows: it moves far too few
// bytes to be bandwidth-bound and is bound by the latency of its serial
// steps (block barriers and dependent global reads). K2 adds per step a read
// of best_dist for the argmin and the fold: read the active rows' embeddings
// (vocab_post x d1 x 4 B), their lengths and best_dist/best_j, write
// best_dist/best_j; at a full 50,176-row vocabulary about 21.5 MB per step,
// 6.4 us at 3.35 TB/s, above the fold's <= 17 x V x 101 x 2 FLOP at 67
// TFLOP/s. One block on one SM cannot approach either: the one-block fold
// gives up all but one SM's bandwidth and FFMA rate, knowingly. Spreading
// it over the grid (a cooperative launch with grid sync, or a per-step fold
// kernel) and making K1's steps faster are later work.
//
// Numerics: float32 with the log-form acosh and the JAX package's clamp
// constants. The Minkowski dots and the coherence average are summed in
// another order than the plain version's, so rows agree to float32
// rounding. K1's choice of merges depends only on the queue and the
// threshold, and agrees exactly; K2's dense distance and score can differ
// from the plain version's by rounding, so a near-tie can reorder a batch,
// which chip_smoke.py's lockstep check (evals/selfcheck.py) classifies.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace hyptok;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 8192;  // queue batch; its arrays are dynamic
constexpr int kMidChunk = 128;   // K2 stages the dense midpoint by 128 floats
constexpr int kNewFloats = 8192; // K2's staging buffer for the fold's rows
constexpr int kFoldGroup = 8;  // new columns summed per pass over a row
constexpr int kHashP1 = 32749;
constexpr int kHashP2 = 32719;

// Integer loop scalars, in this order in the `si` array (enhanced_loop.py).
// The last four are read by K2 only.
enum {
  S_VOCAB, S_NM, S_STEP, S_EMPTY, S_STOPPED, S_PHASE, S_RESYNC, S_SYNCED,
  S_M_BUDGET, S_S_BUDGET, S_CURV_STOP, S_QV0, S_QV1, S_QV2, S_MORPH_SIZE,
  S_WORD_SIZE, S_CORPUS_TOKENS, S_MAX_COUNT, S_COUNT
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
  // K2 only.
  float* best_dist;      // (max_v,)
  int* best_j;           // (max_v,)
  const int* pair_keys;  // (table_size, 2) lexicographically sorted
  const int* pair_counts;  // (table_size,)
  const int* morph;      // (morph_len,) sorted, padded
  const int* word;       // (word_len,) sorted, padded
  const int* samples;    // (n_samples,) coherence sample ids
  int table_size, morph_len, word_len, n_samples;
  int needs_corpus, use_freq, use_comp, max_token_len;
  float w_alpha, w_beta, w_gamma, w_comp, w_morph;
};

// Coefficients of the length-weighted geodesic point of rows ci and cj
// (lorentz.geodesic_point), summed over one warp:
// point = degenerate ? x_ci : (num_x * x_ci + num_y * x_cj) / den.
struct Geodesic {
  float num_x, num_y, den;
  bool degenerate;
};

__device__ Geodesic geodesic(const Params& p, int lane, int ci, int cj) {
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
  Geodesic g;
  g.num_x = expf(-b) * (1.0f - expf(-2.0f * a));
  g.num_y = expf(-a) * (1.0f - expf(-2.0f * b));
  g.den = fmaxf(1.0f - expf(-2.0f * d), kEpsNorm);
  g.degenerate = d < kExpZeroTol;
  return g;
}

// hash(a + b) from hash(a), hash(b) and the byte length of b
// (scoring.compose_hash), both residues.
__device__ void compose_hash(const Params& p, int ci, int cj, int* h1,
                             int* h2) {
  const int pw = min(p.byte_lengths[cj], p.max_hash_len - 1);
  *h1 = (p.token_hash[2 * ci] * p.powers[pw] + p.token_hash[2 * cj]) % kHashP1;
  *h2 = (p.token_hash[2 * ci + 1] * p.powers[p.max_hash_len + pw] +
         p.token_hash[2 * cj + 1]) % kHashP2;
}

// One warp merges the pair (ci, cj), at distance `dist`, into row `slot`.
__device__ void merge_one(const Params& p, int lane, int ci, int cj,
                          int slot, int hist, float dist, float c) {
  const float* xi = p.emb + (size_t)ci * p.d1;
  const float* xj = p.emb + (size_t)cj * p.d1;
  const Geodesic g = geodesic(p, lane, ci, cj);
  float* out = p.emb + (size_t)slot * p.d1;
  float sq = 0.0f;
  for (int e = lane; e < p.d1; e += 32) {
    if (e == 0) continue;
    const float v = g.degenerate ? xi[e]
                                 : (g.num_x * xi[e] + g.num_y * xj[e]) / g.den;
    out[e] = v;
    sq += v * v;
  }
  sq = warp_sum_float(sq);
  if (lane != 0) return;
  out[0] = sqrtf(1.0f + c * sq);
  p.lengths[slot] = p.lengths[ci] + p.lengths[cj];
  p.merges[2 * hist] = ci;
  p.merges[2 * hist + 1] = cj;
  p.merge_dists[hist] = dist;
  compose_hash(p, ci, cj, &p.token_hash[2 * slot], &p.token_hash[2 * slot + 1]);
  p.byte_lengths[slot] = p.byte_lengths[ci] + p.byte_lengths[cj];
  p.has_vowel[slot] = (p.has_vowel[ci] | p.has_vowel[cj]) ? 1 : 0;
}

// Count of the pair (hi, lo) in the lexicographically sorted pair table, 0
// when absent (scoring.lookup_pair_counts).
__device__ int pair_count(const Params& p, int hi, int lo) {
  int a = 0;
  int b = p.table_size;
  while (a < b) {
    const int mid = (a + b) >> 1;
    const int mh = p.pair_keys[2 * mid];
    const int ml = p.pair_keys[2 * mid + 1];
    if (mh < hi || (mh == hi && ml < lo)) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  const int pos = min(a, p.table_size - 1);
  return (p.pair_keys[2 * pos] == hi && p.pair_keys[2 * pos + 1] == lo)
             ? p.pair_counts[pos]
             : 0;
}

// Membership of `key` in a sorted table of `len` entries whose first `size`
// are real (scoring.in_sorted_set).
__device__ bool in_sorted(const int* table, int len, int size, int key) {
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

constexpr int kSampleBlock = 512;  // K2's coherence grams held at a time

// Bytes of the batch arrays in dynamic shared memory for a queue batch nb:
// the selected queue entries (nb) and the applied merges (nb + 1, with the
// dense candidate): rows i, j, distance, new length.
inline int batch_smem_bytes(int nb) { return (nb + 4 * (nb + 1)) * 4; }

template <bool kDense>
__global__ void __launch_bounds__(kThreads, 1)
enhanced_loop_kernel(Params p) {
  __shared__ int s_i[S_COUNT];
  __shared__ float s_f[F_COUNT];
  __shared__ int s_scan[kWarps];
  __shared__ int s_live[kWarps];
  extern __shared__ int s_dyn[];
  int* s_sel = s_dyn;                    // (nb,)
  int* s_ci = s_sel + p.nb;              // (nb + 1,)
  int* s_cj = s_ci + p.nb + 1;           // (nb + 1,)
  float* s_cd = reinterpret_cast<float*>(s_cj + p.nb + 1);  // (nb + 1,)
  int* s_nlen = reinterpret_cast<int*>(s_cd + p.nb + 1);    // (nb + 1,)
  __shared__ int s_halt, s_need_rs, s_n_apply, s_n_valid, s_n_live;
  // K2: the dense candidate, its coherence terms and the fold's new rows.
  __shared__ float s_red_f[kWarps];
  __shared__ int s_red_i[kWarps];
  __shared__ float s_mid[kDense ? kMidChunk : 1];
  __shared__ float s_coh[kDense ? kSampleBlock : 1];
  __shared__ float s_new[kDense ? kNewFloats : 1];
  __shared__ float s_geo[3];
  __shared__ int s_degen;
  __shared__ int s_di, s_dj, s_dvalid;
  __shared__ float s_dd, s_dscore;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < S_COUNT) s_i[tid] = p.si[tid];
  if (tid < F_COUNT) s_f[tid] = p.sf[tid];
  __syncthreads();

  const int per = (p.k + kThreads - 1) / kThreads;
  const int lo = min(tid * per, p.k);
  const int hi = min(lo + per, p.k);
  const bool corpus = !kDense || p.needs_corpus;

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

    int di = 0;
    int dj = 0;
    bool dvalid = false;
    if constexpr (kDense) {
      // The dense candidate: argmin of best_dist over the active rows
      // (rows past the vocabulary hold inf), lowest index on ties.
      float bv = INFINITY;
      int bi = INT_MAX;
      for (int r = tid; r < s_i[S_VOCAB]; r += kThreads) {
        const float v = p.best_dist[r];
        if (v < bv) {
          bv = v;
          bi = r;
        }
      }
      warp_argmin(bv, bi);
      if (lane == 0) {
        s_red_f[warp] = bv;
        s_red_i[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        bv = s_red_f[lane];
        bi = s_red_i[lane];
        warp_argmin(bv, bi);
        if (lane == 0) {
          const int i0 = bi == INT_MAX ? 0 : bi;
          const float d0 = p.best_dist[i0];
          const int j0 = min(max(p.best_j[i0], 0), p.max_v - 1);
          bool ok = isfinite(d0) && d0 < thr;
          if (p.max_token_len > 0) {
            // Backstop for the fold's length gate (a state re-scanned on
            // load can carry overlong pairs).
            ok = ok && p.lengths[i0] + p.lengths[j0] <= p.max_token_len;
          }
          s_di = i0;
          s_dj = j0;
          s_dd = d0;
          s_dvalid = ok;
        }
      }
      __syncthreads();
      di = s_di;
      dj = s_dj;
      dvalid = s_dvalid;

      // Its full score at this phase (enhanced_state._full_scores).
      if (dvalid) {
        const float c = s_f[F_C];
        // Coherence: the midpoint against the sync's samples, in blocks of
        // kSampleBlock samples, each gram summed over chunks of kMidChunk
        // coordinates of the midpoint; thread 0 adds up the distances in
        // sample order.
        float coh_sum = 0.0f;
        int coh_cnt = 0;
        if (p.use_freq) {
          if (warp == 0) {
            const Geodesic g = geodesic(p, lane, di, dj);
            if (lane == 0) {
              s_geo[0] = g.num_x;
              s_geo[1] = g.num_y;
              s_geo[2] = g.den;
              s_degen = g.degenerate;
            }
          }
          const float* xi = p.emb + (size_t)di * p.d1;
          const float* xj = p.emb + (size_t)dj * p.d1;
          for (int q0 = 0; q0 < p.n_samples; q0 += kSampleBlock) {
            const int nq = min(kSampleBlock, p.n_samples - q0);
            for (int c0 = 0; c0 < p.d1; c0 += kMidChunk) {
              const int c1 = min(c0 + kMidChunk, p.d1);
              __syncthreads();
              if (warp == 0) {
                const float num_x = s_geo[0];
                const float num_y = s_geo[1];
                const float den = s_geo[2];
                for (int e = c0 + lane; e < c1; e += 32) {
                  const float v =
                      s_degen ? xi[e] : (num_x * xi[e] + num_y * xj[e]) / den;
                  s_mid[e - c0] = e == 0 ? v : -v;
                }
              }
              __syncthreads();
              for (int q = warp; q < nq; q += kWarps) {
                const int sid = p.samples[q0 + q];
                const float* y = p.emb + (size_t)sid * p.d1;
                float gram = 0.0f;
                for (int e = c0 + lane; e < c1; e += 32) {
                  gram += s_mid[e - c0] * y[e];
                }
                gram = warp_sum_float(gram);
                if (lane == 0) {
                  if (c0 > 0) gram += s_coh[q];
                  s_coh[q] = gram;
                  if (c1 == p.d1) {
                    s_coh[q] = (sid != di && sid != dj)
                                   ? acosh_log(fmaxf(gram, 1.0f + kGradEps)) /
                                         sqrtf(c)
                                   : -1.0f;
                  }
                }
              }
            }
            __syncthreads();
            if (tid == 0) {
              for (int q = 0; q < nq; ++q) {
                if (s_coh[q] >= 0.0f) {
                  coh_sum += s_coh[q];
                  ++coh_cnt;
                }
              }
            }
          }
        }
        if (tid == 0) {
          const float dd = s_dd;
          const int freq = (p.use_freq || p.use_comp) ? pair_count(p, di, dj)
                                                      : 0;
          const float dist_score = 1.0f / (1.0f + dd);
          float freq_score = 0.0f;
          float semantic = 0.0f;
          float compression = 0.0f;
          if (p.use_freq) {
            const float denom = log1pf((float)max(s_i[S_MAX_COUNT], 1));
            freq_score = log1pf((float)freq) / fmaxf(denom, 1e-9f);
            const float avg = coh_sum / (float)max(coh_cnt, 1);
            semantic = 1.0f / (1.0f + expf(avg - thr));
          }
          if (p.use_comp) {
            const float total = (float)max(s_i[S_CORPUS_TOKENS], 1);
            const float ratio = total / fmaxf(total - (float)freq, 1.0f);
            compression = fminf(fmaxf(ratio - 1.0f, 0.0f), 1.0f);
          }
          // The plain version's order of operations, unfused.
          float score = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(p.w_alpha, dist_score),
                                  __fmul_rn(p.w_beta, freq_score)),
                        __fmul_rn(p.w_gamma, semantic)),
              __fmul_rn(p.w_comp, compression));
          if (p.use_hier) {
            const int li = p.lengths[di];
            const int lj = p.lengths[dj];
            int h1, h2;
            compose_hash(p, di, dj, &h1, &h2);
            const int key = h1 * 65536 + h2;
            float m;
            if (pidx == 0) {
              m = (li <= 2 && lj <= 2) ? 0.8f : 0.2f;
            } else if (pidx == 1) {
              m = in_sorted(p.morph, p.morph_len, s_i[S_MORPH_SIZE], key)
                      ? 0.9f
                      : 0.3f;
            } else {
              const bool word =
                  in_sorted(p.word, p.word_len, s_i[S_WORD_SIZE], key) ||
                  (li + lj >= 3 && (p.has_vowel[di] | p.has_vowel[dj]));
              m = word ? 1.0f : 0.4f;
            }
            score = __fadd_rn(score, __fmul_rn(p.w_morph, m));
          }
          s_dscore = score;
        }
      }
    }

    // Rank the valid entries: exclusive block scan of per-thread counts
    // over contiguous runs of the queue, so ranks follow queue order.
    if (corpus) {
      int my_valid = 0;
      int my_live = 0;
      for (int e = lo; e < hi; ++e) {
        const bool live = qs[e] > -INFINITY;
        bool ok = live && (qd[e] < thr);
        if (kDense && dvalid) ok = ok && !(qi[e] == di && qj[e] == dj);
        my_live += live;
        my_valid += ok;
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
        bool ok = qs[e] > -INFINITY && qd[e] < thr;
        if (kDense && dvalid) ok = ok && !(qi[e] == di && qj[e] == dj);
        if (ok) {
          s_sel[rank] = e;
          ++rank;
        }
      }
    }
    __syncthreads();

    if (tid == 0) {
      const int n_valid = corpus ? s_n_valid : 0;
      const bool consumed_any = s_i[S_NM] > s_i[S_SYNCED];
      bool need_rs =
          corpus && s_i[S_QV0 + pidx] > p.k && consumed_any && n_valid < p.nb;
      // Corpus-only mode: a fully consumed queue waits for a sync. (K2 has
      // the dense channel whenever it has a corpus.)
      if (!kDense) need_rs = need_rs || (s_n_live == 0 && consumed_any);
      const int n_taken = min(n_valid, p.nb);
      // The dense candidate goes in at its rank among the taken entries,
      // ahead of entries with an equal score.
      int at = n_taken + 1;
      if (kDense && dvalid) {
        at = 0;
        for (int t = 0; t < n_taken; ++t) at += qs[s_sel[t]] > s_dscore;
      }
      int n = 0;
      for (int t = 0; t <= n_taken; ++t) {
        if (t == at) {
          s_ci[n] = di;
          s_cj[n] = dj;
          s_cd[n] = s_dd;
          ++n;
        }
        if (t < n_taken) {
          s_ci[n] = qi[s_sel[t]];
          s_cj[n] = qj[s_sel[t]];
          s_cd[n] = qd[s_sel[t]];
          ++n;
        }
      }
      s_need_rs = need_rs;
      s_n_apply = need_rs ? 0 : max(0, min(n, p.max_v - s_i[S_VOCAB]));
    }
    __syncthreads();

    const int n_apply = s_n_apply;
    // One warp per merge, by warp stride over the batch.
    for (int t = warp; t < n_apply; t += kWarps) {
      merge_one(p, lane, s_ci[t], s_cj[t], s_i[S_VOCAB] + t, s_i[S_NM] + t,
                s_cd[t], s_f[F_C]);
    }
    if (kDense) {
      // Invalidate row ci iff its tracked best was just consumed (best_j is
      // the pre-batch one: the fold below has not run).
      for (int t = tid; t < n_apply; t += kThreads) {
        if (p.best_j[s_ci[t]] == s_cj[t]) p.best_dist[s_ci[t]] = INFINITY;
      }
    }
    if (corpus && n_apply > 0) {
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

    if constexpr (kDense) {
      if (n_apply > 0) {
        // The batched column fold: every row r < vocab_post gains the new
        // columns slot > r that pass the length gate. The new rows,
        // signature-folded, are staged in shared memory all at once when
        // they fit (`whole`), else kFoldGroup rows at a time in chunks of
        // `kc` coordinates, restaged for every pass of kThreads rows.
        const int vocab0 = s_i[S_VOCAB];
        const int n_pad = (n_apply + kFoldGroup - 1) / kFoldGroup * kFoldGroup;
        const bool whole = n_pad * p.d1 <= kNewFloats;
        const int kc = whole ? p.d1 : kNewFloats / kFoldGroup;
        if (whole) {
          for (int f = tid; f < n_apply * p.d1; f += kThreads) {
            const int t = f / p.d1;
            const int e = f - t * p.d1;
            const float v = p.emb[(size_t)(vocab0 + t) * p.d1 + e];
            s_new[t * p.d1 + e] = e == 0 ? v : -v;
          }
        }
        for (int t = tid; t < n_apply; t += kThreads) {
          s_nlen[t] = p.lengths[vocab0 + t];
        }
        __syncthreads();
        const float sqrt_c = sqrtf(s_f[F_C]);
        const int vpost = vocab0 + n_apply;
        for (int r0 = 0; r0 < vpost; r0 += kThreads) {
          const int r = r0 + tid;
          const bool live = r < vpost;
          const float* row = p.emb + (size_t)(live ? r : 0) * p.d1;
          const int lr = live ? p.lengths[r] : 0;
          float best = live ? p.best_dist[r] : INFINITY;
          int arg = -1;
          for (int t0 = 0; t0 < n_apply; t0 += kFoldGroup) {
            float acc[kFoldGroup];
#pragma unroll
            for (int q = 0; q < kFoldGroup; ++q) acc[q] = 0.0f;
            for (int c0 = 0; c0 < p.d1; c0 += kc) {
              const int c1 = min(c0 + kc, p.d1);
              // s_new[q * stride + (e - off)] is coordinate e of new row
              // t0 + q.
              const float* buf = s_new + (whole ? t0 * p.d1 : 0);
              const int off = whole ? 0 : c0;
              if (!whole) {
                __syncthreads();
                const int w = c1 - c0;
                for (int f = tid; f < kFoldGroup * w; f += kThreads) {
                  const int q = f / w;
                  const int e = c0 + f - q * w;
                  const int t = t0 + q;
                  const float v =
                      t < n_apply ? p.emb[(size_t)(vocab0 + t) * p.d1 + e]
                                  : 0.0f;
                  s_new[q * kc + e - c0] = e == 0 ? v : -v;
                }
                __syncthreads();
              }
              const int stride = kc;
              if (live) {
                for (int e = c0; e < c1; ++e) {
                  const float x = row[e];
#pragma unroll
                  for (int q = 0; q < kFoldGroup; ++q) {
                    acc[q] = fmaf(buf[q * stride + e - off], x, acc[q]);
                  }
                }
              }
            }
#pragma unroll
            for (int q = 0; q < kFoldGroup; ++q) {
              const int t = t0 + q;
              if (live && t < n_apply && r < vocab0 + t &&
                  (p.max_token_len <= 0 ||
                   lr + s_nlen[t] <= p.max_token_len)) {
                const float d =
                    acosh_log(fmaxf(acc[q], 1.0f + kAcoshEps)) / sqrt_c;
                if (d < best) {
                  best = d;
                  arg = vocab0 + t;
                }
              }
            }
          }
          if (arg >= 0) {
            p.best_dist[r] = best;
            p.best_j[r] = arg;
          }
        }
        __syncthreads();
      }
    }

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

Params base_params(void* emb, void* lengths, void* byte_lengths,
                   void* has_vowel, void* token_hash, void* merges,
                   void* merge_dists, void* q_i, void* q_j, void* q_dist,
                   void* q_score, void* powers, void* si, void* sf, int max_v,
                   int d1, int k, int nb, int n_steps, int max_hash_len,
                   int use_hier, int phase2, int phase3, float thr1,
                   float thr2, float thr3, int adaptive, int growth_every,
                   float growth, int empty_after, float empty_growth,
                   int empty_stop) {
  Params p = {};
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
  return p;
}

// Launch one block of the K1 or K2 instance with the batch arrays of `nb`
// in dynamic shared memory.
template <bool kDense>
int launch(const Params& p, void* stream) {
  const int smem = batch_smem_bytes(p.nb);
  cudaError_t err = cudaFuncSetAttribute(
      enhanced_loop_kernel<kDense>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  enhanced_loop_kernel<kDense>
      <<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
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
  const Params p = base_params(
      emb, lengths, byte_lengths, has_vowel, token_hash, merges, merge_dists,
      q_i, q_j, q_dist, q_score, powers, si, sf, max_v, d1, k, nb, n_steps,
      max_hash_len, use_hier, phase2, phase3, thr1, thr2, thr3, adaptive,
      growth_every, growth, empty_after, empty_growth, empty_stop);
  return launch<false>(p, stream);
}

// K2: the arguments of enhanced_loop_launch, then the dense channel's
// buffers (best_dist, best_j, pair table, morph/word tables, coherence
// samples), their sizes, its switches and the score weights.
extern "C" int enhanced_loop_dense_launch(
    void* emb, void* lengths, void* byte_lengths, void* has_vowel,
    void* token_hash, void* merges, void* merge_dists, void* q_i, void* q_j,
    void* q_dist, void* q_score, void* powers, void* si, void* sf, int max_v,
    int d1, int k, int nb, int n_steps, int max_hash_len, int use_hier,
    int phase2, int phase3, float thr1, float thr2, float thr3, int adaptive,
    int growth_every, float growth, int empty_after, float empty_growth,
    int empty_stop, void* best_dist, void* best_j, void* pair_keys,
    void* pair_counts, void* morph, void* word, void* samples, int table_size,
    int morph_len, int word_len, int n_samples, int needs_corpus,
    int use_freq, int use_comp, int max_token_len,
    float w_alpha, float w_beta, float w_gamma, float w_comp, float w_morph,
    void* stream) {
  if (nb < 1 || nb > kMaxBatch || table_size < 1 || morph_len < 1 ||
      word_len < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = base_params(
      emb, lengths, byte_lengths, has_vowel, token_hash, merges, merge_dists,
      q_i, q_j, q_dist, q_score, powers, si, sf, max_v, d1, k, nb, n_steps,
      max_hash_len, use_hier, phase2, phase3, thr1, thr2, thr3, adaptive,
      growth_every, growth, empty_after, empty_growth, empty_stop);
  p.best_dist = static_cast<float*>(best_dist);
  p.best_j = static_cast<int*>(best_j);
  p.pair_keys = static_cast<const int*>(pair_keys);
  p.pair_counts = static_cast<const int*>(pair_counts);
  p.morph = static_cast<const int*>(morph);
  p.word = static_cast<const int*>(word);
  p.samples = static_cast<const int*>(samples);
  p.table_size = table_size;
  p.morph_len = morph_len;
  p.word_len = word_len;
  p.n_samples = n_samples;
  p.needs_corpus = needs_corpus;
  p.use_freq = use_freq;
  p.use_comp = use_comp;
  p.max_token_len = max_token_len;
  p.w_alpha = w_alpha;
  p.w_beta = w_beta;
  p.w_gamma = w_gamma;
  p.w_comp = w_comp;
  p.w_morph = w_morph;
  return launch<true>(p, stream);
}
