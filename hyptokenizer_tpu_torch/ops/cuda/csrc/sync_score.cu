// Kernel S1: the corpus sync's candidate scoring, every row of a fresh pair
// table in one launch.
//
// Replaces no pl.pallas_call: the JAX package scores the table with XLA ops
// in `_sync_finish` (hyptokenizer_tpu/tokenizer/enhanced_state.py), and the
// port took them over one PyTorch op at a time, about 700 launches a sync
// (the coherence gram alone 32 blocks of 4,096 rows, ~15-19 ops each). The
// plain version is hyptokenizer_tpu_torch/tokenizer/enhanced_state.py
// `score_candidates_plain`; the wrapper is ops/cuda/sync_score.py.
//
// What it computes, for each row t < n of the table (keys (n, 2), counts
// (n,)), in float32, what the plain version computes:
//   valid = keys[t, 0] != PKEY_SENT; (r, c) = keys[t];
//   dists[t] = valid ? acosh(max(<x_r, x_c>_L, 1 + ACOSH_EPS)) / sqrt(c)
//                    : inf;
//   dist_score = 1 / (1 + dists[t]);
//   [frequency] log1p(count) / max(log1p(max(max_count, 1)), 1e-9), and
//     the coherence: the length-weighted geodesic point m of (x_r, x_c)
//     (lorentz.geodesic_point; m = x_r for d < EXP_ZERO_TOL), its distances
//     acosh(max(<m, y_s>_L, 1 + GRAD_EPS)) / sqrt(c) to the sync's samples
//     s other than r and c, averaged over max(their number, 1), and
//     1 / (1 + exp(avg - threshold));
//   [compression] clamp(total / max(total - count, 1) - 1, 0, 1), total =
//     max(corpus_tokens, 1);
//   score = alpha dist_score + beta frequency + gamma coherence + comp_w
//     compression, and per phase [curriculum] + morph_w p_k, p1-p3 from the
//     token lengths, the composed hash's membership in the morphology and
//     word tables and the vowel flags;
//   scores[k, t] = score_k if valid, count >= min_pair_freq and (max_len <=
//     0 or len_r + len_c <= max_len), else -inf; one phase row without the
//     curriculum (its three columns are equal), three with it.
// Every scalar (curvature, threshold, max_count, corpus_tokens, the tables'
// sizes) is read from device memory, so the host reads nothing.
//
// Bound. The coherence is a gram: every row's midpoint against S samples,
// n * S * d1 multiply-adds (131,072 x 50 x 101 = 662M, 1.3 GFLOP: 20 us at
// the H100's 67 TFLOP/s in FP32 FMA; the configuration states float32 with
// TF32 off, so no tensor core). Bytes: each valid row reads its two
// embedding rows twice (the pair's dot, then the midpoint), 4 d1 floats,
// 1.6 KB at d1 = 101: 212 MB at n = 131,072, from the 50 MB L2, which the
// 20 MB embedding table fits (about 30 us at 7 TB/s), and writes 4 or 16
// bytes a row. A sentinel row reads its key only.
//
// Design. A block takes tiles of kTileRows = 64 rows, persistent over the
// table (the grid is the occupancy times the SM count). Per tile: each warp
// sums the Minkowski dots of 8 rows over its lanes (coalesced 128-byte row
// reads); one thread a row turns its dot into the distance and the
// geodesic coefficients. A tile of sentinels (the table's tail: it is
// sorted with its sentinels last) writes inf and -inf and goes on. The
// gram runs as a register-tiled SIMT matmul: the tile's midpoints and
// kTileSamples = 64 samples are staged in shared memory kChunk = 32
// coordinates at a time, k-major and signature-folded, and each thread
// holds a 4 x 4 block of (row, sample) sums, reading one float4 of each
// operand per coordinate for 16 FMAs. The midpoint's coordinates are made
// as the plain version makes them (__fmul_rn, __fadd_rn, __fdiv_rn; no
// contraction); the 16 threads of a row then apply the clamp, the acosh and
// the not-self mask to their 4 samples and add them up by shuffles. More
// than 64 samples take more passes; any d1 runs in chunks. One thread a row
// combines the terms with __fmul_rn/__fadd_rn in the plain version's order
// and writes the row.
//
// Numerics. The Minkowski dots (the pair's and the grams) and the coherence
// average are summed in another order than the plain version's; log1pf,
// expf and logf may differ from the host's by an ulp. Everything else
// rounds as the plain version rounds it. A row's bits do not depend on its
// place in the table, so a sharded sync that scores a rank's keys gives
// each candidate the bits the single-device sync gives it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace hyptok;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;     // table rows a block takes at a time
constexpr int kTileSamples = 64;  // coherence samples a pass
constexpr int kChunk = 32;        // coordinates staged at a time
constexpr int kStride = 68;       // floats a staged coordinate row (+4 pad)
constexpr int kRowGroups = kTileRows / 4;     // 4 rows a thread
constexpr int kSampleGroups = kTileSamples / 4;  // 4 samples a thread
static_assert(kRowGroups * kSampleGroups == kThreads, "one 4 x 4 block each");
static_assert(kSampleGroups == 16, "a row's threads are half a warp");
static_assert(kChunk == 32, "a staging item's coordinate is its lane");
constexpr int kPKeySent = 0x7fffffff;  // scoring.PKEY_SENT

struct Params {
  const int* keys;          // (n, 2) pair table rows, PKEY_SENT padded
  const int* counts;        // (n,)
  const float* emb;         // (V, d1)
  const int* lengths;       // (V,)
  const int* token_hash;    // (V, 2)
  const int* byte_lengths;  // (V,)
  const uint8_t* has_vowel;  // (V,) bool
  const int* powers;        // (2, max_hash_len)
  const int* morph;         // (morph_len,) sorted, HKEY_SENT padded
  const int* word;          // (word_len,) sorted, HKEY_SENT padded
  const int* samples;       // (n_samples,) coherence sample ids
  const float* curvature;   // 0-d
  const float* threshold;   // 0-d
  const int* max_count;     // 0-d
  const int* corpus_tokens;  // 0-d
  const int* morph_size;    // 0-d
  const int* word_size;     // 0-d
  float* dists;             // (n,)
  float* scores;            // (n_phases, n)
  int n, d1, max_hash_len, morph_len, word_len, n_samples;
  int use_freq, use_comp, use_hier, min_freq, max_token_len;
  float w_alpha, w_beta, w_gamma, w_comp, w_morph;
};

// The row's three morphology terms (enhanced_state._morph_scores_raw).
__device__ void morph_terms(const Params& p, int r, int c, int len_r,
                            int len_c, float* m) {
  int h1, h2;
  compose_hash(p.token_hash, p.byte_lengths, p.powers, p.max_hash_len, r, c,
               &h1, &h2);
  const int key = h1 * 65536 + h2;
  m[0] = (len_r <= 2 && len_c <= 2) ? 0.8f : 0.2f;
  m[1] = in_sorted(p.morph, p.morph_len, *p.morph_size, key) ? 0.9f : 0.3f;
  const bool word = in_sorted(p.word, p.word_len, *p.word_size, key) ||
                    (len_r + len_c >= 3 && (p.has_vowel[r] | p.has_vowel[c]));
  m[2] = word ? 1.0f : 0.4f;
}

__global__ void __launch_bounds__(kThreads)
    sync_score_kernel(const Params p) {
  __shared__ __align__(16) float s_mid[kChunk][kStride];
  __shared__ __align__(16) float s_samp[kChunk][kStride];
  __shared__ int s_row[kTileRows];
  __shared__ int s_col[kTileRows];
  __shared__ float s_dot[kTileRows];
  __shared__ float s_nx[kTileRows];
  __shared__ float s_ny[kTileRows];
  __shared__ float s_den[kTileRows];
  __shared__ int s_degen[kTileRows];
  __shared__ float s_csum[kTileRows];
  __shared__ int s_ccnt[kTileRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d1 = p.d1;
  const int n = p.n;
  const int n_phases = p.use_hier ? 3 : 1;
  const float sqrt_c = sqrtf(*p.curvature);
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const bool coherence = p.use_freq && p.n_samples > 0;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t0 = tile * kTileRows;
    // The tile's keys; a row past the end or a sentinel is -1.
    bool any = false;
    if (tid < kTileRows) {
      const int t = t0 + tid;
      int r = -1;
      int c = -1;
      if (t < n) {
        r = p.keys[2 * (size_t)t];
        c = p.keys[2 * (size_t)t + 1];
        if (r == kPKeySent) r = c = -1;
      }
      s_row[tid] = r;
      s_col[tid] = c;
      s_csum[tid] = 0.0f;
      s_ccnt[tid] = 0;
      any = r >= 0;
    }
    if (!__syncthreads_or(any)) {
      if (tid < kTileRows && t0 + tid < n) {
        const size_t t = (size_t)t0 + tid;
        p.dists[t] = INFINITY;
        for (int k = 0; k < n_phases; ++k) p.scores[k * (size_t)n + t] =
            -INFINITY;
      }
      continue;
    }

    // The pairs' Minkowski dots, a warp a row.
    for (int q = warp; q < kTileRows; q += kWarps) {
      const int r = s_row[q];
      if (r < 0) continue;
      const float* x = p.emb + (size_t)r * d1;
      const float* y = p.emb + (size_t)s_col[q] * d1;
      float dot = 0.0f;
#pragma unroll 4
      for (int e = lane; e < d1; e += 32) {
        const float v = x[e] * y[e];
        dot += (e == 0) ? v : -v;
      }
      dot = warp_sum_float(dot);
      if (lane == 0) s_dot[q] = dot;
    }
    __syncthreads();
    if (coherence && tid < kTileRows && s_row[tid] >= 0) {
      const Geodesic g = geodesic_coeffs(s_dot[tid], p.lengths[s_row[tid]],
                                         p.lengths[s_col[tid]]);
      s_nx[tid] = g.num_x;
      s_ny[tid] = g.num_y;
      s_den[tid] = g.den;
      s_degen[tid] = g.degenerate;
    }

    // The coherence gram: thread (rg, sg) sums rows 4 rg.. against samples
    // 4 sg.. of each pass.
    const int rg = tid / kSampleGroups;
    const int sg = tid % kSampleGroups;
    for (int s0 = 0; coherence && s0 < p.n_samples; s0 += kTileSamples) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
      for (int k0 = 0; k0 < d1; k0 += kChunk) {
        __syncthreads();  // the coefficients, or the last chunk's reads
        // Midpoints: item (row group g, coordinate kk), kk the lane.
        for (int it = tid; it < kRowGroups * kChunk; it += kThreads) {
          const int g = it / kChunk;
          const int e = k0 + it % kChunk;
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int q = 4 * g + u;
            const int r = s_row[q];
            v[u] = 0.0f;
            if (r >= 0 && e < d1) {
              const float x = p.emb[(size_t)r * d1 + e];
              const float y = p.emb[(size_t)s_col[q] * d1 + e];
              const float m =
                  s_degen[q] ? x
                             : __fdiv_rn(__fadd_rn(__fmul_rn(s_nx[q], x),
                                                   __fmul_rn(s_ny[q], y)),
                                         s_den[q]);
              v[u] = e == 0 ? m : -m;
            }
          }
          *reinterpret_cast<float4*>(&s_mid[it % kChunk][4 * g]) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
        // Samples: item (sample j, coordinate kk), kk the lane.
        for (int it = tid; it < kTileSamples * kChunk; it += kThreads) {
          const int j = it / kChunk;
          const int e = k0 + it % kChunk;
          float v = 0.0f;
          if (s0 + j < p.n_samples && e < d1) {
            v = p.emb[(size_t)p.samples[s0 + j] * d1 + e];
          }
          s_samp[it % kChunk][j] = v;
        }
        __syncthreads();
        const int nk = min(kChunk, d1 - k0);
#pragma unroll 8
        for (int kk = 0; kk < nk; ++kk) {
          const float4 a =
              *reinterpret_cast<const float4*>(&s_mid[kk][4 * rg]);
          const float4 b =
              *reinterpret_cast<const float4*>(&s_samp[kk][4 * sg]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
          }
        }
      }
      // The distances to this pass's samples, summed over a row's 16
      // threads (one half-warp).
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * rg + i;
        const int r = s_row[q];
        const int c = s_col[q];
        float sum = 0.0f;
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + 4 * sg + j;
          if (s < p.n_samples) {
            const int sid = p.samples[s];
            if (sid != r && sid != c) {
              sum += __fdiv_rn(acosh_log(fmaxf(acc[i][j], 1.0f + kGradEps)),
                               sqrt_c);
              ++cnt;
            }
          }
        }
#pragma unroll
        for (int o = kSampleGroups / 2; o > 0; o >>= 1) {
          sum += __shfl_xor_sync(kFull, sum, o);
          cnt += __shfl_xor_sync(kFull, cnt, o);
        }
        if (sg == 0) {
          s_csum[q] += sum;
          s_ccnt[q] += cnt;
        }
      }
    }
    __syncthreads();

    // One thread a row: the terms, the gate, the row's outputs.
    if (tid < kTileRows && t0 + tid < n) {
      const size_t t = (size_t)t0 + tid;
      const int r = s_row[tid];
      float dist = INFINITY;
      float score[3] = {-INFINITY, -INFINITY, -INFINITY};
      if (r >= 0) {
        const int c = s_col[tid];
        const int count = p.counts[t];
        const int len_r = p.lengths[r];
        const int len_c = p.lengths[c];
        dist = __fdiv_rn(acosh_log(fmaxf(s_dot[tid], 1.0f + kAcoshEps)),
                         sqrt_c);
        const bool ok = count >= p.min_freq &&
                        (p.max_token_len <= 0 ||
                         len_r + len_c <= p.max_token_len);
        if (ok) {
          const float dist_score = __fdiv_rn(1.0f, __fadd_rn(1.0f, dist));
          float freq_score = 0.0f;
          float semantic = 0.0f;
          float compression = 0.0f;
          if (p.use_freq) {
            const float denom = log1pf((float)max(*p.max_count, 1));
            freq_score = __fdiv_rn(log1pf((float)count), fmaxf(denom, 1e-9f));
            const float avg =
                __fdiv_rn(s_csum[tid], (float)max(s_ccnt[tid], 1));
            semantic = __fdiv_rn(
                1.0f, __fadd_rn(1.0f, expf(__fsub_rn(avg, *p.threshold))));
          }
          if (p.use_comp) {
            const float total = (float)max(*p.corpus_tokens, 1);
            const float ratio = __fdiv_rn(
                total, fmaxf(__fsub_rn(total, (float)count), 1.0f));
            compression = fminf(fmaxf(__fsub_rn(ratio, 1.0f), 0.0f), 1.0f);
          }
          // The plain version's order of operations, unfused.
          const float base = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(p.w_alpha, dist_score),
                                  __fmul_rn(p.w_beta, freq_score)),
                        __fmul_rn(p.w_gamma, semantic)),
              __fmul_rn(p.w_comp, compression));
          if (p.use_hier) {
            float m[3];
            morph_terms(p, r, c, len_r, len_c, m);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              score[k] = __fadd_rn(base, __fmul_rn(p.w_morph, m[k]));
            }
          } else {
            score[0] = base;
          }
        }
      }
      p.dists[t] = dist;
      for (int k = 0; k < n_phases; ++k) p.scores[k * (size_t)n + t] =
          score[k];
    }
  }
}

}  // namespace

// Scores and distances of the n rows of a pair table, one launch. Every
// pointer is device memory: keys (n, 2), counts (n,) int32; emb (V, d1)
// float32; lengths, byte_lengths (V,) and token_hash (V, 2) int32; has_vowel
// (V,) bool; powers (2, max_hash_len), morph (morph_len,), word (word_len,),
// samples (n_samples,) int32; the 0-d curvature and threshold (float32),
// max_count, corpus_tokens, morph_size and word_size (int32); the outputs
// dists (n,) and scores (use_hier ? 3 : 1, n) float32.
extern "C" int sync_score_launch(
    const void* keys, const void* counts, const void* emb,
    const void* lengths, const void* token_hash, const void* byte_lengths,
    const void* has_vowel, const void* powers, const void* morph,
    const void* word, const void* samples, const void* curvature,
    const void* threshold, const void* max_count, const void* corpus_tokens,
    const void* morph_size, const void* word_size, void* dists, void* scores,
    int n, int d1, int max_hash_len, int morph_len, int word_len,
    int n_samples, int use_freq, int use_comp, int use_hier, int min_freq,
    int max_token_len, float w_alpha, float w_beta, float w_gamma,
    float w_comp, float w_morph, void* stream) {
  if (n < 1 || d1 < 1 || max_hash_len < 1 || morph_len < 1 ||
      word_len < 1 || n_samples < 0) {
    return (int)cudaErrorInvalidValue;
  }
  static int grid_cap = 0;  // blocks resident at once, over all SMs
  if (grid_cap == 0) {
    int dev = 0;
    int sms = 0;
    int per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sync_score_kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return (int)err;
    grid_cap = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  Params p;
  p.keys = static_cast<const int*>(keys);
  p.counts = static_cast<const int*>(counts);
  p.emb = static_cast<const float*>(emb);
  p.lengths = static_cast<const int*>(lengths);
  p.token_hash = static_cast<const int*>(token_hash);
  p.byte_lengths = static_cast<const int*>(byte_lengths);
  p.has_vowel = static_cast<const uint8_t*>(has_vowel);
  p.powers = static_cast<const int*>(powers);
  p.morph = static_cast<const int*>(morph);
  p.word = static_cast<const int*>(word);
  p.samples = static_cast<const int*>(samples);
  p.curvature = static_cast<const float*>(curvature);
  p.threshold = static_cast<const float*>(threshold);
  p.max_count = static_cast<const int*>(max_count);
  p.corpus_tokens = static_cast<const int*>(corpus_tokens);
  p.morph_size = static_cast<const int*>(morph_size);
  p.word_size = static_cast<const int*>(word_size);
  p.dists = static_cast<float*>(dists);
  p.scores = static_cast<float*>(scores);
  p.n = n;
  p.d1 = d1;
  p.max_hash_len = max_hash_len;
  p.morph_len = morph_len;
  p.word_len = word_len;
  p.n_samples = n_samples;
  p.use_freq = use_freq;
  p.use_comp = use_comp;
  p.use_hier = use_hier;
  p.min_freq = min_freq;
  p.max_token_len = max_token_len;
  p.w_alpha = w_alpha;
  p.w_beta = w_beta;
  p.w_gamma = w_gamma;
  p.w_comp = w_comp;
  p.w_morph = w_morph;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int grid = n_tiles < grid_cap ? n_tiles : grid_cap;
  sync_score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
