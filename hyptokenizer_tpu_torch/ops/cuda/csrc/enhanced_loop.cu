// Kernels K1 and K2: a segment of scored merge steps of the enhanced
// tokenizer's loop, in one launch.
//
// Replace the TPU kernel hyptokenizer_tpu/ops/pallas/enhanced_loop.py:156
// (`_kernel`), reached there through `_run_segment` and `_run_chunk_fused`,
// in its two configurations: K1 is the corpus-only one (use_dense=False,
// `enhanced_loop_launch`, `corpus_loop_kernel`), K2 the dense one
// (use_dense=True, `enhanced_loop_dense_launch`, `dense_loop_kernel`); they
// share the merge, the halt check and the loop scalars. Semantics are those
// of the plain version,
// hyptokenizer_tpu_torch/tokenizer/enhanced_state.py `enhanced_step`,
// looped to the same halt conditions:
//
//   per step: [hierarchical phase from the merge count] -> [K2: the dense
//   candidate: block-wide argmin of best_dist over the active rows (lowest
//   index on ties), its full score (pair count by binary search of the
//   lexicographic pair table, or of the pair's owner slice of a
//   hash-partitioned one (n_buckets > 1), coherence of its midpoint
//   against the sync's samples, compression, morph/word membership of the
//   composed hash)] ->
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
// Design. K1 is one thread block of 1024 threads in two roles. Its choice
// of merges depends only on the queues and the threshold, and within a
// launch no queue entry names a token made in it (the queues come from the
// last sync), so the merges leave the step's critical path: 16 queue warps
// run the steps, and post each applied merge to a ring in shared memory
// that 16 merge warps drain, merge m on warp m % 16 (one merge a warp: both
// rows' first 128 coordinates and the pair's features in one round of
// loads). For the launch K1 keeps the phase queues in dynamic shared memory
// beside the ring: as many whole phases (16 B an entry) as
// enhanced_loop.smem_plan lets fit, from the launch's phase on (all three
// at 4096 entries and batch 16), the others read in global memory; q_score
// goes back at the end. At the launch it notes which phases repeat the
// launch phase entry for entry (the flagship's three queues are one queue
// three times) and indexes the launch phase's live entries by pair. A step
// of the queue warps, three barriers of their own: each warp counts the
// valid entries of its span of the phase's queue with a ballot a round (32
// consecutive entries); every warp scans the 16 warps' counts itself, so
// every thread knows the ranks, the resync flag and the batch size; the
// thread holding the entry of rank t posts it as merge `posted + t` and
// consumes it at once in the launch phase and the phases that repeat it
// (when the index found no pair held twice); the other phases, and the
// launch phase when the step selects elsewhere or a pair is held twice,
// are consumed after the batch is posted by a scan that compares an entry
// only with the merge owning its filter slot (the whole batch where two
// merges share it), a phase that repeats one taking its hits. One
// thread updates the loop scalars and takes the next step's halt check.
// The rows, features and history stay in device memory (L2).
// K2's block 0 runs the earlier form of the step (global queues, a block
// scan, a serial batch build) with the dense candidate in it. The batch's
// arrays live in dynamic shared memory sized by merge_batch. The warps
// take the applied merges of a batch by warp stride, one merge
// at a time (the midpoint needs only the pre-batch rows, and a batch never
// refers to a token made in the same batch). The dense candidate's
// coherence stages its midpoint in chunks of kMidChunk coordinates and
// holds kSampleBlock sample grams at a time, so neither d nor the sample
// count is bounded. The 128-lane row layout, the sum-extraction reads, the
// matmul prefix sums and the (g, 128, 128) fold tiles of the TPU kernel
// are TPU workarounds and are gone.
//
// K2 is a cooperative grid (the occupancy query times the SM count) whose
// block 0 runs everything K1 runs plus the dense candidate, and whose
// blocks all fold. Rows are owned in 32-row chunks by block (common.cuh
// `owned_row`). A step of block 0: reduce the blocks' partial minima of
// best_dist to the dense candidate, score it, scan and batch the queue,
// merge, invalidate and consume; then the fold. The fold stages the <=
// nb+1 new rows, signature-folded, in shared memory (all at once when they
// fit kNewFloats, else kFoldGroup rows at a time in chunks of
// coordinates), and folds them into the rows below vocab_post, kRowLanes
// lanes per row over the coordinates (kPer loads in flight at a time), with
// a strict < in increasing slot order (the plain version's lowest-column
// tie break); the same pass leaves the block's partial argmin for the
// next step. Block 0 publishes a fold event (vocab0, n_apply); every
// other block, waiting on the event's number, folds its own rows and adds
// one to a count; block 0 folds its own rows and waits for the count
// before it reads the partials of the next step. That is the two meeting points
// of a step (the other blocks wait for block 0's rows, then block 0 waits
// for their fold), each one-sided, so a step costs one event round trip
// and no full grid barrier; a step without merges costs none. The rows
// stay in global memory, served from L2: the curvature rescale rewrites
// them between launches.
//
// Bound. K1: a serial chain of merge_batch-sized steps, each touching a few
// K-entry queues and at most 2*nb+nb embedding rows: it moves far too few
// bytes to be bandwidth-bound and is bound by the latency of its serial
// steps (the queue warps' barriers and shared-memory scans; the merges'
// round of row loads through L2 runs beside them). K2, read once, adds
// the active rows (vocab x d1 x 4 B, about 20 MB at 49k rows and d+1 =
// 101) and the candidates; its fold needs 2 d1 + 8 FLOP per active row per
// merge, about 10 MFLOP per merge at 49k rows (0.15 us at 67 TFLOP/s).
// Both are far below block 0's serial step (queue scan, batch, merges) and
// the event round trip, which bound K2's step; spreading the fold and the
// argmin over the grid keeps them off that chain at any vocabulary.
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
constexpr int kRowLanes = 8;   // K2's fold: lanes per row, over coordinates
constexpr int kPer = 8;        // K2: loads in flight per lane before use
static_assert(kPer == 8, "the fold's loads go through ldcg8");
constexpr int kRowGroups = kThreads / kRowLanes;  // rows per pass of a block
// K2's event from block 0 to the other blocks: its number, then a halt
// flag or the fold's new rows (vocab0, n_apply).
enum { E_SEQ, E_HALT, E_VOCAB0, E_N_APPLY, E_COUNT };

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
  const int* pair_keys;  // (table_size, 2) lexicographically sorted, or
                         // n_buckets owner slices, each sorted
  const int* pair_counts;  // (table_size,)
  const int* morph;      // (morph_len,) sorted, padded
  const int* word;       // (word_len,) sorted, padded
  const int* samples;    // (n_samples,) coherence sample ids
  int table_size, morph_len, word_len, n_samples;
  int needs_corpus, use_freq, use_comp, max_token_len;
  int n_buckets;         // > 1: the table is hash-partitioned (pair_count)
  float w_alpha, w_beta, w_gamma, w_comp, w_morph;
  // K2's cooperative grid.
  float* part_v;         // (grid,) each block's minimum of best_dist
  int* part_i;           // (grid,) its row
  int* event;            // (E_COUNT,) block 0's last event, zeroed
  unsigned* done;        // (1,) events the other blocks finished, zeroed
  int* counts;           // (2,) K2's dense merges and empty-round
                         // threshold growths, or null
};

// The geodesic coefficients of rows ci and cj (common.cuh
// `geodesic_coeffs`), their Minkowski dot summed over one warp.
__device__ Geodesic geodesic(const Params& p, int lane, int ci, int cj) {
  const float* xi = p.emb + (size_t)ci * p.d1;
  const float* xj = p.emb + (size_t)cj * p.d1;
  float dot = 0.0f;
  for (int e = lane; e < p.d1; e += 32) {
    const float t = xi[e] * xj[e];
    dot += (e == 0) ? t : -t;
  }
  dot = warp_sum_float(dot);
  return geodesic_coeffs(dot, p.lengths[ci], p.lengths[cj]);
}

// One warp merges the pair (ci, cj), at distance `dist`, into row `slot`.
// Its loads go out in one round: the first 128 coordinates of both rows
// (four of each per lane, ldcg_pair4) and the pair's ten feature words on
// lanes 0-9 (lengths, byte lengths, hashes, vowel flags); only the hash
// powers wait for the byte length, read from `pow_cache` (the first
// n_cache powers of both residues, in shared memory) when it holds them.
// Each lane sums its coordinates in increasing order, as a plain loop
// would.
__device__ void merge_one(const Params& p, int lane, int ci, int cj,
                          int slot, int hist, float dist, float c,
                          const int* pow_cache, int n_cache) {
  const int d1 = p.d1;
  const float* xi = p.emb + (size_t)ci * d1;
  const float* xj = p.emb + (size_t)cj * d1;
  int feat = 0;
  if (lane < 8) {
    const int* src = lane < 2 ? p.lengths : lane < 4 ? p.byte_lengths
                                                     : p.token_hash;
    const int row = (lane < 4 ? (lane & 1) : (lane & 2)) ? cj : ci;
    feat = __ldcg(src + (lane < 4 ? row : 2 * row + (lane & 1)));
  } else if (lane < 10) {
    feat = __ldcg(p.has_vowel + (lane == 8 ? ci : cj));
  }
  int at[4];
  float x[4], y[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) at[u] = min(lane + 32 * u, d1 - 1);
  ldcg_pair4(xi, xj, at, x, y);
  float dot = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = lane + 32 * u;
    if (e < d1) {
      const float t = x[u] * y[u];
      dot += (e == 0) ? t : -t;
    }
  }
  for (int e = lane + 128; e < d1; e += 32) {
    const float t = __ldcg(xi + e) * __ldcg(xj + e);
    dot -= t;
  }
  dot = warp_sum_float(dot);
  const int li = __shfl_sync(kFull, feat, 0);
  const int lj = __shfl_sync(kFull, feat, 1);
  const int bi = __shfl_sync(kFull, feat, 2);
  const int bj = __shfl_sync(kFull, feat, 3);
  int pw = 0;
  if (lane < 2) {
    const int at = min(bj, p.max_hash_len - 1);
    pw = at < n_cache ? pow_cache[lane * n_cache + at]
                      : __ldcg(p.powers + lane * p.max_hash_len + at);
  }
  const Geodesic g = geodesic_coeffs(dot, li, lj);
  float* out = p.emb + (size_t)slot * d1;
  float sq = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = lane + 32 * u;
    if (e < d1 && e != 0) {
      const float v =
          g.degenerate ? x[u] : (g.num_x * x[u] + g.num_y * y[u]) / g.den;
      out[e] = v;
      sq += v * v;
    }
  }
  for (int e = lane + 128; e < d1; e += 32) {
    const float a = __ldcg(xi + e);
    const float v =
        g.degenerate ? a : (g.num_x * a + g.num_y * __ldcg(xj + e)) / g.den;
    out[e] = v;
    sq += v * v;
  }
  sq = warp_sum_float(sq);
  const int hi1 = __shfl_sync(kFull, feat, 4);
  const int hi2 = __shfl_sync(kFull, feat, 5);
  const int hj1 = __shfl_sync(kFull, feat, 6);
  const int hj2 = __shfl_sync(kFull, feat, 7);
  const int vowel = __shfl_sync(kFull, feat, 8) | __shfl_sync(kFull, feat, 9);
  const int p1 = __shfl_sync(kFull, pw, 0);
  const int p2 = __shfl_sync(kFull, pw, 1);
  if (lane != 0) return;
  out[0] = sqrtf(1.0f + c * sq);
  p.lengths[slot] = li + lj;
  p.merges[2 * hist] = ci;
  p.merges[2 * hist + 1] = cj;
  p.merge_dists[hist] = dist;
  p.token_hash[2 * slot] = (hi1 * p1 + hj1) % kHashP1;
  p.token_hash[2 * slot + 1] = (hi2 * p2 + hj2) % kHashP2;
  p.byte_lengths[slot] = bi + bj;
  p.has_vowel[slot] = vowel ? 1 : 0;
}

// The halt check at a step's top, and the phase (and its threshold) of the
// hierarchical curriculum; one thread.
__device__ void step_head(const Params& p, int* s_i, float* s_f,
                          int* s_halt) {
  const int nm = s_i[S_NM];
  const int halt = s_i[S_STOPPED] | s_i[S_RESYNC] |
                   (nm >= s_i[S_M_BUDGET]) |
                   (s_i[S_STEP] >= s_i[S_S_BUDGET]) |
                   (nm >= s_i[S_CURV_STOP]);
  *s_halt = halt;
  if (!halt && p.use_hier) {
    const int phase = 1 + (nm >= p.phase2) + (nm >= p.phase3);
    if (phase != s_i[S_PHASE]) s_f[F_THR] = p.phase_thr[phase - 1];
    s_i[S_PHASE] = phase;
  }
}

// The loop scalars after a step that flagged a resync or applied n_apply
// merges: counters, empty rounds, threshold growth, the full-vocabulary
// stop; one thread.
__device__ void step_scalars(const Params& p, int* s_i, float* s_f,
                             bool need_rs, int n_apply) {
  float thr2 = s_f[F_THR];
  if (need_rs) {
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
      const bool grow = (s_i[S_NM] / p.growth_every) > (nm0 / p.growth_every);
      thr2 = fminf(grow ? thr2 * p.growth : thr2, kThresholdCap);
    }
  }
  if (p.adaptive && p.growth_every > 0) thr2 = fminf(thr2, kThresholdCap);
  s_f[F_THR] = thr2;
  if (s_i[S_VOCAB] >= p.max_v) s_i[S_STOPPED] = 1;
}

// Owner slice of the pair (hi, lo) in a table of n > 1 hash partitions
// (scoring.pair_dest on scoring.pack_lex's key): the packed key, then the
// Fibonacci mix in unsigned 32-bit arithmetic, which wraps as the JAX
// package's int32 product does without a signed overflow; the shift is
// the int32 arithmetic shift.
__device__ int pair_owner(int hi, int lo, int n) {
  const uint32_t u = (uint32_t)hi * 65536u + (uint32_t)lo;
  const int32_t k = (int32_t)(u ^ 0x80000000u);
  const uint32_t h = ((uint32_t)k ^ (uint32_t)(k >> 15)) * 2654435769u;
  return (int)((h & 0x7FFFFFFFu) % (uint32_t)n);
}

// Count of (hi, lo) in the hash-partitioned table
// (scoring.lookup_pair_counts_hashed): a binary search of the owner's
// slice of table_size / n_buckets rows, each slice sorted by packed key,
// which is the lexicographic order of (hi, lo); 0 when absent.
__device__ int pair_count_hashed(const Params& p, int hi, int lo) {
  const int td = p.table_size / p.n_buckets;
  const int off = pair_owner(hi, lo, p.n_buckets) * td;
  const int* keys = p.pair_keys + 2 * off;
  int a = 0;
  int b = td;
  while (a < b) {
    const int mid = (a + b) >> 1;
    const int mh = keys[2 * mid];
    const int ml = keys[2 * mid + 1];
    if (mh < hi || (mh == hi && ml < lo)) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  const int pos = min(a, td - 1);
  return (keys[2 * pos] == hi && keys[2 * pos + 1] == lo)
             ? p.pair_counts[off + pos]
             : 0;
}

// Count of the pair (hi, lo) in the lexicographically sorted pair table, 0
// when absent (scoring.lookup_pair_counts); in the owner's slice of a
// hash-partitioned table when n_buckets > 1.
__device__ int pair_count(const Params& p, int hi, int lo) {
  if (p.n_buckets > 1) return pair_count_hashed(p, hi, lo);
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

constexpr int kSampleBlock = 512;  // K2's coherence grams held at a time

// K2: the block's (minimum of best_dist, row) over its rows, lowest row on
// ties, from each thread's (v, i) to partial b (block 0 reduces them).
__device__ void publish_partial(const Params& p, int b, float v, int i,
                                float* s_red_f, int* s_red_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmin(v, i);
  if (lane == 0) {
    s_red_f[warp] = v;
    s_red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = s_red_f[lane];
    i = s_red_i[lane];
    warp_argmin(v, i);
    if (lane == 0) {
      p.part_v[b] = v;
      p.part_i[b] = i;
    }
  }
}

// The partial of the rows below `vocab` that block b of g owns.
__device__ void first_partial(const Params& p, int vocab, int b, int g,
                              float* s_red_f, int* s_red_i) {
  float v = INFINITY;
  int i = INT_MAX;
  for (int k = threadIdx.x;; k += kThreads) {
    const int r = owned_row(k, b, g);
    if (r >= vocab) break;
    argmin_step(v, i, p.best_dist[r], r);
  }
  publish_partial(p, b, v, i, s_red_f, s_red_i);
}

// One row of K2's fold, held by its kRowLanes lanes.
struct FoldRow {
  const float* row;  // its coordinates
  int r, len;        // row, token length
  bool live;         // r < vocab_post
  float best;        // its candidate, updated by the fold
  int arg;           // the new column that improved it, or -1
};

// New columns t0 .. t0 + NQ of K2's fold (those below n_apply count)
// against one row: kRowLanes lanes take its coordinates, kPer loads in
// flight each, then a strict < in increasing slot order. Staging of the
// columns by slabs (when not `whole`) is shared by the block.
template <int NQ>
__device__ void fold_columns(const Params& p, float* s_new,
                             const int* s_nlen, int vocab0, int n_apply,
                             int t0, bool whole, int kc, float sqrt_c,
                             FoldRow& fr) {
  const int tid = threadIdx.x;
  const int sub = tid & (kRowLanes - 1);
  const int d1 = p.d1;
  const int nq = min(NQ, n_apply - t0);
  float acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.0f;
  for (int c0 = 0; c0 < d1; c0 += kc) {
    const int c1 = min(c0 + kc, d1);
    // buf[q * kc + (e - off)] is coordinate e of new row t0 + q.
    const float* buf = s_new + (whole ? t0 * d1 : 0);
    const int off = whole ? 0 : c0;
    if (!whole) {
      __syncthreads();
      const int w = c1 - c0;
      for (int f = tid; f < kFoldGroup * w; f += kThreads) {
        const int q = f / w;
        const int e = c0 + f - q * w;
        const int t = t0 + q;
        const float v =
            t < n_apply ? __ldcg(p.emb + (size_t)(vocab0 + t) * d1 + e)
                        : 0.0f;
        s_new[q * kc + e - c0] = e == 0 ? v : -v;
      }
      __syncthreads();
    }
    if (fr.live) {
      for (int e0 = c0 + sub; e0 < c1; e0 += kRowLanes * kPer) {
        // All kPer loads in flight at once (addresses past c1 clamped to
        // the row's last coordinate; their values are not used).
        int at[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) at[u] = min(e0 + kRowLanes * u, c1 - 1);
        float x[kPer];
        ldcg8(fr.row, at, x);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int e = e0 + kRowLanes * u;
          if (e < c1) {
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              acc[q] = fmaf(buf[q * kc + e - off], x[u], acc[q]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    for (int o = 1; o < kRowLanes; o <<= 1) {
      acc[q] += __shfl_xor_sync(kFull, acc[q], o);
    }
  }
  if (fr.live && sub == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int t = t0 + q;
      if (q < nq && fr.r < vocab0 + t &&
          (p.max_token_len <= 0 || fr.len + s_nlen[t] <= p.max_token_len)) {
        const float d = acosh_log(fmaxf(acc[q], 1.0f + kAcoshEps)) / sqrt_c;
        if (d < fr.best) {
          fr.best = d;
          fr.arg = vocab0 + t;
        }
      }
    }
  }
}

// K2's batched column fold over the rows block b of g owns: every row r <
// vocab0 + n_apply gains the new columns slot > r that pass the length
// gate, with a strict < in increasing slot order (the plain version's
// lowest-column tie break); in the same pass, the block's partial argmin
// of best_dist for the next step. The new rows, signature-folded, are
// staged in shared memory all at once when they fit kNewFloats (`whole`),
// else kFoldGroup rows at a time in chunks of `kc` coordinates, restaged
// for every pass of kRowGroups rows. kRowLanes lanes take a row, by
// coordinates, so a warp's loads cover a few contiguous pieces of rows.
// Rows, lengths and candidates written by other blocks (block 0's new
// rows and invalidations) are read through L2.
__device__ void dense_fold(const Params& p, int vocab0, int n_apply,
                           float sqrt_c, int b, int g, float* s_new,
                           int* s_nlen, float* s_red_f, int* s_red_i) {
  const int tid = threadIdx.x;
  const int sub = tid & (kRowLanes - 1);
  const int grp = tid / kRowLanes;
  const int d1 = p.d1;
  const int vpost = vocab0 + n_apply;
  const int n_pad = (n_apply + kFoldGroup - 1) / kFoldGroup * kFoldGroup;
  const bool whole = n_pad * d1 <= kNewFloats;
  const int kc = whole ? d1 : kNewFloats / kFoldGroup;
  if (whole) {
    for (int f = tid; f < n_apply * d1; f += kThreads) {
      const int t = f / d1;
      const int e = f - t * d1;
      const float v = __ldcg(p.emb + (size_t)(vocab0 + t) * d1 + e);
      s_new[t * d1 + e] = e == 0 ? v : -v;
    }
  }
  for (int t = tid; t < n_apply; t += kThreads) {
    s_nlen[t] = __ldcg(p.lengths + vocab0 + t);
  }
  __syncthreads();
  HYPTOK_MARK(7);
  float pv = INFINITY;
  int pi = INT_MAX;
  for (int k0 = 0; owned_row(k0, b, g) < vpost; k0 += kRowGroups) {
    FoldRow fr;
    fr.r = owned_row(k0 + grp, b, g);
    fr.live = fr.r < vpost;
    fr.row = p.emb + (size_t)(fr.live ? fr.r : 0) * d1;
    fr.len = fr.live ? __ldcg(p.lengths + fr.r) : 0;
    fr.best = fr.live ? __ldcg(p.best_dist + fr.r) : INFINITY;
    fr.arg = -1;
    HYPTOK_MARK(11);
    for (int t0 = 0; t0 < n_apply; t0 += kFoldGroup) {
      // Instantiated for the group's width, so that one new column (the
      // common case) costs one FMA per coordinate, not kFoldGroup.
      const int nq = min(kFoldGroup, n_apply - t0);
      if (nq == 1) {
        fold_columns<1>(p, s_new, s_nlen, vocab0, n_apply, t0, whole, kc,
                        sqrt_c, fr);
      } else if (nq == 2) {
        fold_columns<2>(p, s_new, s_nlen, vocab0, n_apply, t0, whole, kc,
                        sqrt_c, fr);
      } else if (nq <= 4) {
        fold_columns<4>(p, s_new, s_nlen, vocab0, n_apply, t0, whole, kc,
                        sqrt_c, fr);
      } else {
        fold_columns<8>(p, s_new, s_nlen, vocab0, n_apply, t0, whole, kc,
                        sqrt_c, fr);
      }
    }
    HYPTOK_MARK(12);
    if (fr.live && sub == 0) {
      if (fr.arg >= 0) {
        p.best_dist[fr.r] = fr.best;
        p.best_j[fr.r] = fr.arg;
      }
      argmin_step(pv, pi, fr.best, fr.r);
    }
    HYPTOK_MARK(13);
  }
  HYPTOK_MARK(8);
  publish_partial(p, b, pv, pi, s_red_f, s_red_i);
  HYPTOK_MARK(9);
}

// Block 0 waits until the other blocks have finished `expect` events.
__device__ void wait_done(const Params& p, unsigned expect) {
  if (threadIdx.x == 0) {
    while (*(volatile unsigned*)p.done < expect) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// Block 0 publishes event `seq` once its writes (rows, invalidations) are
// out.
__device__ void publish_event(const Params& p, int seq, int halt,
                              int vocab0, int n_apply) {
  __syncthreads();
  if (threadIdx.x == 0) {
    p.event[E_HALT] = halt;
    p.event[E_VOCAB0] = vocab0;
    p.event[E_N_APPLY] = n_apply;
    __threadfence();
    *(volatile int*)(p.event + E_SEQ) = seq;
  }
}

// The blocks of K2 other than block 0: the first partial, then a fold on
// each of block 0's fold events, each counted in `done`, until its halt
// event. Block 0 publishes an event only after every block finished the
// last.
__device__ void follow(const Params& p, int vocab, float sqrt_c,
                       float* s_new, int* s_nlen, float* s_red_f,
                       int* s_red_i, int* s_ev) {
  const int b = blockIdx.x;
  const int g = gridDim.x;
  first_partial(p, vocab, b, g, s_red_f, s_red_i);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(p.done, 1u);
  }
  for (int seen = 1;; ++seen) {
    if (threadIdx.x == 0) {
      while (*(volatile int*)(p.event + E_SEQ) < seen) __nanosleep(32);
      __threadfence();
      s_ev[0] = __ldcg(p.event + E_HALT);
      s_ev[1] = __ldcg(p.event + E_VOCAB0);
      s_ev[2] = __ldcg(p.event + E_N_APPLY);
    }
    __syncthreads();
    if (s_ev[0]) break;
    dense_fold(p, s_ev[1], s_ev[2], sqrt_c, b, g, s_new, s_nlen, s_red_f,
               s_red_i);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(p.done, 1u);
    }
  }
}

// Bytes of K2's batch arrays in dynamic shared memory for a queue batch nb:
// the selected queue entries (nb) and the applied merges (nb + 1, with the
// dense candidate): rows i, j, distance, new length.
inline int batch_smem_bytes(int nb) { return (nb + 4 * (nb + 1)) * 4; }

// K2: the dense configuration's segment (see the note at the top).
__global__ void __launch_bounds__(kThreads, 1)
dense_loop_kernel(Params p) {
  __shared__ int s_i[S_COUNT];
  __shared__ float s_f[F_COUNT];
  __shared__ int s_scan[kWarps];
  extern __shared__ int s_dyn[];
  int* s_sel = s_dyn;                    // (nb,)
  int* s_ci = s_sel + p.nb;              // (nb + 1,)
  int* s_cj = s_ci + p.nb + 1;           // (nb + 1,)
  float* s_cd = reinterpret_cast<float*>(s_cj + p.nb + 1);  // (nb + 1,)
  int* s_nlen = reinterpret_cast<int*>(s_cd + p.nb + 1);    // (nb + 1,)
  __shared__ int s_halt, s_need_rs, s_n_apply, s_n_valid;
  // The dense candidate, its coherence terms and the fold's new rows.
  __shared__ float s_red_f[kWarps];
  __shared__ int s_red_i[kWarps];
  __shared__ float s_mid[kMidChunk];
  __shared__ float s_coh[kSampleBlock];
  __shared__ float s_new[kNewFloats];
  __shared__ float s_geo[3];
  __shared__ int s_degen;
  __shared__ int s_di, s_dj, s_dvalid;
  __shared__ float s_dd, s_dscore;
  __shared__ int s_ev[3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < S_COUNT) s_i[tid] = p.si[tid];
  if (tid < F_COUNT) s_f[tid] = p.sf[tid];
  __syncthreads();
  // A cooperative grid: block 0 runs the steps, the other blocks fold
  // their rows on its events (`follow`).
  const float sqrt_c = sqrtf(s_f[F_C]);
  const int n_blocks = gridDim.x;
  if (blockIdx.x != 0) {
    follow(p, s_i[S_VOCAB], sqrt_c, s_new, s_nlen, s_red_f, s_red_i, s_ev);
    return;
  }
  first_partial(p, s_i[S_VOCAB], 0, n_blocks, s_red_f, s_red_i);
  unsigned expect = n_blocks - 1;  // events the other blocks must finish
  int seq = 0;                     // block 0's last event

  const int per = (p.k + kThreads - 1) / kThreads;
  const int lo = min(tid * per, p.k);
  const int hi = min(lo + per, p.k);
  const bool corpus = p.needs_corpus;

  HYPTOK_MARK(-1);
  for (int s = 0; s < p.n_steps; ++s) {
    if (tid == 0) step_head(p, s_i, s_f, &s_halt);
    __syncthreads();
    if (s_halt) break;
    HYPTOK_MARK(0);

    const int pidx = min(max(s_i[S_PHASE] - 1, 0), 2);
    const float thr = s_f[F_THR];
    const int* qi = p.q_i + (size_t)pidx * p.k;
    const int* qj = p.q_j + (size_t)pidx * p.k;
    const float* qd = p.q_dist + (size_t)pidx * p.k;
    const float* qs = p.q_score + (size_t)pidx * p.k;

    int di = 0;
    int dj = 0;
    bool dvalid = false;
    {
      // The dense candidate: argmin of best_dist over the active rows,
      // lowest index on ties, from the blocks' partials over their rows
      // (written by the last fold, read through L2).
      wait_done(p, expect);
      HYPTOK_MARK(1);
      if (warp == 0) {
        float bv = INFINITY;
        int bi = INT_MAX;
        for (int q0 = lane; q0 < n_blocks; q0 += 32 * kPer) {
          float part_v[kPer];
          int part_i[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int q = q0 + 32 * u;
            part_v[u] = q < n_blocks ? __ldcg(p.part_v + q) : INFINITY;
            part_i[u] = q < n_blocks ? __ldcg(p.part_i + q) : INT_MAX;
          }
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            argmin_step(bv, bi, part_v[u], part_i[u]);
          }
        }
        warp_argmin(bv, bi);
        if (lane == 0) {
          const int i0 = bi == INT_MAX ? 0 : bi;
          const float d0 = __ldcg(p.best_dist + i0);
          const int j0 = min(max(__ldcg(p.best_j + i0), 0), p.max_v - 1);
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
            compose_hash(p.token_hash, p.byte_lengths, p.powers,
                         p.max_hash_len, di, dj, &h1, &h2);
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

    HYPTOK_MARK(2);
    // Rank the valid entries: exclusive block scan of per-thread counts
    // over contiguous runs of the queue, so ranks follow queue order.
    if (corpus) {
      int my_valid = 0;
      for (int e = lo; e < hi; ++e) {
        bool ok = qs[e] > -INFINITY && qd[e] < thr;
        if (dvalid) ok = ok && !(qi[e] == di && qj[e] == dj);
        my_valid += ok;
      }
      int incl = my_valid;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) s_scan[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int v = s_scan[lane];
        int inc = v;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(kFull, inc, o);
          if (lane >= o) inc += u;
        }
        __syncwarp();
        s_scan[lane] = inc - v;
        if (lane == 31) s_n_valid = inc;
      }
      __syncthreads();
      int rank = s_scan[warp] + incl - my_valid;
      for (int e = lo; e < hi && rank < p.nb; ++e) {
        bool ok = qs[e] > -INFINITY && qd[e] < thr;
        if (dvalid) ok = ok && !(qi[e] == di && qj[e] == dj);
        if (ok) {
          s_sel[rank] = e;
          ++rank;
        }
      }
    }
    __syncthreads();
    HYPTOK_MARK(3);

    if (tid == 0) {
      const int n_valid = corpus ? s_n_valid : 0;
      const bool consumed_any = s_i[S_NM] > s_i[S_SYNCED];
      // (A fully consumed queue needs no resync here: the dense channel
      // still has candidates.)
      const bool need_rs =
          corpus && s_i[S_QV0 + pidx] > p.k && consumed_any && n_valid < p.nb;
      const int n_taken = min(n_valid, p.nb);
      // The dense candidate goes in at its rank among the taken entries,
      // ahead of entries with an equal score.
      int at = n_taken + 1;
      if (dvalid) {
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
      if (p.counts != nullptr && !need_rs) {
        if (dvalid && at < s_n_apply) ++p.counts[0];
        // step_scalars grows the threshold after this empty round.
        if (s_n_apply == 0 && p.adaptive &&
            s_i[S_EMPTY] + 1 >= p.empty_after) {
          ++p.counts[1];
        }
      }
    }
    __syncthreads();

    HYPTOK_MARK(4);
    const int n_apply = s_n_apply;
    const int vocab0 = s_i[S_VOCAB];
    // One warp per merge, by warp stride over the batch.
    for (int t = warp; t < n_apply; t += kWarps) {
      merge_one(p, lane, s_ci[t], s_cj[t], s_i[S_VOCAB] + t, s_i[S_NM] + t,
                s_cd[t], s_f[F_C], nullptr, 0);
    }
    {
      // Invalidate row ci iff its tracked best was just consumed (best_j
      // is the pre-batch one: the grid's fold runs after barrier A).
      for (int t = tid; t < n_apply; t += kThreads) {
        if (__ldcg(p.best_j + s_ci[t]) == s_cj[t]) {
          p.best_dist[s_ci[t]] = INFINITY;
        }
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
    HYPTOK_MARK(5);

    if (tid == 0) step_scalars(p, s_i, s_f, s_need_rs, n_apply);
    __syncthreads();

    // The fold: every block on its own rows (block 0 publishes the event;
    // the next step's candidate waits for the others to finish).
    HYPTOK_MARK(6);
    if (n_apply > 0) {
      publish_event(p, ++seq, 0, vocab0, n_apply);
      expect += n_blocks - 1;
      dense_fold(p, vocab0, n_apply, sqrt_c, 0, n_blocks, s_new, s_nlen,
                 s_red_f, s_red_i);
    }
    HYPTOK_MARK(10);
  }

  // The other blocks stop after the last fold.
  wait_done(p, expect);
  publish_event(p, ++seq, 1, 0, 0);
  if (tid < S_COUNT) p.si[tid] = s_i[tid];
  if (tid < F_COUNT) p.sf[tid] = s_f[tid];
}

// K1: the corpus-only configuration's segment, one block.
constexpr int kOwnerSlots = 1024;    // the batch's pair filter
constexpr int kIndexSlots = 8192;    // the launch phase's pair index
constexpr unsigned short kNoEntry = 0xFFFF;
constexpr int kPowCache = 64;              // hash powers kept on chip

// Hash of the ordered pair (a, b); its top bits pick a slot (the low bits
// of a product see only the low bits of the ids).
__device__ __forceinline__ unsigned pair_hash(int a, int b) {
  return (unsigned)a * 0x9E3779B1u ^ (unsigned)b * 0x85EBCA77u;
}

// Slot of the ordered pair (a, b) in the batch's pair filter.
__device__ __forceinline__ unsigned pair_slot(int a, int b) {
  return pair_hash(a, b) >> 22;
}

// First slot of the ordered pair (a, b) in the launch phase's pair index.
__device__ __forceinline__ unsigned index_slot(int a, int b) {
  return pair_hash(a, b) >> 19;
}

// One phase's queue: held in shared memory for the launch, as (q_i, q_j)
// and (q_dist, q_score) pairs, or read in its global arrays.
struct Queue {
  const int2* ij;  // resident pairs, or null
  float2* ds;      // resident (dist, score), or null
  const int* qi;   // the global arrays
  const int* qj;
  const float* qd;
  float* qs;
};

__device__ __forceinline__ int2 q_pair(const Queue& q, int e) {
  return q.ij ? q.ij[e] : make_int2(q.qi[e], q.qj[e]);
}

__device__ __forceinline__ float2 q_dist_score(const Queue& q, int e) {
  return q.ds ? q.ds[e] : make_float2(q.qd[e], q.qs[e]);
}

__device__ __forceinline__ void q_consume(const Queue& q, int e) {
  if (q.ds) {
    q.ds[e].y = -INFINITY;
  } else {
    q.qs[e] = -INFINITY;
  }
}

// Phase `ph`'s queue: resident slot (ph - p0) mod 3 when below n_res (the
// launch holds phases p0, p0 + 1, ... in that order, each k pairs then k
// (dist, score)), else global memory.
__device__ __forceinline__ Queue queue_of(const Params& p, int2* s_q,
                                          int n_res, int p0, int ph) {
  const size_t o = (size_t)ph * p.k;
  Queue q = {nullptr,     nullptr,     p.q_i + o,
             p.q_j + o,   p.q_dist + o, p.q_score + o};
  const int r = (ph - p0 + 3) % 3;
  if (r < n_res) {
    q.ij = s_q + (size_t)r * 2 * p.k;
    q.ds = reinterpret_cast<float2*>(s_q + (size_t)r * 2 * p.k + p.k);
  }
  return q;
}

// The block's roles: the first kQueueWarps warps run the steps (queue
// scan, batch, consumption, scalars) with a named barrier of their own;
// the other warps merge, each merge m by warp kQueueWarps + m % kMergeWarps,
// from a ring of the applied merges in shared memory.
constexpr int kQueueWarps = 16;
constexpr int kQueueThreads = 32 * kQueueWarps;
constexpr int kMergeWarps = kWarps - kQueueWarps;
constexpr int kQueueBarrier = 1;

__device__ __forceinline__ void queue_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kQueueBarrier), "n"(kQueueThreads)
               : "memory");
}

__device__ __forceinline__ int vload(const int* x) {
  return *(const volatile int*)x;
}

__global__ void __launch_bounds__(kThreads, 1)
corpus_loop_kernel(Params p, int n_res, int ring) {
  __shared__ int s_i[S_COUNT];
  __shared__ float s_f[F_COUNT];
  __shared__ int s_scan[kQueueWarps];
  __shared__ int s_live[kQueueWarps];
  // Slot -> the applied merge (its rank in the step's batch) whose pair
  // has it, -1 for none, -2 for two or more (then the batch is compared):
  // the consumption scan's filter.
  __shared__ int s_owner[kOwnerSlots];
  // The launch phase's live entries by pair, open addressing with linear
  // probing (entry index, kNoEntry for an empty slot), when k is at most
  // half the slots: it finds a pair held twice. When none is (s_dup
  // clear), a step that selects from that phase consumes it, and every
  // phase that mirrors it, at the selected entries' own indices.
  __shared__ unsigned short s_index[kIndexSlots];
  __shared__ int s_dup;
  __shared__ int s_halt;
  __shared__ int s_pow[2 * kPowCache];
  // Phase -> the phase whose queue pairs it repeats entry for entry (its
  // own index when none): its consumption copies that phase's hits.
  __shared__ int s_mirror[3];
  // The ring: merges posted by the queue warps, merges done by each merge
  // warp, and the queue warps' end.
  __shared__ int s_posted;
  __shared__ int s_done[kMergeWarps];
  __shared__ int s_finished;
  extern __shared__ int2 s_dyn2[];
  int* r_ci = reinterpret_cast<int*>(s_dyn2);  // (ring,) merge m at m % ring
  int* r_cj = r_ci + ring;
  float* r_cd = reinterpret_cast<float*>(r_cj + ring);
  // The resident queues, 8-byte aligned after the ring.
  int2* s_q = s_dyn2 + (3 * ring + 1) / 2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = p.k;
  HYPTOK_MARK(-1);
  if (tid < S_COUNT) s_i[tid] = p.si[tid];
  if (tid < F_COUNT) s_f[tid] = p.sf[tid];
  for (int w = tid; w < kOwnerSlots; w += kThreads) s_owner[w] = -1;
  for (int w = tid; w < kIndexSlots; w += kThreads) s_index[w] = kNoEntry;
  if (tid < kMergeWarps) s_done[tid] = 0;
  if (tid == 0) {
    s_posted = 0;
    s_finished = 0;
    s_dup = 0;
  }
  const int n_pow = min(kPowCache, p.max_hash_len);
  if (tid < 2 * n_pow) {
    s_pow[tid] = __ldcg(p.powers + (tid / n_pow) * p.max_hash_len +
                        tid % n_pow);
  }
  // Stage the resident phases: the launch's phase first.
  const int p0 = min(max(p.si[S_PHASE] - 1, 0), 2);
  for (int r = 0; r < n_res; ++r) {
    const size_t o = (size_t)((p0 + r) % 3) * k;
    int2* ij = s_q + (size_t)r * 2 * k;
    float2* ds = reinterpret_cast<float2*>(ij + k);
#pragma unroll 4
    for (int e = tid; e < k; e += kThreads) {
      ij[e] = make_int2(__ldcg(p.q_i + o + e), __ldcg(p.q_j + o + e));
      ds[e] = make_float2(__ldcg(p.q_dist + o + e), __ldcg(p.q_score + o + e));
    }
  }
  // A phase whose pairs and live entries equal the launch phase's, entry
  // for entry, takes its consumption from that phase's (the flagship's
  // three queues are one queue three times).
  __syncthreads();
  const Queue q0 = queue_of(p, s_q, n_res, p0, p0);
  for (int ph = 0; ph < 3; ++ph) {
    bool same = true;
    if (ph != p0) {
      const Queue v = queue_of(p, s_q, n_res, p0, ph);
      for (int e = tid; e < k; e += kThreads) {
        const int2 x = q_pair(q0, e);
        const int2 y = q_pair(v, e);
        same = same && x.x == y.x && x.y == y.y &&
               (q_dist_score(q0, e).y > -INFINITY) ==
                   (q_dist_score(v, e).y > -INFINITY);
      }
    }
    same = __syncthreads_and(same);
    if (tid == 0) s_mirror[ph] = same ? p0 : ph;
  }
  const bool indexed = 2 * k <= kIndexSlots;
  if (indexed) {
    // Index the launch phase's live entries (a dead or unstored entry
    // needs no consuming).
    for (int e = tid; e < k; e += kThreads) {
      if (!(q_dist_score(q0, e).y > -INFINITY)) continue;
      const int2 pr = q_pair(q0, e);
      unsigned short old;
      for (unsigned h = index_slot(pr.x, pr.y);
           (old = atomicCAS(&s_index[h], kNoEntry, (unsigned short)e)) !=
           kNoEntry;
           h = (h + 1) & (kIndexSlots - 1)) {
        const int2 o = q_pair(q0, old);
        if (o.x == pr.x && o.y == pr.y) s_dup = 1;
      }
    }
  }
  __syncthreads();
  const bool unique = indexed && !s_dup;
  const float c = s_f[F_C];
  // Merge m makes row vocab_start + m and history entry nm_start + m.
  const int vocab_start = s_i[S_VOCAB];
  const int nm_start = s_i[S_NM];

  if (warp >= kQueueWarps) {
    // A merge warp: its merges in order, each once the queue warps have
    // posted it; a count of the done ones frees their ring entries.
    const int j = warp - kQueueWarps;
    for (int m = j, n = 0;; m += kMergeWarps, ++n) {
      int posted = 0;
      if (lane == 0) {
        for (;;) {
          posted = vload(&s_posted);
          if (m < posted) break;
          if (vload(&s_finished)) {
            posted = vload(&s_posted);
            break;
          }
          __nanosleep(20);
        }
      }
      posted = __shfl_sync(kFull, posted, 0);
      if (m >= posted) break;
      __threadfence_block();
      const int at = m % ring;
      merge_one(p, lane, r_ci[at], r_cj[at], vocab_start + m, nm_start + m,
                r_cd[at], c, s_pow, n_pow);
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *(volatile int*)&s_done[j] = n + 1;
      }
    }
    return;
  }

  // The queue warps: the steps. Each warp scans a contiguous span of the
  // queue, 32 entries a round.
  if (tid == kQueueThreads - 32 && p.n_steps > 0) {
    step_head(p, s_i, s_f, &s_halt);
  }
  const int rounds = (k + kQueueThreads - 1) / kQueueThreads;
  const int span0 = warp * 32 * rounds;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  int posted = 0;      // merges posted before this step
  int prev_apply = 0;  // the last step's batch

  HYPTOK_MARK(11);
  for (int s = 0; s < p.n_steps; ++s) {
    // The last step's consumption and scalars are done.
    queue_sync();
    if (s_halt) break;
    HYPTOK_MARK(0);
    const int pidx = min(max(s_i[S_PHASE] - 1, 0), 2);
    const float thr = s_f[F_THR];
    const int vocab0 = s_i[S_VOCAB];
    const bool consumed_any = s_i[S_NM] > s_i[S_SYNCED];
    const bool truncated = s_i[S_QV0 + pidx] > k;
    const Queue q = queue_of(p, s_q, n_res, p0, pidx);
    // The step's batch consumes the launch phase and its mirrors at the
    // selected entries themselves.
    const bool direct = unique && s_mirror[pidx] == p0;
    // Free the last batch's slots (its pairs are still in the ring).
    for (int t = tid; t < prev_apply; t += kQueueThreads) {
      const int at = (posted - prev_apply + t) % ring;
      s_owner[pair_slot(r_ci[at], r_cj[at])] = -1;
    }

    // Count the valid entries and note any live one: a ballot a round, so
    // ranks follow queue order (warp, round, lane).
    int w_valid = 0;
    bool w_live = false;
    for (int i0 = 0; i0 < rounds; i0 += 4) {
      float2 ds[4];  // four rounds' loads first; past the end, dead
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = span0 + 32 * (i0 + u) + lane;
        ds[u] = i0 + u < rounds && e < k ? q_dist_score(q, e)
                                         : make_float2(INFINITY, -INFINITY);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool live = ds[u].y > -INFINITY;
        w_valid += __popc(__ballot_sync(kFull, live && ds[u].x < thr));
        w_live |= __any_sync(kFull, live);
      }
    }
    if (lane == 0) {
      s_scan[warp] = w_valid;
      s_live[warp] = w_live;
    }
    queue_sync();
    HYPTOK_MARK(3);
    // Every warp scans the warps' counts itself.
    const int wv = lane < kQueueWarps ? s_scan[lane] : 0;
    int winc = wv;
    for (int o = 1; o < kQueueWarps; o <<= 1) {
      const int v = __shfl_up_sync(kFull, winc, o);
      if (lane >= o) winc += v;
    }
    const int n_valid = __shfl_sync(kFull, winc, kQueueWarps - 1);
    const bool any_live =
        __any_sync(kFull, lane < kQueueWarps && s_live[lane] != 0);
    const int before = __shfl_sync(kFull, winc - wv, warp);
    // A truncated queue that cannot fill a batch, or a fully consumed
    // queue, waits for a sync.
    const bool need_rs = consumed_any &&
                         ((truncated && n_valid < p.nb) || !any_live);
    const int n_taken = min(n_valid, p.nb);
    const int n_apply = need_rs ? 0 : max(0, min(n_taken, p.max_v - vocab0));
    // The threads holding ranks below n_apply post their entries as merges
    // posted + rank (once the merge ring * ring entries earlier is done),
    // and each pair into its slot.
    for (int i = 0, r0 = before; i < rounds && r0 < n_apply; ++i) {
      const int e = span0 + 32 * i + lane;
      bool valid = false;
      if (e < k) {
        const float2 ds = q_dist_score(q, e);
        valid = ds.y > -INFINITY && ds.x < thr;
      }
      const unsigned m = __ballot_sync(kFull, valid);
      const int r = r0 + __popc(m & below);
      if (valid && r < n_apply) {
        const int mi = posted + r;
        if (mi >= ring) {
          const int* done = &s_done[mi % kMergeWarps];
          while (vload(done) <= (mi - ring) / kMergeWarps) __nanosleep(20);
        }
        const int2 pr = q_pair(q, e);
        const int at = mi % ring;
        r_ci[at] = pr.x;
        r_cj[at] = pr.y;
        r_cd[at] = q_dist_score(q, e).x;
        const unsigned slot = pair_slot(pr.x, pr.y);
        if (atomicCAS(&s_owner[slot], -1, r) != -1) s_owner[slot] = -2;
        for (int ph = 0; direct && ph < 3; ++ph) {
          if (s_mirror[ph] == p0) q_consume(queue_of(p, s_q, n_res, p0, ph), e);
        }
      }
      r0 += __popc(m);
    }
    queue_sync();
    HYPTOK_MARK(4);
    if (tid == 0 && n_apply > 0) {
      __threadfence_block();
      *(volatile int*)&s_posted = posted + n_apply;
    }

    if (n_apply > 0) {
      // Consume every applied ordered pair in the phase queues not consumed
      // at posting: an entry is compared with the merge that owns its
      // slot, or with the whole batch where two share it; a mirrored phase
      // takes the hits of the phase it repeats. Four entries a thread at a
      // time, their loads first.
      for (int ph = 0; ph < 3; ++ph) {
        if (s_mirror[ph] != ph || (direct && ph == p0)) continue;
        const Queue v = queue_of(p, s_q, n_res, p0, ph);
        for (int e0 = tid; e0 < k; e0 += 4 * kQueueThreads) {
          int2 pr[4];
          int o[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kQueueThreads;
            pr[u] = e < k ? q_pair(v, e) : make_int2(-1, -1);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            o[u] = s_owner[pair_slot(pr[u].x, pr[u].y)];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kQueueThreads;
            if (o[u] == -1 || e >= k) continue;
            bool hit = false;
            for (int t = o[u] >= 0 ? o[u] : 0;
                 t < (o[u] >= 0 ? o[u] + 1 : n_apply) && !hit; ++t) {
              const int at = (posted + t) % ring;
              hit = pr[u].x == r_ci[at] && pr[u].y == r_cj[at];
            }
            if (!hit) continue;
            for (int m = 0; m < 3; ++m) {
              if (s_mirror[m] == ph) {
                q_consume(queue_of(p, s_q, n_res, p0, m), e);
              }
            }
          }
        }
      }
    }
    HYPTOK_MARK(5);
    if (tid == kQueueThreads - 32) {
      step_scalars(p, s_i, s_f, need_rs, n_apply);
      if (s + 1 < p.n_steps) step_head(p, s_i, s_f, &s_halt);
    }
    posted += n_apply;
    prev_apply = n_apply;
    HYPTOK_MARK(10);
  }
  queue_sync();
  if (tid == 0) *(volatile int*)&s_finished = 1;
  for (int r = 0; r < n_res; ++r) {
    const size_t o = (size_t)((p0 + r) % 3) * k;
    const float2* ds =
        reinterpret_cast<const float2*>(s_q + (size_t)r * 2 * k + k);
    for (int e = tid; e < k; e += kQueueThreads) p.q_score[o + e] = ds[e].y;
  }
  if (tid < S_COUNT) p.si[tid] = s_i[tid];
  if (tid < F_COUNT) p.sf[tid] = s_f[tid];
  HYPTOK_MARK(12);
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

// Allow K2's batch arrays for a queue batch nb in dynamic shared memory.
cudaError_t allow_batch(int nb) {
  return cudaFuncSetAttribute(dense_loop_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              batch_smem_bytes(nb));
}

}  // namespace

extern "C" int enhanced_loop_launch(
    void* emb, void* lengths, void* byte_lengths, void* has_vowel,
    void* token_hash, void* merges, void* merge_dists, void* q_i, void* q_j,
    void* q_dist, void* q_score, void* powers, void* si, void* sf, int max_v,
    int d1, int k, int nb, int n_steps, int max_hash_len, int use_hier,
    int phase2, int phase3, float thr1, float thr2, float thr3, int adaptive,
    int growth_every, float growth, int empty_after, float empty_growth,
    int empty_stop, int n_resident, int ring, void* stream) {
  if (nb < 1 || nb > kMaxBatch || k < 1 || n_resident < 0 ||
      n_resident > 3 || ring < 2 * nb || ring % kMergeWarps != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p = base_params(
      emb, lengths, byte_lengths, has_vowel, token_hash, merges, merge_dists,
      q_i, q_j, q_dist, q_score, powers, si, sf, max_v, d1, k, nb, n_steps,
      max_hash_len, use_hier, phase2, phase3, thr1, thr2, thr3, adaptive,
      growth_every, growth, empty_after, empty_growth, empty_stop);
  // The ring (pairs and distances), padded to 8 bytes, then the resident
  // phases (enhanced_loop.smem_plan).
  const size_t smem = ((size_t)ring * 12 + 7) / 8 * 8 +
                      (size_t)n_resident * 4 * k * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      corpus_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  corpus_loop_kernel<<<1, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p, n_resident,
                                                            ring);
  return (int)cudaGetLastError();
}

// Blocks of K2's cooperative grid on the current device for a queue batch
// nb (the occupancy query times the SM count), after allowing its dynamic
// shared memory; a negative CUDA error code if a call fails.
extern "C" int enhanced_loop_dense_grid(int nb) {
  if (nb < 1 || nb > kMaxBatch) return -(int)cudaErrorInvalidValue;
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) err = allow_batch(nb);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dense_loop_kernel, kThreads, batch_smem_bytes(nb));
  }
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// K2: the arguments of enhanced_loop_launch, then the dense channel's
// buffers (best_dist, best_j, pair table, morph/word tables, coherence
// samples), their sizes, its switches, the pair table's layout (n_buckets
// > 1: that many hash partitions, the v3 sharded sync's; else one
// lexicographically sorted table) and the score weights, then the
// cooperative grid's size (enhanced_loop_dense_grid) and scratch: the
// partials (grid floats, grid ints), block 0's event (E_COUNT ints,
// zeroed), the count of finished events (1, zeroed) and the counts that
// block 0 adds each dense merge and each empty-round threshold growth to
// (2 ints, or null for none).
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
    int use_freq, int use_comp, int max_token_len, int n_buckets,
    float w_alpha, float w_beta, float w_gamma, float w_comp, float w_morph,
    int grid, void* part_v, void* part_i, void* event, void* done,
    void* counts, void* stream) {
  if (nb < 1 || nb > kMaxBatch || table_size < 1 || morph_len < 1 ||
      word_len < 1 || grid < 1 ||
      (n_buckets > 1 && table_size % n_buckets != 0)) {
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
  p.n_buckets = n_buckets;
  p.w_alpha = w_alpha;
  p.w_beta = w_beta;
  p.w_gamma = w_gamma;
  p.w_comp = w_comp;
  p.w_morph = w_morph;
  p.part_v = static_cast<float*>(part_v);
  p.part_i = static_cast<int*>(part_i);
  p.event = static_cast<int*>(event);
  p.done = static_cast<unsigned*>(done);
  p.counts = static_cast<int*>(counts);
  cudaError_t err = allow_batch(nb);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      (const void*)dense_loop_kernel, dim3(grid), dim3(kThreads),
      args, (size_t)batch_smem_bytes(nb), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
