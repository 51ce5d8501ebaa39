// The corpus sync's replay (kernel R2): the passes of match, selection,
// substitution and compaction of one merge window, to the window's
// fixpoint, in one cooperative launch with no host read.
//
// Replaces no pl.pallas_call. The JAX package replays a window with XLA
// ops in `batch_rank_replay` and `batch_fixpoint_replay`
// (hyptokenizer_tpu/tokenizer/scoring.py :569 and :502, the passes' loop
// a `lax.while_loop`). The port ran them as a chain of some 80 PyTorch
// launches and 8-12 host reads a sync (the rule lookup's masked gathers,
// a read a matching round, the compaction's masked gather, the loop
// tests). The plain version is hyptokenizer_tpu_torch/tokenizer/scoring.py
// `_replay` with `_select_matching` (rank) or `_select_leftmost`
// (fixpoint); the wrapper is ops/cuda/replay_pass.py.
//
// What it computes, bit for bit as the plain loop. The window is merges
// [start, end), read from device pointers (or passed by value); merge r
// makes id n_init + r, and a pair matched by several rules takes the
// largest id; a rule with a negative operand matches nothing. With an
// empty window the output is the input as it is. A pass: mid[i] = the id
// of the rule matching (c[i], c[i+1]) when both are tokens (>= 0), else
// -1; the selection (rank: rounds of alive local minima of mid, every
// other entry of each run of them taken, the taken entries' neighbours
// retired, until none is alive; fixpoint: the run-parity take of the
// matches, one round); each taken entry becomes its rule's id and its
// right neighbour PAD; the corpus compacted, PAD to the tail. Passes
// repeat while some rule's operand was made inside the window and the
// last pass applied a merge. PAD (-1) in the input breaks adjacency in
// the first pass; SEP (-2) breaks it always and survives compaction.
//
// Bound. A pass reads and writes each slot once, 8 bytes a slot (23 MB,
// 6.9 us at 3.35 TB/s for the flagship's 2.9M slots; 17 MB, 5.0 us for
// the Quick start's 2.1M). Each matching round is one dependent step
// across the whole corpus, and whether another round or pass follows is
// data-dependent: latency, not bytes, bounds a window of a few merges.
//
// Design. One block of 1,024 threads on each SM of a cooperative grid
// (the occupancy query times the SM count); block b owns the input slots
// [b*S, (b+1)*S) and holds their live entries, compacted in order, with
// the pass's rule ids and its per-entry bits, in dynamic shared memory
// when 8.625 bytes a slot fit, else in a global buffer through the same
// pointer (the wrapper's plan decides from the shapes). The corpus never
// leaves the blocks between passes: a block compacts its own entries,
// and its first entry's left neighbour is the last entry of the nearest
// non-empty block before it (PAD slots between them only ever break a
// pair that the first pass's gap bits already break). Entries are held
// in words of 32: the alive, taken and selected bits of an entry are bit
// i % 32 of word i / 32, made by ballots. The run-parity take is a one-bit
// map per chunk of 32 (the take of its last entry from the take before
// its first: a constant when the chunk has a non-candidate, else the
// identity), an in-block scan of those, and one map per block posted to
// global memory; after a grid barrier each block composes the maps of
// the blocks before it (a warp walks back to the first constant one) for
// its carry. Each barrier interval, thread 0 posts the block's record
// (length, first token, edge priorities, map, first candidate, alive
// and selection flags) to one of two buffers by parity, so a record is
// read only in the interval after it was written. The rule table is an
// open-addressed hash of the window (4 slots a rule or more, a power of
// two): up to kLocalTable slots each block builds its own in shared
// memory while it loads its slice (the Quick start's windows of a few
// rules); a larger one the grid clears and fills in global memory before
// the first pass, read through L2. A block stages its slice in the rule
// id array with independent loads before compacting it. The last pass
// writes each block's entries at its offset among the blocks' lengths
// and PAD after them. Block 0 writes the passes and matching rounds to
// `stats`.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using hyptok::kFull;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = -1;
constexpr int kBig = 0x7fffffff;
constexpr unsigned long long kEmptyKey = ~0ull;
// Rule tables of up to this many slots (windows of up to 128 rules) are
// built by each block in its own shared memory.
constexpr int kLocalTable = 512;

// One-bit maps, as in replay_select.cu: bit x of f is f(x).
constexpr unsigned kConst0 = 0u;
constexpr unsigned kNegate = 1u;
constexpr unsigned kIdentity = 2u;
constexpr unsigned kConst1 = 3u;
// A chunk's carry in a scan: 0 or 1, or kThrough (the carry into the
// block passes through).
constexpr int kThrough = 2;

__device__ __forceinline__ unsigned apply(unsigned f, unsigned x) {
  return (f >> x) & 1u;
}

// g after f.
__device__ __forceinline__ unsigned compose(unsigned g, unsigned f) {
  return apply(g, f & 1u) | (apply(g, f >> 1) << 1);
}

__device__ __forceinline__ bool constant(unsigned f) {
  return f == kConst0 || f == kConst1;
}

// A block's record, posted before each grid barrier.
enum : int {
  kLen,        // live entries
  kFirst,      // its first entry (PAD when empty)
  kPFirst,     // priority of its first entry (alive ? rule id : kBig)
  kPLast,      // and of its last
  kMap,        // the take's map over the block
  kCandFirst,  // whether its first entry is a candidate this round
  kAlive,      // whether any entry is alive
  kSelLast,    // whether its last entry is selected
  kAnySel,     // whether any entry is selected
  kChain,      // whether a rule it read has an operand made in the window
  kRecord = 16
};

struct Params {
  const int* corpus;
  int* out;
  int n;
  const int* merges;     // (merge_rows, 2)
  int merge_rows;
  const int* start_ptr;  // null: `start` and `end` by value
  const int* end_ptr;
  int start;
  int end;
  int n_init;
  int slice;             // input slots a block, a multiple of 32
  int* work;             // null: block state in dynamic shared memory
  unsigned long long* keys;  // rule table, cap_max slots
  int* vals;
  int cap_max;           // a power of two
  int* posts;            // 2 * grid * kRecord
  unsigned* arrived;     // grid barrier word
  int* stats;            // passes, matching rounds
};

// Words of a block's state: tokens and rule ids (a slot each), then the
// alive, selected, taken, gap and scan words (a word each 32 slots).
__host__ __device__ __forceinline__ int state_words(int slice) {
  return 2 * slice + 5 * (slice >> 5);
}

__device__ __forceinline__ unsigned hash_pair(int a, int b) {
  unsigned h = (unsigned)a * 0x9e3779b1u ^ ((unsigned)b * 0x85ebca77u +
                                            0x165667b1u);
  h ^= h >> 15;
  h *= 0x2c1b3c6du;
  h ^= h >> 12;
  h *= 0x297a2d39u;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ unsigned long long pair_key(int a, int b) {
  return ((unsigned long long)(unsigned)a << 32) | (unsigned)b;
}

// A rule table of `cap` slots (a power of two) in shared or global memory.
struct Table {
  unsigned long long* keys;
  int* vals;
  int cap;
  bool l2;   // in global memory, written by other blocks: read through L2
};

__device__ void insert_rule(const Table& t, int a, int b, int id) {
  const unsigned long long key = pair_key(a, b);
  unsigned s = hash_pair(a, b) & (unsigned)(t.cap - 1);
  while (true) {
    const unsigned long long was = atomicCAS(t.keys + s, kEmptyKey, key);
    if (was == kEmptyKey || was == key) {
      atomicMax(t.vals + s, id);
      return;
    }
    s = (s + 1u) & (unsigned)(t.cap - 1);
  }
}

// The rule id of pair (a, b), or -1. The table always has an empty slot.
__device__ int lookup_rule(const Table& t, int a, int b) {
  const unsigned long long key = pair_key(a, b);
  unsigned s = hash_pair(a, b) & (unsigned)(t.cap - 1);
  while (true) {
    const unsigned long long k = t.l2 ? __ldcg(t.keys + s) : t.keys[s];
    if (k == key) return t.l2 ? __ldcg(t.vals + s) : t.vals[s];
    if (k == kEmptyKey) return -1;
    s = (s + 1u) & (unsigned)(t.cap - 1);
  }
}

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// The carry after two chunks, earlier then later.
struct Carry {
  __device__ int operator()(int a, int b) const {
    return b == kThrough ? a : b;
  }
};

// Exclusive scan of a[0, n) in place under `op` (associative, earlier
// argument first) with identity `id`; returns the whole reduction. Every
// thread of the block calls it; it ends synchronised.
template <typename Op>
__device__ int block_scan(int* a, int n, int id, Op op) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * per, n);
  const int hi = min(lo + per, n);
  int agg = id;
  for (int k = lo; k < hi; ++k) agg = op(agg, a[k]);
  int inc = agg;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int other = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = op(other, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int other = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = op(other, w);
    }
    s_warp[lane] = w;
    if (lane == 31) s_total = w;
  }
  __syncthreads();
  int run = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) run = id;
  if (warp > 0) run = op(s_warp[warp - 1], run);
  for (int k = lo; k < hi; ++k) {
    const int v = a[k];
    a[k] = run;
    run = op(run, v);
  }
  const int total = s_total;
  __syncthreads();
  return total;
}

// The take of the last entry of a full chunk of candidate bits `cw`, or
// kThrough when every entry is a candidate (32 of them: the carry in).
__device__ __forceinline__ int chunk_carry(unsigned cw) {
  if (cw == kFull) return kThrough;
  if (!(cw >> 31)) return 0;
  const int z = 31 - __clz(~cw);   // the last non-candidate
  return ((30 - z) & 1) == 0 ? 1 : 0;
}

// The take word of a chunk of candidate bits `cw` after a take of `x`
// before its first entry; every lane of the warp calls it.
__device__ __forceinline__ unsigned take_word(unsigned cw, unsigned x,
                                              int lane) {
  const unsigned below = ~cw & ((1u << lane) - 1u);
  const bool even = below == 0u
                        ? (unsigned)(lane & 1) == x
                        : ((lane - (32 - __clz(below))) & 1) == 0;
  return __ballot_sync(kFull, ((cw >> lane) & 1u) && even);
}

// The take's map over a block of `len` entries: candidate words `cand`,
// chunk carries `cin` (after the in-block scan).
__device__ unsigned block_map(int len, const unsigned* cand, const int* cin) {
  if (len == 0) return kIdentity;
  const int jl = (len - 1) >> 5;
  const int r = (len - 1) & 31;
  const unsigned mask = r == 31 ? kFull : ((1u << (r + 1)) - 1u);
  const unsigned bits = cand[jl] & mask;
  if (bits != mask) {
    if (!((bits >> r) & 1u)) return kConst0;
    const int z = 31 - __clz(~bits & mask);
    return ((r - z - 1) & 1) == 0 ? kConst1 : kConst0;
  }
  const int x = cin[jl];
  if (x != kThrough) return (r & 1) == x ? kConst1 : kConst0;
  return (r & 1) ? kIdentity : kNegate;
}

template <bool kRank>
__global__ void __launch_bounds__(kThreads, 1) replay_kernel(Params p) {
  extern __shared__ int s_dyn[];
  __shared__ unsigned long long s_keys[kLocalTable];
  __shared__ int s_vals[kLocalTable];
  __shared__ int s_rec[kRecord];
  __shared__ int s_val[8];
  __shared__ int s_after;   // the input slot after the slice
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int g = gridDim.x;
  const int S = p.slice;
  const int W = S >> 5;
  const int lo = (int)min((long long)b * S, (long long)p.n);
  const int hi = min(lo + S, p.n);
  const int start = p.start_ptr != nullptr ? *p.start_ptr : p.start;
  const int end = p.end_ptr != nullptr ? *p.end_ptr : p.end;
  const long long count = (long long)end - start;

  if (count <= 0) {
    for (int q = lo + tid; q < hi; q += kThreads) p.out[q] = p.corpus[q];
    if (b == 0 && tid == 0) {
      p.stats[0] = 0;
      p.stats[1] = 0;
    }
    return;
  }

  int* const base = p.work != nullptr ? p.work + (size_t)b * state_words(S)
                                      : s_dyn;
  int* const c = base;
  int* const mid = base + S;
  unsigned* const alive = reinterpret_cast<unsigned*>(base + 2 * S);
  unsigned* const sel = alive + W;
  unsigned* const tw = sel + W;     // candidate words, then take words
  unsigned* const gap = tw + W;     // first pass: slot after is PAD
  int* const aux = reinterpret_cast<int*>(gap + W);

  int cap = 32;
  while (cap < p.cap_max && (long long)cap < 4 * count) cap <<= 1;
  const bool local = cap <= kLocalTable;
  const Table table = local ? Table{s_keys, s_vals, cap, false}
                            : Table{p.keys, p.vals, cap, true};
  const int r0 = max(start, 0);
  const int r1 = (int)min((long long)end, (long long)p.merge_rows);
  const int gt = b * kThreads + tid;
  const int stride = g * kThreads;

  int wbuf = 0;
  int rbuf = 1;
  auto post_wait = [&]() {
    __syncthreads();
    if (tid == 0) {
      int* dst = p.posts + ((size_t)wbuf * g + b) * kRecord;
      for (int f = 0; f < kRecord; ++f) dst[f] = s_rec[f];
    }
    hyptok::grid_barrier(p.arrived, (unsigned)g);
    rbuf = wbuf;
    wbuf ^= 1;
  };
  auto peek = [&](int k, int f) {
    return __ldcg(p.posts + ((size_t)rbuf * g + k) * kRecord + f);
  };
  // Warp 0 only: whether any block's field f is set; the sum of field f
  // over blocks [0, upto).
  auto grid_any = [&](int f) {
    int v = 0;
    for (int k = lane; k < g; k += 32) v |= peek(k, f);
    return __any_sync(kFull, v != 0) ? 1 : 0;
  };
  auto grid_sum = [&](int f, int upto) {
    int v = 0;
    for (int k = lane; k < upto; k += 32) v += peek(k, f);
    return hyptok::warp_sum_int(v);
  };
  // Warp 0 only: the nearest non-empty blocks before and after this one
  // (-1: none) into s_val[0], s_val[1], and the first entry of the one
  // after (PAD: none) into s_val[2].
  auto neighbours = [&]() {
    int after = -1;
    for (int k0 = b + 1; k0 < g; k0 += 32) {
      const int k = k0 + lane;
      const unsigned m = __ballot_sync(kFull, k < g && peek(k, kLen) > 0);
      if (m != 0u) {
        after = k0 + __ffs(m) - 1;
        break;
      }
    }
    int before = -1;
    for (int k0 = b - 1; k0 >= 0; k0 -= 32) {
      const int k = k0 - lane;
      const unsigned m = __ballot_sync(kFull, k >= 0 && peek(k, kLen) > 0);
      if (m != 0u) {
        before = k0 - (__ffs(m) - 1);
        break;
      }
    }
    if (lane == 0) {
      s_val[0] = before;
      s_val[1] = after;
      s_val[2] = after >= 0 ? peek(after, kFirst) : kPad;
    }
  };
  // Warp 0 only: the take of the entry before this block's first.
  auto carry_in = [&]() {
    unsigned acc = kIdentity;
    for (int k0 = b - 1;; k0 -= 32) {
      const int k = k0 - lane;
      const unsigned m = k >= 0 ? (unsigned)peek(k, kMap) : kConst0;
      const unsigned cm = __ballot_sync(kFull, constant(m));
      const int upto = cm != 0u ? __ffs(cm) - 1 : 31;
      for (int q = 0; q <= upto; ++q) {
        acc = compose(acc, __shfl_sync(kFull, m, q));
      }
      if (cm != 0u) return apply(acc, 0u);
    }
  };

  // Set-up: clear the rule table (a small one each block fills itself
  // now, a large one the grid fills after the first barrier), read the
  // window's chain flag, stage the slice in mid and compact its live
  // entries into c, with the first pass's gap bits.
  if (local) {
    for (int s = tid; s < cap; s += kThreads) {
      s_keys[s] = kEmptyKey;
      s_vals[s] = -1;
    }
  } else {
    for (int s = gt; s < cap; s += stride) {
      p.keys[s] = kEmptyKey;
      p.vals[s] = -1;
    }
  }
  int chain = 0;
  for (int r = r0 + gt; r < r1; r += stride) {
    chain |= max(p.merges[2 * r], p.merges[2 * r + 1]) >= p.n_init + start;
  }
  const int span = max(hi - lo, 0);
  for (int q = tid; q < span; q += kThreads) mid[q] = p.corpus[lo + q];
  for (int j = tid; j < W; j += kThreads) gap[j] = 0u;
  if (tid == 0) s_after = hi < p.n ? p.corpus[hi] : kPad;
  __syncthreads();
  if (local) {
    for (int r = r0 + tid; r < r1; r += kThreads) {
      const int x = p.merges[2 * r];
      const int y = p.merges[2 * r + 1];
      if (x >= 0 && y >= 0) insert_rule(table, x, y, p.n_init + r);
    }
  }
  const int cp = (span + 31) >> 5;
  for (int j = warp; j < cp; j += kWarps) {
    const int q = 32 * j + lane;
    const unsigned live = __ballot_sync(kFull, q < span && mid[q] != kPad);
    if (lane == 0) aux[j] = __popc(live);
  }
  __syncthreads();
  int len = block_scan(aux, cp, 0, Sum());
  for (int j = warp; j < cp; j += kWarps) {
    const int q = 32 * j + lane;
    const int x = q < span ? mid[q] : kPad;
    const unsigned live = __ballot_sync(kFull, x != kPad);
    if (x != kPad) {
      const int right = q + 1 < span ? mid[q + 1] : s_after;
      const int d = aux[j] + __popc(live & ((1u << lane) - 1u));
      c[d] = x;
      if (right == kPad) atomicOr(gap + (d >> 5), 1u << (d & 31));
    }
  }
  chain = __syncthreads_or(chain);
  if (tid == 0) {
    for (int f = 0; f < kRecord; ++f) s_rec[f] = 0;
    s_rec[kLen] = len;
    s_rec[kFirst] = len > 0 ? c[0] : kPad;
    s_rec[kPFirst] = kBig;
    s_rec[kPLast] = kBig;
    s_rec[kMap] = (int)kIdentity;
    s_rec[kChain] = chain;
  }
  post_wait();

  if (!local) {
    for (int r = r0 + gt; r < r1; r += stride) {
      const int x = p.merges[2 * r];
      const int y = p.merges[2 * r + 1];
      if (x >= 0 && y >= 0) insert_rule(table, x, y, p.n_init + r);
    }
  }
  if (warp == 0) {
    neighbours();
    const int any_chain = grid_any(kChain);
    if (lane == 0) s_val[3] = any_chain;
  }
  __syncthreads();
  int before = s_val[0];
  int after = s_val[1];
  int right_c = s_val[2];
  const bool can_chain = s_val[3] != 0;
  if (!local) post_wait();   // the grid's rule table is whole

  int passes = 0;
  int rounds = 0;
  while (true) {
    ++passes;
    const int C = (len + 31) >> 5;
    const int jl = (len - 1) >> 5;   // the last entry's word and bit
    const int rl = (len - 1) & 31;

    // The pass's rule ids and matches.
    bool any = false;
    for (int j = warp; j < C; j += kWarps) {
      const int i = 32 * j + lane;
      const bool in = i < len;
      const int x = in ? c[i] : kPad;
      int nx = __shfl_down_sync(kFull, x, 1);
      if (i + 1 >= len) {
        nx = right_c;
      } else if (lane == 31) {
        nx = c[i + 1];
      }
      const bool broken = passes == 1 && ((gap[j] >> lane) & 1u);
      int m = -1;
      if (in && x >= 0 && nx >= 0 && !broken) m = lookup_rule(table, x, nx);
      if (in) mid[i] = m;
      const unsigned a = __ballot_sync(kFull, m >= 0);
      if (lane == 0) {
        alive[j] = a;
        sel[j] = 0u;
      }
      any |= a != 0u;
    }
    int any_b = __syncthreads_or(any);

    // The take of the candidates in tw: chunk carries, the block's map,
    // the carry in from the blocks before, the take words; returns the
    // carry in. Posts the block's record.
    auto take = [&]() -> unsigned {
      for (int j = tid; j < C; j += kThreads) aux[j] = chunk_carry(tw[j]);
      __syncthreads();
      block_scan(aux, C, kThrough, Carry());
      if (tid == 0) {
        s_rec[kMap] = (int)block_map(len, tw, aux);
        s_rec[kCandFirst] = len > 0 ? (int)(tw[0] & 1u) : 0;
      }
      post_wait();
      if (warp == 0) {
        const unsigned cin = carry_in();
        if (lane == 0) {
          s_val[4] = (int)cin;
          s_val[5] = after >= 0 ? peek(after, kCandFirst) : 0;
        }
      }
      __syncthreads();
      const unsigned cin = (unsigned)s_val[4];
      for (int j = warp; j < C; j += kWarps) {
        const unsigned cw = tw[j];
        const int x = aux[j];
        const unsigned t =
            take_word(cw, x == kThrough ? cin : (unsigned)x, lane);
        if (lane == 0) tw[j] = t;
      }
      __syncthreads();
      return cin;
    };

    int removed_first = 0;
    int any_applied = 0;
    if (kRank) {
      auto edges = [&]() {   // thread 0
        s_rec[kPFirst] = len > 0 && (alive[0] & 1u) ? mid[0] : kBig;
        s_rec[kPLast] =
            len > 0 && ((alive[jl] >> rl) & 1u) ? mid[len - 1] : kBig;
        s_rec[kSelLast] = len > 0 ? (int)((sel[jl] >> rl) & 1u) : 0;
      };
      if (tid == 0) {
        edges();
        s_rec[kAlive] = any_b;
        s_rec[kAnySel] = 0;
      }
      post_wait();
      while (true) {
        if (warp == 0) {
          const int live = grid_any(kAlive);
          const int applied = grid_any(kAnySel);
          if (lane == 0) {
            s_val[4] = live;
            s_val[5] = applied;
            s_val[6] = before >= 0 ? peek(before, kPLast) : kBig;
            s_val[7] = after >= 0 ? peek(after, kPFirst) : kBig;
            s_val[3] = before >= 0 ? peek(before, kSelLast) : 0;
          }
        }
        __syncthreads();
        const bool live = s_val[4] != 0;
        any_applied = s_val[5];
        removed_first = s_val[3];
        const int p_before = s_val[6];
        const int p_after = s_val[7];
        __syncthreads();
        if (!live) break;
        ++rounds;

        // Candidates: alive local minima of the priorities.
        for (int j = warp; j < C; j += kWarps) {
          const int i = 32 * j + lane;
          const bool a = (alive[j] >> lane) & 1u;
          const int pv = a ? mid[i] : kBig;
          int pl = __shfl_up_sync(kFull, pv, 1);
          int pr = __shfl_down_sync(kFull, pv, 1);
          if (lane == 0) {
            pl = j == 0 ? p_before
                        : ((alive[j - 1] >> 31) & 1u) ? mid[i - 1] : kBig;
          }
          if (i == len - 1) {
            pr = p_after;
          } else if (lane == 31 && i + 1 < len) {
            pr = (alive[j + 1] & 1u) ? mid[i + 1] : kBig;
          }
          const unsigned cw = __ballot_sync(kFull, a && pv <= pl && pv <= pr);
          if (lane == 0) tw[j] = cw;
        }
        __syncthreads();
        const unsigned cin = take();
        const unsigned next_cand = (unsigned)s_val[5];
        const unsigned take_last = len > 0 ? (tw[jl] >> rl) & 1u : 0u;
        const unsigned next_take = next_cand & (take_last ^ 1u);

        // The taken join sel; they and their neighbours leave alive.
        bool still = false;
        bool took = false;
        for (int j = tid; j < C; j += kThreads) {
          const unsigned t = tw[j];
          const unsigned left = j == 0 ? cin : tw[j - 1] >> 31;
          const unsigned right = j + 1 < C ? tw[j + 1] & 1u : 0u;
          unsigned near = t | (t << 1) | left | (t >> 1) | (right << 31);
          if (j == jl) near |= next_take << rl;
          const unsigned al = alive[j] & ~near;
          alive[j] = al;
          sel[j] |= t;
          still |= al != 0u;
          took |= t != 0u;
        }
        const int still_b = __syncthreads_or(still);
        const int took_b = __syncthreads_or(took);
        if (tid == 0) {
          edges();
          s_rec[kAlive] = still_b;
          s_rec[kAnySel] |= took_b;
        }
        post_wait();
      }
    } else {
      ++rounds;
      for (int j = tid; j < C; j += kThreads) tw[j] = alive[j];
      __syncthreads();
      take();
      bool took = false;
      for (int j = tid; j < C; j += kThreads) {
        sel[j] = tw[j];
        took |= tw[j] != 0u;
      }
      const int took_b = __syncthreads_or(took);
      if (tid == 0) {
        s_rec[kSelLast] = len > 0 ? (int)((sel[jl] >> rl) & 1u) : 0;
        s_rec[kAnySel] = took_b;
      }
      post_wait();
      if (warp == 0) {
        const int applied = grid_any(kAnySel);
        if (lane == 0) {
          s_val[5] = applied;
          s_val[3] = before >= 0 ? peek(before, kSelLast) : 0;
        }
      }
      __syncthreads();
      any_applied = s_val[5];
      removed_first = s_val[3];
    }
    const bool last = !can_chain || any_applied == 0;

    // Substitution: a taken entry becomes its rule's id (in mid), every
    // other keeps its token; the right neighbour of a taken entry goes.
    for (int j = warp; j < C; j += kWarps) {
      const int i = 32 * j + lane;
      const unsigned s = sel[j];
      if (i < len && !((s >> lane) & 1u)) mid[i] = c[i];
      if (lane == 0) {
        const unsigned gone =
            (s << 1) | (j == 0 ? (unsigned)removed_first : sel[j - 1] >> 31);
        const int in = len - 32 * j;
        const unsigned valid = in >= 32 ? kFull : ((1u << in) - 1u);
        const unsigned keep = valid & ~gone;
        tw[j] = keep;
        aux[j] = __popc(keep);
      }
    }
    __syncthreads();
    const int kept = block_scan(aux, C, 0, Sum());
    for (int j = tid; j < C; j += kThreads) {
      if (aux[j] == 0 && tw[j] != 0u) {
        s_rec[kFirst] = mid[32 * j + __ffs(tw[j]) - 1];
      }
    }
    if (tid == 0) {
      if (kept == 0) s_rec[kFirst] = kPad;
      s_rec[kLen] = kept;
    }
    post_wait();

    if (last) {
      if (warp == 0) {
        const int off = grid_sum(kLen, b);
        const int total = grid_sum(kLen, g);
        if (lane == 0) {
          s_val[4] = off;
          s_val[5] = total;
        }
      }
      __syncthreads();
      const int off = s_val[4];
      const int total = s_val[5];
      for (int j = warp; j < C; j += kWarps) {
        const unsigned keep = tw[j];
        if ((keep >> lane) & 1u) {
          p.out[off + aux[j] + __popc(keep & ((1u << lane) - 1u))] =
              mid[32 * j + lane];
        }
      }
      for (int q = max(lo, total) + tid; q < hi; q += kThreads) {
        p.out[q] = kPad;
      }
      if (b == 0 && tid == 0) {
        p.stats[0] = passes;
        p.stats[1] = rounds;
      }
      return;
    }

    // Compaction into c for the next pass.
    for (int j = warp; j < C; j += kWarps) {
      const unsigned keep = tw[j];
      if ((keep >> lane) & 1u) {
        c[aux[j] + __popc(keep & ((1u << lane) - 1u))] = mid[32 * j + lane];
      }
    }
    len = kept;
    if (warp == 0) neighbours();
    __syncthreads();
    before = s_val[0];
    after = s_val[1];
    right_c = s_val[2];
    __syncthreads();
  }
}

int g_smem_set[2] = {-1, -1};

template <bool kRank>
cudaError_t allow_smem(int smem) {
  int& set = g_smem_set[kRank ? 1 : 0];
  if (set == smem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      replay_kernel<kRank>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

}  // namespace

extern "C" int replay_pass_threads() { return kThreads; }

extern "C" int replay_pass_state_words(int slice) {
  return state_words(slice);
}

extern "C" int replay_pass_sm_count() {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return 0;
  }
  return sms;
}

// The dynamic shared memory a block may take: the device's opt-in limit
// less the kernels' static shared memory (negative: a CUDA error).
extern "C" int replay_pass_smem_limit() {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  cudaFuncAttributes a0, a1;
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&a0, replay_kernel<false>);
  }
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&a1, replay_kernel<true>);
  }
  if (err != cudaSuccess) return -(int)err;
  const size_t fixed = a0.sharedSizeBytes > a1.sharedSizeBytes
                           ? a0.sharedSizeBytes
                           : a1.sharedSizeBytes;
  return optin - (int)fixed;
}

// Blocks of `smem` dynamic shared memory an SM holds, the fewer of the two
// kernels (the cooperative grid needs at least one); negative: a CUDA
// error.
extern "C" int replay_pass_blocks_per_sm(int smem) {
  cudaError_t err = allow_smem<false>(smem);
  if (err == cudaSuccess) err = allow_smem<true>(smem);
  int k0 = 0;
  int k1 = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &k0, replay_kernel<false>, kThreads, (size_t)smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &k1, replay_kernel<true>, kThreads, (size_t)smem);
  }
  if (err != cudaSuccess) return -(int)err;
  return k0 < k1 ? k0 : k1;
}

// out = corpus with merges [start, end) replayed (rank: the matching
// rounds; else the fixpoint take). `start_ptr`/`end_ptr`: one int32 each
// on the device, or null for `start`/`end`. `work`: null when the blocks'
// state fits `smem` bytes of shared memory, else blocks * state_words
// ints. `keys`/`vals`: cap_max slots; `posts`: 2 * blocks * 16 ints;
// `arrived`: one word, zero before the first launch and left as it was
// found; `stats`: 2 ints.
extern "C" int replay_pass_launch(
    const void* corpus, void* out, int n, const void* merges, int merge_rows,
    const void* start_ptr, const void* end_ptr, int start, int end,
    int n_init, int rank, int blocks, int slice, void* work, int smem,
    void* keys, void* vals, int cap_max, void* posts, void* arrived,
    void* stats, void* stream) {
  if (n < 0 || blocks < 1 || slice < 32 || (slice & 31) != 0 ||
      (long long)blocks * slice < n || cap_max < 32 ||
      (cap_max & (cap_max - 1)) != 0 ||
      (work == nullptr && smem < 4 * state_words(slice))) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.corpus = static_cast<const int*>(corpus);
  p.out = static_cast<int*>(out);
  p.n = n;
  p.merges = static_cast<const int*>(merges);
  p.merge_rows = merge_rows;
  p.start_ptr = static_cast<const int*>(start_ptr);
  p.end_ptr = static_cast<const int*>(end_ptr);
  p.start = start;
  p.end = end;
  p.n_init = n_init;
  p.slice = slice;
  p.work = static_cast<int*>(work);
  p.keys = static_cast<unsigned long long*>(keys);
  p.vals = static_cast<int*>(vals);
  p.cap_max = cap_max;
  p.posts = static_cast<int*>(posts);
  p.arrived = static_cast<unsigned*>(arrived);
  p.stats = static_cast<int*>(stats);
  void* args[] = {&p};
  const void* fn = rank ? (const void*)replay_kernel<true>
                        : (const void*)replay_kernel<false>;
  cudaError_t err = rank ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                    (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
