// The corpus replay's selection, one launch each: the run-parity take of a
// mask, and one round of the priority matching.
//
// Replaces no pl.pallas_call. The JAX package computes the take with XLA's
// two-level scan `blocked_cummax` (hyptokenizer_tpu/tokenizer/scoring.py
// :141) over the run heads' positions, in `batch_rank_replay`'s matching
// rounds (:569, rounds at :523) and in the fixpoint replay (:502). The port
// took it as `torch.cummax` over the whole corpus, which on a 1-D tensor
// scans in a single thread block: one SM walked 2.9M entries, about 7.5 ms
// a call on an H100. The plain versions are
// hyptokenizer_tpu_torch/tokenizer/scoring.py `parity_take_plain` and
// `matching_round_plain`; the wrapper is ops/cuda/replay_select.py.
//
// What it computes. The take is a carry chain on one bit: entry i is taken
// when cand[i] and not take[i-1] (take[-1] = 0), which is every other
// entry of each run of cand from the run's head. `take_kernel` takes
// cand = mask. `round_kernel` does one whole round of the matching:
// p = alive ? pri : 2^31-1; cand = alive local minima of p (p[i] <= both
// neighbours, 2^31-1 past either end); take as above; sel |= take;
// alive_out = alive & ~(take[i-1] | take[i] | take[i+1]); and a flag,
// whether any entry stays alive, for the host's loop test.
//
// Bound. Each entry read once and written once: the take reads the mask
// and writes the take, 2 bytes an entry (5.8 MB, 1.7 us at 3.35 TB/s for
// the flagship's 2.9M slots); the round reads alive (1 byte), pri (4) and
// sel (1) and writes sel and alive_out (1 each), 8 bytes an entry (23 MB,
// 6.9 us).
//
// Design. A block takes a tile of kTile = 4096 entries, 16 a thread, the
// mask in one 16-byte load and the priorities in four. The round reads a
// one-entry halo left of the tile and two right of it (the right
// neighbour's candidacy, so that take[i+1] = cand[i+1] & !take[i] is
// known locally); alive_out is another buffer than alive, so no block
// reads what another wrote. A thread folds its 16 bits into a map of one
// bit to one bit (the take of its last entry for a carry-in of 0 and of
// 1). Such maps compose associatively: a warp scans them with shuffles,
// thread 0 the block's 8 warps. Tiles chain by decoupled look-back: tile
// ids come from an atomic counter in the order blocks start, so every
// tile a block waits on belongs to a block already running. A tile posts
// its map at once, or its last take when the map is constant (any entry
// not a candidate makes it so, hence in a corpus nearly every tile), then
// walks back over its predecessors' words to the first that holds a take,
// and posts its own take. Each thread then replays its 16 entries from
// its carry and writes 16 bytes. The scratch (tile counter, count of
// finished blocks, the any-alive word, a status word a tile) is zero
// between launches: the last block to finish copies the flag out and
// zeroes it again, so a launch needs no memset before it. Launches that
// share a scratch must be ordered, as on one stream (the wrapper keeps a
// scratch per device and stream).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using hyptok::kFull;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                 // entries a thread: 16 bytes of mask
constexpr int kTile = kThreads * kPer;   // entries a block
constexpr int kBig = 0x7fffffff;

// Scratch words; the status words of the tiles start at kStatus.
constexpr int kNextTile = 0;
constexpr int kDone = 1;
constexpr int kAnyAlive = 2;
constexpr int kStatus = 4;

// A status word: 0 while the tile is running; kMap | map << 2 once its map
// is known; kTake | take << 2 once the take of its last entry is.
constexpr unsigned kMap = 1u;
constexpr unsigned kTake = 2u;

// A map f of one bit to one bit as two bits: bit x of f is f(x).
constexpr unsigned kIdentity = 2u;

__device__ __forceinline__ unsigned apply(unsigned f, unsigned x) {
  return (f >> x) & 1u;
}

// g after f.
__device__ __forceinline__ unsigned compose(unsigned g, unsigned f) {
  return apply(g, f & 1u) | (apply(g, f >> 1) << 1);
}

__device__ __forceinline__ bool constant(unsigned f) {
  return f == 0u || f == 3u;
}

// Bit k: whether byte j0 + k of p is nonzero (0 past n).
__device__ __forceinline__ unsigned load_bits(const unsigned char* p, int j0,
                                              int n) {
  unsigned bits = 0;
  if (j0 + kPer <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + j0);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      bits |= (((w[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0u) << k;
    }
  } else {
    for (int k = 0; k < kPer && j0 + k < n; ++k) {
      bits |= (p[j0 + k] != 0) << k;
    }
  }
  return bits;
}

// Bytes j0 .. j0 + 15 of p (those below n) from bits 0 .. 15.
__device__ __forceinline__ void store_bits(unsigned char* p, int j0, int n,
                                           unsigned bits) {
  if (j0 + kPer <= n) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      w[k >> 2] |= ((bits >> k) & 1u) << (8 * (k & 3));
    }
    *reinterpret_cast<uint4*>(p + j0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int k = 0; k < kPer && j0 + k < n; ++k) {
      p[j0 + k] = (unsigned char)((bits >> k) & 1u);
    }
  }
}

// The map of a run of 16 candidate bits: the take of the last entry for a
// take of 0 and of 1 before the first.
__device__ __forceinline__ unsigned fold(unsigned cand) {
  unsigned t0 = 0u, t1 = 1u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const unsigned c = (cand >> k) & 1u;
    t0 = c & (t0 ^ 1u);
    t1 = c & (t1 ^ 1u);
  }
  return t0 | (t1 << 1);
}

__device__ __forceinline__ int priority(const unsigned char* alive,
                                        const int* pri, int i, int n) {
  return (i >= 0 && i < n && alive[i] != 0) ? pri[i] : kBig;
}

// The take of the entry before this thread's first, for every thread of
// the tile: scans the threads' maps, chains the tile to its predecessors
// and posts its own word. Ends with the block synchronised.
__device__ unsigned carry_in(unsigned map, unsigned* scratch, int tile) {
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_warp_prefix[kWarps];
  __shared__ unsigned s_carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  unsigned inc = map;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned other = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = compose(inc, other);
  }
  unsigned excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = kIdentity;
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();

  if (threadIdx.x == 0) {
    unsigned acc = kIdentity;
    for (int w = 0; w < kWarps; ++w) {
      s_warp_prefix[w] = acc;
      acc = compose(s_warp[w], acc);
    }
    volatile unsigned* status = scratch + kStatus;
    unsigned carry = 0u;
    if (tile == 0 || constant(acc)) {
      status[tile] = kTake | (apply(acc, 0u) << 2);
    } else {
      status[tile] = kMap | (acc << 2);
    }
    if (tile > 0) {
      unsigned back = kIdentity;   // the maps walked over, composed
      for (int j = tile - 1;; --j) {
        unsigned word;
        do {
          word = status[j];
        } while (word == 0u);
        if ((word & 3u) == kTake) {
          carry = apply(back, word >> 2);
          break;
        }
        back = compose(back, word >> 2);
      }
      if (!constant(acc)) status[tile] = kTake | (apply(acc, carry) << 2);
    }
    s_carry = carry;
  }
  __syncthreads();
  return apply(excl, apply(s_warp_prefix[warp], s_carry));
}

// The last block to finish copies the any-alive word to `flag` (if given)
// and returns the scratch to zero.
__device__ void finish(unsigned* scratch, int n_tiles, int* flag) {
  __shared__ bool s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(scratch + kDone, 1u) == (unsigned)(n_tiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < n_tiles; i += kThreads) {
    scratch[kStatus + i] = 0u;
  }
  if (threadIdx.x == 0) {
    const unsigned any = atomicExch(scratch + kAnyAlive, 0u);
    if (flag != nullptr) *flag = (int)any;
    scratch[kNextTile] = 0u;
    scratch[kDone] = 0u;
  }
}

__device__ __forceinline__ int next_tile(unsigned* scratch) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(scratch + kNextTile, 1u);
  __syncthreads();
  return s_tile;
}

__device__ __forceinline__ unsigned replay(unsigned cand, unsigned carry) {
  unsigned take = 0u, prev = carry;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    prev = ((cand >> k) & 1u) & (prev ^ 1u);
    take |= prev << k;
  }
  return take;
}

__global__ void __launch_bounds__(kThreads)
take_kernel(const unsigned char* __restrict__ mask,
            unsigned char* __restrict__ take, int n, int n_tiles,
            unsigned* scratch) {
  const int tile = next_tile(scratch);
  const int j0 = tile * kTile + threadIdx.x * kPer;
  const unsigned cand = load_bits(mask, j0, n);
  const unsigned carry = carry_in(fold(cand), scratch, tile);
  store_bits(take, j0, n, replay(cand, carry));
  finish(scratch, n_tiles, nullptr);
}

__global__ void __launch_bounds__(kThreads)
round_kernel(const unsigned char* __restrict__ alive,
             const int* __restrict__ pri, unsigned char* __restrict__ sel,
             unsigned char* __restrict__ alive_out, int* __restrict__ flag,
             int n, int n_tiles, unsigned* scratch) {
  // p of the entry before each thread's first ([t]), and of each thread's
  // first two entries and whether the first is alive ([t + 1]); the
  // tile's halo at [0] and [kThreads].
  __shared__ int s_before[kThreads + 1];
  __shared__ int s_first[kThreads + 1][2];
  __shared__ unsigned char s_first_alive[kThreads + 1];

  const int tile = next_tile(scratch);
  const int t = threadIdx.x;
  const int start = tile * kTile;
  const int j0 = start + t * kPer;
  const unsigned live = load_bits(alive, j0, n);
  int p[kPer];
  if (j0 + kPer <= n) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(pri + j0 + 4 * q);
      p[4 * q] = v.x;
      p[4 * q + 1] = v.y;
      p[4 * q + 2] = v.z;
      p[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) p[k] = j0 + k < n ? pri[j0 + k] : kBig;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (!((live >> k) & 1u)) p[k] = kBig;
  }
  s_before[t + 1] = p[kPer - 1];
  s_first[t][0] = p[0];
  s_first[t][1] = p[1];
  s_first_alive[t] = (unsigned char)(live & 1u);
  if (t == 0) s_before[0] = priority(alive, pri, start - 1, n);
  if (t == kThreads - 1) {
    const int r = start + kTile;
    s_first[kThreads][0] = priority(alive, pri, r, n);
    s_first[kThreads][1] = priority(alive, pri, r + 1, n);
    s_first_alive[kThreads] = (unsigned char)(r < n && alive[r] != 0);
  }
  __syncthreads();

  unsigned cand = 0u;
  int left = s_before[t];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int right = k + 1 < kPer ? p[k + 1] : s_first[t + 1][0];
    cand |= (((live >> k) & 1u) && p[k] <= left && p[k] <= right) << k;
    left = p[k];
  }
  const int pn = s_first[t + 1][0];
  const unsigned cand_next =
      s_first_alive[t + 1] && pn <= p[kPer - 1] && pn <= s_first[t + 1][1];

  const unsigned carry = carry_in(fold(cand), scratch, tile);
  const unsigned take = replay(cand, carry);
  const unsigned take_next = cand_next & (((take >> (kPer - 1)) & 1u) ^ 1u);
  const unsigned near = (take | (take << 1) | carry | (take >> 1) |
                         (take_next << (kPer - 1))) & 0xffffu;
  store_bits(sel, j0, n, load_bits(sel, j0, n) | take);
  const unsigned rest = live & ~near;
  store_bits(alive_out, j0, n, rest);
  if (__syncthreads_or(rest != 0u) && t == 0) {
    atomicOr(scratch + kAnyAlive, 1u);
  }
  finish(scratch, n_tiles, flag);
}

int tiles(int n) { return n > kTile ? (n + kTile - 1) / kTile : 1; }

}  // namespace

extern "C" int replay_select_tile() { return kTile; }

// take = the run-parity take of mask (n bytes each). `scratch`: 4 + tiles
// zeroed 32-bit words, left zeroed.
extern "C" int replay_select_take_launch(const void* mask, void* take, int n,
                                         void* scratch, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = tiles(n);
  take_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask),
      static_cast<unsigned char*>(take), n, n_tiles,
      static_cast<unsigned*>(scratch));
  return (int)cudaGetLastError();
}

// One matching round: sel updated in place, alive_out written, *flag = 1
// if any entry of alive_out is set, else 0.
extern "C" int replay_select_round_launch(const void* alive, const void* pri,
                                          void* sel, void* alive_out,
                                          void* flag, int n, void* scratch,
                                          void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = tiles(n);
  round_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(alive), static_cast<const int*>(pri),
      static_cast<unsigned char*>(sel),
      static_cast<unsigned char*>(alive_out), static_cast<int*>(flag), n,
      n_tiles, static_cast<unsigned*>(scratch));
  return (int)cudaGetLastError();
}
