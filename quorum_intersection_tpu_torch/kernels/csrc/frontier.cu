// The device-resident branch-and-bound frontier for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (kernels/frontier_cuda.py).
//
// K9 replaces the JAX package's chunk loop `TpuFrontierBackend._build_chunk`
// (backends/tpu/frontier.py:330: `expand` :380, `chunk_fn` :463, a jitted
// lax.while_loop); K10 its flag filter `_build_flag_filter` (:254,
// `filter_block` :300).  Both evaluate fixpoints on the fused sweep's warp
// evaluator (warp_mma.cuh: b1 and-popc mma.sync, 16 rows a warp), in lane
// space: the wrapper relabels the circuit so that node i is the SCC's lane i,
// so a (toRemove, dontRemove) state row of s <= 256 int8 lanes packs into W =
// ceil(s / 64) 64-bit words (every kernel has an instance a W: 1 up to 64
// lanes, 2 up to 128, 3 up to 192, 4 up to 256) and feeds the evaluator as it
// is, the row being the A operand's 128-column k-slab up to 128 lanes and
// two node k-slabs past it (warp_mma.cuh's kNS).  A quad of a warp moves a
// row, as 8-byte groups of int8 0/1 (s a multiple of 8) packed to and from
// bits with one multiply a word: at W = 1 thread q holds lanes [16 q, 16 q +
// 16); above it the evaluator's words k = q + 4 x of the row's node slabs x,
// lanes [32 k, 32 k + 32) (at W = 2 word q alone; at W = 3 threads 0 and 1
// hold two words and threads 2 and 3 one, so that a part never straddles an
// evaluator word).  States of W = 3 words (24 bytes) break 16-byte
// alignment, so rows of three and four words move a 64-bit word at a time.
//
// K9, one cooperative launch a chunk (grid.sync(), no -rdc), one grid barrier
// an iteration:
//   copy the source arena's rows [0, top) into the destination        | grid sync
//   iteration i:
//     (a) every block scans stash i-1's codes in row order (the same
//         deterministic sums in every block, so no broadcast is needed):
//         top_i = base_{i-1} + its children, fcount_i, the exit test, and in
//         shared memory the map from each child position of [base_{i-1},
//         top_i) to its stash entry (include or exclude) and from each flag
//         to its entry
//     (b) k_i = min(top_i, K), base_i = top_i - k_i; the grid's warps write
//         stash i-1's children at [base_{i-1}, base_i) to the arena and its
//         flags from fcount_{i-1} (past the arena or the flag buffer they are
//         dropped: the JAX scatter's mode="drop")
//     (c) a warp pops 8 states of [base_i, top_i): at or above base_{i-1}
//         straight from stash i-1 (those children never reach the arena),
//         below it from the arena; rows g = D, g + 8 = T | D, one Q fixpoint;
//         live, d_has_q, contained, eligible, the branch variable; the
//         children's and the flag's bits into stash i                  | grid sync
//   when the exit test fails at the top of an iteration, (b) writes all of
//   the last stash's children [base_{i-1}, top_i) and its flags, and block 0
//   writes the counters [top, fcount, iters, popped].
// Why one barrier is enough: in iteration i the arena is read only at
// [base_i, base_{i-1}) and written only at [base_{i-1}, base_i), and at most
// one of the two ranges is non-empty; iteration i reads stash i-1 and writes
// stash i (two halves that alternate), and the barrier ends iteration i.
// Rows and codes written within the launch are read through L2 (ld.cg).  The
// exit test reads only values every block holds alike, so all blocks leave
// the loop together.
//
// K9's iteration instance, the frontier under a mesh (the JAX row-sharded
// fixpoint, frontier.py:351-363, under the shard_map of :475-502): one
// ordinary launch an iteration and a rank, the kernel boundary in place of
// the grid barrier.  Each rank keeps its own arena and its own stash; rank r
// pops the states [r K/n, (r+1) K/n) of the pop block (K a multiple of the
// n ranks) and writes their stash entries into its share of the stash half;
// between two launches the host gathers the shares (parallel/mesh.py
// mesh_all_gather), so every rank scans the whole stash and writes the same
// children and flags into its arena.  A stash half is share-major: share r
// holds Ks = K/n rounded up to 8 slots, its toRemove states, its
// dontRemove states, then its codes ((16 W + 2) Ks bytes: 18 Ks at W = 1),
// so a share is one contiguous range to gather and a group of 8 codes never
// leaves its share.  The loop state
// [top, fcount, iters, popped, pbase, pk, done] lives on the device in two
// slots (launch j reads slot j & 1 and writes the other), so the host
// enqueues launches without reading it; a launch after the chunk's end only
// carries the state forward.  It serves meshes of several processes, whose
// gather (NCCL or gloo) no kernel can reach.
//
// K9's mesh-chunk instance, the frontier under a mesh of one process (the
// same JAX code: the row-sharded fixpoint, frontier.py:351-363, and the
// jitted while_loop over it under the shard_map of :475-502, the whole chunk
// one program): one cooperative launch a chunk and a card, K9's loop.  Ranks
// that share a card share its launch, its arena, its flags and its stash:
// the card's warps pop the shares of its ranks (rank r: states [r Kn,
// r Kn + Kn) of the pop block, Kn = K/n, share-major halves as above) and
// write their entries straight into its stash half, and (b) writes the
// children and flags once a card.  On several cards each card runs its own
// launch over its own copy of the arena and also stores its shares into
// every other card's stash half through peer pointers (NVLink); after the
// iteration's grid barrier one thread a card publishes the card's arrival
// (a system-scope release increment of every card's arrival counter, after
// __threadfence_system) and spins on its own counter with acquire loads
// until every card has arrived; a second grid barrier releases the card's
// blocks.  Why one exchange an iteration is enough: iteration i reads half
// i-1 and writes half i, so a card writes half i+1 (= half i-1) into a peer
// only after passing exchange i, which needs that peer's arrival at the end
// of iteration i, after its last read of half i-1.  The chunk ends with one
// more exchange, after the last reads of (a) and (b), so that the next
// chunk's first stores (half 0) find every peer done reading.  The counter
// only grows over a solve: exchange e of the solve waits for cards · e
// arrivals, and the exchanges before the chunk are kept on the card
// (sync[0]).  A wait longer than spin_cycles sets sync[1] (kSpinTimeout) and
// every block of the card leaves; the wrapper raises.  Every card runs the
// exit test on the same gathered stash, so all cards leave together, as the
// JAX program's replicated while_loop condition does.
//
// What bounds the mesh-chunk instance: an iteration moves K9's bytes (the
// arena rows, the children, the flags; 0.000832 ms a 33-iteration chunk of
// hier-8x4 at 3.35 TB/s) on every card, plus each card's shares, (16 W + 2) Ks
// bytes a share, sent to each peer (about 37 KB an iteration at K = 2048
// on 4 cards, 0.00008 ms at 450 GB/s), plus one NVLink round trip an
// iteration (a few microseconds); on one card the round trip is absent and
// it is K9's loop.  The design pays neither a kernel launch nor a host
// gather an iteration: the host launches once a chunk and a card and reads
// the counters once a chunk.
//
// The branch variable by popcount: the wrapper passes a_scc's column
// bit-planes (plane b of lane w: the members u with bit b of a_scc[u][w] set),
// so the in-degree of lane w from a quorum f2 is sum_b popc(f2 & plane_b[w])
// << b (planes [P][W][s]: word j of plane b of lane w holds lanes 64 j to
// 64 j + 63).  Quad thread q takes lanes q, q + 4, ... of its row and the
// quad keeps the largest packed key ((m + 1) << 8) | (255 - lane) by two
// shuffles: the lowest lane on ties, as JAX's argmax over the masked row
// (lane 255 and an in-degree below 2^16 fit the key's 32 bits).
//
// K10, one launch a flag block: a warp takes 8 flagged sets D, the tasks
// interleaved over a grid of at least a block an SM.  The leave-one-out rows
// D minus {j} of its sets, in full 16-row tiles in member-major order (member
// 0 of each set, then member 1, ...), under the scoped thresholds: a set one
// of whose rows holds a quorum is not minimal, and its remaining rows are
// skipped.  Then, if a set is minimal, one fixpoint of the minimal sets'
// probe rows (scc minus D) under the probe thresholds: a witness candidate is
// minimal and its probe holds a quorum.  The warp adds its minimal count and
// lowers the first witness index with atomics (an integer sum and a minimum:
// the same result in any order).
//
// What bounds them: an iteration of K9 moves 2k state rows in and at most 4k
// child rows and k flag rows out (s bytes each; about 0.8 MB at k = 2048,
// s = 64, 1.6 MB at s = 128, 3.1 MB at s = 256) and runs 2k fixpoint rows; the tensor-core work
// of those rows is microseconds, so the grid barrier and the fixpoint's serial passes set the
// pace.  K10 reads each flagged row once; its work is the leave-one-out rows
// it evaluates and the minimal sets' probes, a chain of fixpoints a warp.

#include <cooperative_groups.h>

#include <mutex>
#include <set>
#include <type_traits>

#include "warp_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace qi_warp;

constexpr int kPhases = 7;  // the timed instance's parts of an iteration (frontier_cuda.TIMED_PHASES)
constexpr int kSets = 8;    // K10: flagged sets a warp (probe rows g; 16 and 4 were no faster)

struct ChunkArgs {
  Params p;  // lane-space tables; thr_q the scoped thresholds
  int s;     // lanes a state row (<= 256, a multiple of 8): W = state_words(s) words a state
  int half, K, Kp, C, chunk_iters, flag_cap, flag_exit;
  int P;                             // in-degree bit-planes
  const unsigned long long* planes;  // [P][W][s] members 64 j + x with bit b of a_scc[64 j + x][w]
  const int8_t* src_T;
  const int8_t* src_D;
  const int* src_ctr;  // [0]: top of the source arena
  int8_t* T;           // [C][s] destination arena
  int8_t* D;
  int8_t* flags;  // [flag_cap][s]
  int* ctr;       // [4]: top, fcount, iters, popped
  unsigned long long* st_T;  // [2][Kp][W] stash halves: the children's toRemove
  unsigned long long* st_D;  // [2][Kp][W] the popped dontRemove
  uint16_t* st_code;         // [2][Kp] bit 0 include, 1 exclude, 2 flag; the branch lane from bit 8
  long long* timing;         // the timed instance: [kPhases] clock64 cycles of warp 0 of block 0, then iterations
};

struct FilterArgs {
  Params p;  // thr_q scoped (leave-one-out rows), thr_d the probe's
  int s;
  const int8_t* flags;  // [count][s]
  int count;
  int* out;  // [0] minimal count, [1] first witness index (preset to the block size)
};

// A state row over the SCC's lanes: W 64-bit words, bit x of word j lane
// 64 j + x.  W = 1 (at most 64 lanes) is one unsigned long long, W = 2
// (65-128 lanes) a ulonglong2 (x the lower word), W = 3 and 4 (129-256
// lanes) Words<W>, 8-byte aligned.  The operators and helpers below give the
// kernels one text for all, and W = 1 the code of one word.
template <int W>
struct Words {
  unsigned long long w[W];
};
template <int W>
struct RowType {
  using T = Words<W>;
};
template <>
struct RowType<1> {
  using T = unsigned long long;
};
template <>
struct RowType<2> {
  using T = ulonglong2;
};
template <int W>
using Row = typename RowType<W>::T;

// The evaluator's node k-slabs for rows of W words (warp_mma.cuh Warp's kNS).
template <int W>
constexpr int kNodeSlabs = W > 2 ? 2 : 1;

__device__ __forceinline__ ulonglong2 operator|(ulonglong2 a, ulonglong2 b) {
  return make_ulonglong2(a.x | b.x, a.y | b.y);
}
__device__ __forceinline__ ulonglong2 operator&(ulonglong2 a, ulonglong2 b) {
  return make_ulonglong2(a.x & b.x, a.y & b.y);
}
__device__ __forceinline__ ulonglong2 operator~(ulonglong2 a) { return make_ulonglong2(~a.x, ~a.y); }

__device__ __forceinline__ int popc(unsigned long long a) { return __popcll(a); }
__device__ __forceinline__ int popc(ulonglong2 a) { return __popcll(a.x) + __popcll(a.y); }
__device__ __forceinline__ bool any(unsigned long long a) { return a != 0; }
__device__ __forceinline__ bool any(ulonglong2 a) { return (a.x | a.y) != 0; }
__device__ __forceinline__ bool lane_set(unsigned long long a, int x) { return (a >> x) & 1; }
__device__ __forceinline__ bool lane_set(ulonglong2 a, int x) { return ((x < 64 ? a.x : a.y) >> (x & 63)) & 1; }
__device__ __forceinline__ unsigned long long shfl(unsigned long long a, int src) {
  return __shfl_sync(kFull, a, src);
}
__device__ __forceinline__ ulonglong2 shfl(ulonglong2 a, int src) {
  return make_ulonglong2(__shfl_sync(kFull, a.x, src), __shfl_sync(kFull, a.y, src));
}
__device__ __forceinline__ unsigned long long shfl_xor(unsigned long long a, int m) {
  return __shfl_xor_sync(kFull, a, m);
}
__device__ __forceinline__ ulonglong2 shfl_xor(ulonglong2 a, int m) {
  return make_ulonglong2(__shfl_xor_sync(kFull, a.x, m), __shfl_xor_sync(kFull, a.y, m));
}

template <int W>
__device__ __forceinline__ Words<W> operator|(const Words<W>& a, const Words<W>& b) {
  Words<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = a.w[j] | b.w[j];
  return r;
}
template <int W>
__device__ __forceinline__ Words<W> operator&(const Words<W>& a, const Words<W>& b) {
  Words<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = a.w[j] & b.w[j];
  return r;
}
template <int W>
__device__ __forceinline__ Words<W> operator~(const Words<W>& a) {
  Words<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = ~a.w[j];
  return r;
}
template <int W>
__device__ __forceinline__ int popc(const Words<W>& a) {
  int c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) c += __popcll(a.w[j]);
  return c;
}
template <int W>
__device__ __forceinline__ bool any(const Words<W>& a) {
  unsigned long long o = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) o |= a.w[j];
  return o != 0;
}
// Word j of a, j a runtime index below W (selects, no local memory).
template <int W>
__device__ __forceinline__ unsigned long long word64(const Words<W>& a, int j) {
  unsigned long long v = 0;
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i == j) v = a.w[i];
  return v;
}
template <int W>
__device__ __forceinline__ bool lane_set(const Words<W>& a, int x) {
  return (word64(a, x >> 6) >> (x & 63)) & 1;
}
template <int W>
__device__ __forceinline__ Words<W> shfl(const Words<W>& a, int src) {
  Words<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = __shfl_sync(kFull, a.w[j], src);
  return r;
}
template <int W>
__device__ __forceinline__ Words<W> shfl_xor(const Words<W>& a, int m) {
  Words<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = __shfl_xor_sync(kFull, a.w[j], m);
  return r;
}

// The evaluator's 32-bit word k (nodes [32 k, 32 k + 32)) of a row of W >= 3
// words: word k & 3 of node slab k >> 2, 0 past the row.
using qi_warp::word_of;
template <int W>
__device__ __forceinline__ uint32_t word_of(const Words<W>& row, int k) {
  return (uint32_t)(word64(row, k >> 1) >> (32 * (k & 1)));
}

// A state of W words from the stash (written within the launch: read
// through L2); three and four words a 64-bit word at a time.
template <int W>
__device__ __forceinline__ Row<W> ld_row(const Row<W>* p) {
  if constexpr (W <= 2) {
    return __ldcg(p);
  } else {
    Words<W> r;
    const unsigned long long* w = reinterpret_cast<const unsigned long long*>(p);
#pragma unroll
    for (int j = 0; j < W; ++j) r.w[j] = __ldcg(w + j);
    return r;
  }
}

// Words of a state row of s lanes.
__host__ __device__ inline int state_words(int s) { return (s + 63) / 64; }

// The row of lane x alone.
template <int W>
__device__ __forceinline__ Row<W> lane_row(int x) {
  if constexpr (W == 1) {
    return 1ull << x;
  } else if constexpr (W == 2) {
    const unsigned long long b = 1ull << (x & 63);
    return make_ulonglong2(x < 64 ? b : 0ull, x < 64 ? 0ull : b);
  } else {
    Words<W> r;
#pragma unroll
    for (int j = 0; j < W; ++j) r.w[j] = (x >> 6) == j ? 1ull << (x & 63) : 0ull;
    return r;
  }
}

// The row of lanes [0, s).
template <int W>
__device__ __forceinline__ Row<W> lanes_below(int s) {
  if constexpr (W == 1) {
    return s >= 64 ? ~0ull : ((1ull << s) - 1);
  } else if constexpr (W == 2) {
    return make_ulonglong2(s >= 64 ? ~0ull : ((1ull << s) - 1),
                           s >= 128 ? ~0ull : (s > 64 ? (1ull << (s - 64)) - 1 : 0ull));
  } else {
    Words<W> r;
#pragma unroll
    for (int j = 0; j < W; ++j)
      r.w[j] = s >= 64 * (j + 1) ? ~0ull : (s > 64 * j ? (1ull << (s - 64 * j)) - 1 : 0ull);
    return r;
  }
}

// Four int8 0/1 lanes as four bits, and back.
__device__ __forceinline__ uint32_t pack4(uint32_t w) { return ((w & 0x01010101u) * 0x01020408u) >> 24; }
__device__ __forceinline__ uint32_t unpack4(uint32_t x) { return (x * 0x00204081u) & 0x01010101u; }

// The 32 lanes [32 k, 32 k + 32) of a row of s int8 lanes (s a multiple of
// 8), as bits; 0 past s.
__device__ __forceinline__ uint32_t load_word(const int8_t* row, int s, int k) {
  uint32_t bits = 0;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int off = 32 * k + 8 * h;
    if (off < s) {
      const uint2 v = __ldcg(reinterpret_cast<const uint2*>(row + off));
      bits |= (pack4(v.x) | (pack4(v.y) << 4)) << (8 * h);
    }
  }
  return bits;
}

// Quad thread q's part of a row of s int8 lanes, as bits: lanes [16 q,
// 16 q + 16) at W = 1, [32 q, 32 q + 32) (the evaluator's word q) at W = 2,
// the evaluator's words q and q + 4 (one a node slab) at W = 3 and 4.
template <int W>
__device__ __forceinline__ Row<W> load_part(const int8_t* row, int s, int q) {
  if constexpr (W > 2) {
    Words<W> r;
#pragma unroll
    for (int j = 0; j < W; ++j) r.w[j] = 0;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int k = q + 4 * x;
      const unsigned long long bits = (unsigned long long)load_word(row, s, k) << (32 * (k & 1));
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (j == (k >> 1)) r.w[j] |= bits;
    }
    return r;
  } else {
    unsigned long long bits = 0;
#pragma unroll
    for (int h = 0; h < 2 * W; ++h) {
      const int off = 16 * W * q + 8 * h;
      if (off < s) {
        const uint2 v = __ldcg(reinterpret_cast<const uint2*>(row + off));
        bits |= (unsigned long long)(pack4(v.x) | (pack4(v.y) << 4)) << (W == 1 ? off : 8 * h);
      }
    }
    if constexpr (W == 1) {
      return bits;
    } else {
      return make_ulonglong2(q < 2 ? bits << (32 * q) : 0ull, q < 2 ? 0ull : bits << (32 * (q - 2)));
    }
  }
}

// Quad thread q writes its part of a row (load_part's lanes) as int8 0/1.
template <int W>
__device__ __forceinline__ void store_part(int8_t* row, Row<W> bits, int s, int q) {
  if constexpr (W > 2) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int k = q + 4 * x;
      const uint32_t mine = word_of(bits, k);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int off = 32 * k + 8 * h;
        if (off < s) {
          const uint32_t b = mine >> (8 * h);
          *reinterpret_cast<uint2*>(row + off) = make_uint2(unpack4(b & 15u), unpack4((b >> 4) & 15u));
        }
      }
    }
  } else {
    unsigned long long mine;
    if constexpr (W == 1) {
      mine = bits;
    } else {
      mine = word_of(bits, q);
    }
#pragma unroll
    for (int h = 0; h < 2 * W; ++h) {
      const int off = 16 * W * q + 8 * h;
      if (off < s) {
        const uint32_t b = (uint32_t)(mine >> (W == 1 ? off : 8 * h));
        *reinterpret_cast<uint2*>(row + off) = make_uint2(unpack4(b & 15u), unpack4((b >> 4) & 15u));
      }
    }
  }
}

// The quad's parts of a row, whole in each of its threads.
template <class R>
__device__ __forceinline__ R quad_or(R x) {
  x = x | shfl_xor(x, 1);
  x = x | shfl_xor(x, 2);
  return x;
}

// The quad's 64-bit word of two evaluator words, those of its threads
// qb and qb + 1.
__device__ __forceinline__ unsigned long long quad_pair(uint32_t w, int qb) {
  return (unsigned long long)__shfl_sync(kFull, w, qb) | ((unsigned long long)__shfl_sync(kFull, w, qb + 1) << 32);
}

// A row of three or four words back from the evaluator's words of the quad,
// w0 of node slab 0 and w1 of slab 1.
template <int W>
__device__ __forceinline__ Row<W> quad_row(uint32_t w0, uint32_t w1, int lane) {
  const int qb = lane & ~3;
  Words<W> r;
  r.w[0] = quad_pair(w0, qb);
  r.w[1] = quad_pair(w0, qb + 2);
  r.w[2] = quad_pair(w1, qb);
  if constexpr (W == 4) r.w[3] = quad_pair(w1, qb + 2);
  return r;
}

// Rows g and g + 8 back as rows from the evaluator's words, the quad's
// lanes 0 and 1 (W = 1) or lanes 0-3 (W = 2).
template <int W>
__device__ __forceinline__ Row<W> quad_row(uint32_t w, int lane) {
  const int qb = lane & ~3;
  const unsigned long long lo =
      (unsigned long long)__shfl_sync(kFull, w, qb) | ((unsigned long long)__shfl_sync(kFull, w, qb + 1) << 32);
  if constexpr (W == 1) {
    return lo;
  } else {
    return make_ulonglong2(lo, (unsigned long long)__shfl_sync(kFull, w, qb + 2) |
                                   ((unsigned long long)__shfl_sync(kFull, w, qb + 3) << 32));
  }
}

// The n-th (0-based) set bit of x, which has more than n, as a one-bit mask.
__device__ __forceinline__ uint64_t nth_bit(uint64_t x, int n) {
  int pos = 0;
#pragma unroll
  for (int width = 32; width; width >>= 1) {
    const int c = __popcll(x & ((1ull << width) - 1));
    if (n >= c) {
      n -= c;
      x >>= width;
      pos += width;
    }
  }
  return 1ull << pos;
}

// d less its n-th (0-based) set lane; d has more than n.
__device__ __forceinline__ unsigned long long drop_nth(unsigned long long d, int n) { return d & ~nth_bit(d, n); }
__device__ __forceinline__ ulonglong2 drop_nth(ulonglong2 d, int n) {
  const int c = __popcll(d.x);
  return n < c ? make_ulonglong2(d.x & ~nth_bit(d.x, n), d.y) : make_ulonglong2(d.x, d.y & ~nth_bit(d.y, n - c));
}
template <int W>
__device__ __forceinline__ Words<W> drop_nth(Words<W> d, int n) {
  int j = 0;  // the word that holds the n-th lane; n then counts within it
#pragma unroll
  for (int i = 0; i + 1 < W; ++i) {
    const int c = __popcll(d.w[i]);
    if (j == i && n >= c) {
      n -= c;
      j = i + 1;
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i == j) d.w[i] &= ~nth_bit(d.w[i], n);
  return d;
}

// Lane x's in-degree bit-plane b, of the planes [P][W][s] in shared memory.
template <int W>
__device__ __forceinline__ Row<W> plane_of(const unsigned long long* planes, int b, int s, int x) {
  if constexpr (W == 1) {
    return planes[b * s + x];
  } else if constexpr (W == 2) {
    return make_ulonglong2(planes[2 * b * s + x], planes[(2 * b + 1) * s + x]);
  } else {
    Words<W> r;
#pragma unroll
    for (int j = 0; j < W; ++j) r.w[j] = planes[(W * b + j) * s + x];
    return r;
  }
}

// The greatest fixpoints f1 of D (row g) and f2 of D | T (uni, row g + 8)
// under the scoped thresholds, whole in each thread of the quad; `between`
// runs after the fixpoint, before the rows are gathered (the timed
// instance's mark).
template <int W, class WarpT, class F>
__device__ __forceinline__ void quorums(WarpT& w, const Row<W>& D, const Row<W>& uni, int q, int lane, Row<W>& f1,
                                        Row<W>& f2, F&& between) {
  if constexpr (W <= 2) {
    uint32_t a0 = word_of(D, q), a1 = word_of(uni, q);
    w.fixpoint(a0, a1, 0u, w.src.thr_q);
    between();
    f1 = quad_row<W>(a0, lane);
    f2 = quad_row<W>(a1, lane);
  } else {
    uint32_t a[4] = {word_of(D, q), word_of(uni, q), word_of(D, q + 4), word_of(uni, q + 4)};
    w.fixpoint(a, 0u, w.src.thr_q);
    between();
    f1 = quad_row<W>(a[0], a[2], lane);
    f2 = quad_row<W>(a[1], a[3], lane);
  }
}

// Children, and flags << 16, that one stash code adds.
__device__ __forceinline__ int code_count(unsigned c) { return (c & 1) + ((c >> 1) & 1) + (((c >> 2) & 1) << 16); }

// Entry x of the child map (2 e: include, 2 e + 1: exclude) of the stash
// half at `half`, as a state (T, D).
template <int W>
__device__ __forceinline__ void stash_child(const ChunkArgs& a, int half, unsigned x, Row<W>& T, Row<W>& D) {
  const int e = half + (int)(x >> 1);
  T = ld_row<W>(reinterpret_cast<const Row<W>*>(a.st_T) + e);
  D = ld_row<W>(reinterpret_cast<const Row<W>*>(a.st_D) + e);
  if (!(x & 1)) D = D | lane_row<W>(__ldcg(a.st_code + e) >> 8);
}

// K9's stash codes: entry e of a half at code + e.
struct LinearCodes {
  const uint16_t* code;
  __device__ __forceinline__ const uint16_t* operator()(int e) const { return code + e; }
};

// Every block alike: the exclusive scan of the n codes of a stash half in row
// order, a thread 8 codes (one 16-byte load, codes(e) for e a multiple of 8)
// at a time; fills the child map cmap (position - base -> 2 e + exclude) and
// the flag map fmap (flag -> e).  Returns children | flags << 16 (children <=
// 2K, flags <= K, K <= 8192).
template <class Codes>
__device__ int scan_stash(const Codes& codes, int n, uint16_t* cmap, uint16_t* fmap, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = 8 * ((n + 8 * kThreads - 1) / (8 * kThreads));
  const int e0 = threadIdx.x * per, e1 = min(n, e0 + per);
  int v = 0;
  for (int e = e0; e < e1; e += 8) {
    const uint4 w = __ldcg(reinterpret_cast<const uint4*>(codes(e)));
    const unsigned h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (e + m < e1) v += code_count((h[m >> 1] >> (16 * (m & 1))) & 0xffffu);
  }
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int y = lane < kWarps ? red[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int z = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += z;
    }
    if (lane < kWarps) red[lane] = y;
  }
  __syncthreads();
  const int total = red[kWarps - 1];
  int run = (warp ? red[warp - 1] : 0) + x - v;
  for (int e = e0; e < e1; e += 8) {
    const uint4 w = __ldcg(reinterpret_cast<const uint4*>(codes(e)));
    const unsigned h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (e + m < e1) {
        const unsigned c = (h[m >> 1] >> (16 * (m & 1))) & 0xffffu;
        const int co = run & 0xffff;
        if (c & 1) cmap[co] = (uint16_t)(2 * (e + m));
        if (c & 2) cmap[co + (c & 1)] = (uint16_t)(2 * (e + m) + 1);
        if (c & 4) fmap[run >> 16] = (uint16_t)(e + m);
        run += code_count(c);
      }
    }
  }
  __syncthreads();
  return total;
}

__host__ __device__ inline unsigned chunk_extra_bytes(int s, int Kp, int P) {
  return round16(8u * P * state_words(s) * s) + round16(6u * Kp) + round16(4u * (kWarps + 1));
}

// K10's shared memory a warp: its sets, per member index the sets with more
// members, the tile's slots and cursor (a multiple of 16 bytes at every W).
__host__ __device__ constexpr unsigned filter_warp_bytes(int W) {
  return 8 * W * kSets + 2 * 64 * W + 2 * 16 + 16;
}

__host__ __device__ inline unsigned filter_extra_bytes(int s) {
  return kWarps * filter_warp_bytes(state_words(s));
}

template <class Src, bool kS1, int W, bool kTimed>
__global__ void __launch_bounds__(kThreads) chunk_kernel(ChunkArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(false, Src::kStream, a.p);
  Warp<Src, kS1, kNodeSlabs<W>> w;
  w.init(smem, l, a.p, false);
  const int s = a.s, Kp = a.Kp;
  const unsigned plane_bytes = round16(8u * a.P * W * s);
  unsigned long long* planes = reinterpret_cast<unsigned long long*>(smem + l.end);
  uint16_t* cmap = reinterpret_cast<uint16_t*>(smem + l.end + plane_bytes);  // [2 Kp]
  uint16_t* fmap = cmap + 2 * Kp;                                               // [Kp]
  int* red = reinterpret_cast<int*>(smem + l.end + plane_bytes + round16(6u * Kp));
  for (int i = threadIdx.x; i < a.P * W * s; i += blockDim.x) planes[i] = a.planes[i];

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3, warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + warp, nwarps = gridDim.x * kWarps;
  int top = a.src_ctr[0];

  // The source's live rows into the destination, 16 bytes at a time (the
  // arenas start 256-byte aligned), then the tail.
  if (a.src_T != a.T) {
    const long long nbytes = (long long)top * s;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long vec = nbytes / 16;
    for (long long i = tid; i < vec; i += stride) {
      reinterpret_cast<uint4*>(a.T)[i] = reinterpret_cast<const uint4*>(a.src_T)[i];
      reinterpret_cast<uint4*>(a.D)[i] = reinterpret_cast<const uint4*>(a.src_D)[i];
    }
    for (long long i = 16 * vec + tid; i < nbytes; i += stride) {
      a.T[i] = a.src_T[i];
      a.D[i] = a.src_D[i];
    }
  }
  __syncthreads();
  grid.sync();

  // The timed instance: warp 0 of block 0 adds the cycles since the last
  // mark to part ph.
  long long t_acc[kPhases] = {};
  long long t_last = clock64();
  const bool timer = kTimed && blockIdx.x == 0 && warp == 0;
  auto mark = [&](int ph) {
    if constexpr (kTimed) {
      const long long now = clock64();
      if (timer) t_acc[ph] += now - t_last;
      t_last = now;
    }
  };

  int fcount = 0, iters = 0, popped = 0;
  int pbase = 0, pk = 0;  // the previous iteration's base and pops (pk 0: none in this launch)
  for (;;) {
    const int prev = ((iters + 1) & 1) * Kp, cur = (iters & 1) * Kp;  // stash halves i-1 and i
    const int fprev = fcount;
    int nflags = 0;
    if (pk) {
      const int total = scan_stash(LinearCodes{a.st_code + prev}, pk, cmap, fmap, red);
      top = pbase + (total & 0xffff);
      nflags = total >> 16;
      fcount = min(fcount + nflags, a.flag_cap);
    }
    mark(0);
    const bool go = top > 0 && iters < a.chunk_iters && fcount < a.flag_exit && top <= a.C - 2 * a.K;
    const int k = go ? min(top, a.K) : 0, base = top - k;

    // (b) stash i-1's children that stay on the stack, and its flags.
    if (pk) {
      const int nw = max(0, base - pbase), nf = max(0, min(nflags, a.flag_cap - fprev));
      for (int t = gwarp; 8 * t < nw; t += nwarps) {
        const int j = 8 * t + g;
        const long long pos = (long long)pbase + j;
        if (j < nw && pos < a.C) {
          Row<W> cT, cD;
          stash_child<W>(a, prev, cmap[j], cT, cD);
          store_part<W>(a.T + pos * s, cT, s, q);
          store_part<W>(a.D + pos * s, cD, s, q);
        }
      }
      for (int t = gwarp; 8 * t < nf; t += nwarps) {
        const int j = 8 * t + g;
        if (j < nf)
          store_part<W>(a.flags + (long long)(fprev + j) * s,
                        ld_row<W>(reinterpret_cast<const Row<W>*>(a.st_D) + prev + fmap[j]), s, q);
      }
    }
    mark(1);
    if (!go) break;

    // (c) pop, fixpoint, prune, branch, stash.
    const int tasks = (k + 7) / 8;
    for (int t = gwarp; t < tasks; t += nwarps) {
      const int i = 8 * t + g;
      const bool valid = i < k;
      const int pos = base + i;
      Row<W> myT{}, myD{};
      if (valid && pk && pos >= pbase) {
        stash_child<W>(a, prev, cmap[pos - pbase], myT, myD);  // whole in each thread of the quad
      } else if (valid) {
        myT = load_part<W>(a.T + (long long)pos * s, s, q);
        myD = load_part<W>(a.D + (long long)pos * s, s, q);
      }
      myT = quad_or(myT);
      myD = quad_or(myD);
      mark(2);
      const Row<W> uni = myT | myD;
      Row<W> f1, f2;
      quorums<W>(w, myD, uni, q, lane, f1, f2, [&] { mark(3); });
      const int dsize = popc(myD);
      const bool live = valid && dsize <= a.half && any(uni);
      const bool dq = live && any(f1);
      const Row<W> elig = f2 & ~myD;
      const bool br = live && !dq && any(f2) && !any(myD & ~f2) && any(elig);

      // Branch variable: the largest in-degree within quorum minus
      // dontRemove, the lowest lane on ties.
      unsigned key = 0;
      if (br) {
        for (int x = q; x < s; x += 4) {
          if (!lane_set(elig, x)) continue;
          int m = 0;
          for (int b = 0; b < a.P; ++b) m += popc(f2 & plane_of<W>(planes, b, s, x)) << b;
          key = max(key, ((unsigned)(m + 1) << 8) | (unsigned)(255 - x));
        }
      }
      key = max(key, __shfl_xor_sync(kFull, key, 1));
      key = max(key, __shfl_xor_sync(kFull, key, 2));
      const int best = key ? 255 - (int)(key & 255u) : 0;
      mark(4);
      if (q == 0 && valid) {
        const Row<W> child = elig & ~lane_row<W>(best);
        const bool incl = br && dsize + 1 <= a.half;
        const bool excl = br && (popc(child) + dsize) > 0;
        reinterpret_cast<Row<W>*>(a.st_T)[cur + i] = child;
        reinterpret_cast<Row<W>*>(a.st_D)[cur + i] = myD;
        a.st_code[cur + i] = (uint16_t)((int)incl | ((int)excl << 1) | ((int)dq << 2) | (best << 8));
      }
      mark(5);
    }
    grid.sync();
    mark(6);
    pbase = base;
    pk = k;
    ++iters;
    popped += k;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ctr[0] = top;
    a.ctr[1] = fcount;
    a.ctr[2] = iters;
    a.ctr[3] = popped;
    if constexpr (kTimed) {
      for (int ph = 0; ph < kPhases; ++ph) a.timing[ph] = t_acc[ph];
      a.timing[kPhases] = iters;
    }
  }
}

// ---- K9's iteration instance: one iteration of one mesh rank a launch ----

struct IterArgs {
  Params p;
  int s, half, K, C, chunk_iters, flag_cap, flag_exit, P;
  const unsigned long long* planes;
  int rank, ranks;  // this rank's share: states [rank Kn, rank Kn + Kn) of the pop block
  int Kn, Ks;       // states a share, and its slots (Kn rounded up to 8)
  int step;         // launches of this chunk before this one
  const int8_t* src_T;  // step 0: the source arena and its counters
  const int8_t* src_D;
  const int* src_ctr;
  int8_t* T;  // [C][s] this rank's destination arena
  int8_t* D;
  int8_t* flags;  // [flag_cap][s]
  int* ctr;       // [4]: top, fcount, iters, popped, written when the chunk ends
  unsigned char* stash;  // [2][ranks][(16 W + 2) Ks]: a share's toRemove states, dontRemove states, codes
  int* loop;             // [2][8]: top, fcount, iters, popped, pbase, pk, done; launch j reads j & 1
};

// Bytes of one share of a stash half: Ks toRemove and Ks dontRemove states
// of W words, Ks codes (a multiple of 16 bytes, Ks being one of 8).
template <int W>
__host__ __device__ inline size_t share_bytes(int Ks) {
  return (size_t)(16 * W + 2) * Ks;
}

// The codes of a gathered stash half, slot e = r Ks + j being entry j of
// share r (Ks a multiple of 8: a group of 8 never leaves its share).
template <int W>
struct ShareCodes {
  const unsigned char* half;
  int Ks;
  __device__ __forceinline__ const uint16_t* operator()(int e) const {
    const int r = e / Ks;
    return reinterpret_cast<const uint16_t*>(half + r * share_bytes<W>(Ks) + 16 * W * (size_t)Ks) + (e - r * Ks);
  }
};

// Entry x of the child map (2 e: include, 2 e + 1: exclude, e a slot) of a
// gathered stash half, as a state (T, D).
template <int W>
__device__ __forceinline__ void share_child(const unsigned char* half, int Ks, unsigned x, Row<W>& T, Row<W>& D) {
  const int e = (int)(x >> 1), r = e / Ks, j = e - r * Ks;
  const unsigned char* blk = half + r * share_bytes<W>(Ks);
  T = ld_row<W>(reinterpret_cast<const Row<W>*>(blk) + j);
  D = ld_row<W>(reinterpret_cast<const Row<W>*>(blk + 8 * W * (size_t)Ks) + j);
  if (!(x & 1)) D = D | lane_row<W>(__ldcg(reinterpret_cast<const uint16_t*>(blk + 16 * W * (size_t)Ks) + j) >> 8);
}

// Flag e (a slot) of a gathered stash half: its dontRemove state.
template <int W>
__device__ __forceinline__ Row<W> share_flag(const unsigned char* half, int Ks, int e) {
  const int r = e / Ks;
  return ld_row<W>(reinterpret_cast<const Row<W>*>(half + r * share_bytes<W>(Ks) + 8 * W * (size_t)Ks) +
                   (e - r * Ks));
}

// One iteration of K9 for one rank: (a) every block scans the whole
// gathered stash i-1, (b) writes its surviving children and its flags into
// this rank's arena, (c) runs the exit test on values every rank holds
// alike, and (d) if it passes, pops this rank's share of [base, top), runs
// its fixpoints, prunes, branches and writes the share's stash entries
// (every slot of the share: 0 past the valid states).  The kernel boundary
// takes the place of K9's grid barrier, and the gather between two launches
// gives every rank the other shares.  A launch after the chunk's end carries
// the loop state forward and does nothing else.
template <class Src, bool kS1, int W>
__global__ void __launch_bounds__(kThreads) iteration_kernel(IterArgs a) {
  const int* in = a.loop + 8 * (a.step & 1);
  int* out = a.loop + 8 * ((a.step + 1) & 1);
  if (a.step && in[6]) {
    if (blockIdx.x == 0 && threadIdx.x < 8) out[threadIdx.x] = in[threadIdx.x];
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(false, Src::kStream, a.p);
  Warp<Src, kS1, kNodeSlabs<W>> w;
  w.init(smem, l, a.p, false);
  const int s = a.s, Ks = a.Ks, slots = a.ranks * a.Ks;
  const unsigned plane_bytes = round16(8u * a.P * W * s);
  unsigned long long* planes = reinterpret_cast<unsigned long long*>(smem + l.end);
  uint16_t* cmap = reinterpret_cast<uint16_t*>(smem + l.end + plane_bytes);  // [2 slots]
  uint16_t* fmap = cmap + 2 * slots;                                            // [slots]
  int* red = reinterpret_cast<int*>(smem + l.end + plane_bytes + round16(6u * slots));
  for (int i = threadIdx.x; i < a.P * W * s; i += blockDim.x) planes[i] = a.planes[i];

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3, warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + warp, nwarps = gridDim.x * kWarps;
  int top, fcount, iters, popped, pbase, pk;
  const int8_t* rT = a.T;  // where this launch's pops below pbase come from
  const int8_t* rD = a.D;
  if (a.step == 0) {
    top = a.src_ctr[0];
    fcount = iters = popped = pbase = pk = 0;
    if (a.src_T != a.T) {
      // The source's live rows into the destination, as K9's copy; this
      // launch pops from the source, which nothing writes.
      rT = a.src_T;
      rD = a.src_D;
      const long long nbytes = (long long)top * s;
      const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
      const long long stride = (long long)gridDim.x * blockDim.x;
      const long long vec = nbytes / 16;
      for (long long i = tid; i < vec; i += stride) {
        reinterpret_cast<uint4*>(a.T)[i] = reinterpret_cast<const uint4*>(a.src_T)[i];
        reinterpret_cast<uint4*>(a.D)[i] = reinterpret_cast<const uint4*>(a.src_D)[i];
      }
      for (long long i = 16 * vec + tid; i < nbytes; i += stride) {
        a.T[i] = a.src_T[i];
        a.D[i] = a.src_D[i];
      }
    }
  } else {
    top = in[0];
    fcount = in[1];
    iters = in[2];
    popped = in[3];
    pbase = in[4];
    pk = in[5];
  }
  __syncthreads();

  // (a) stash i-1, gathered: the slots of its pk entries.
  const unsigned char* prev = a.stash + ((iters + 1) & 1) * (size_t)slots * (16 * W + 2);
  const int fprev = fcount;
  int nflags = 0;
  if (pk) {
    const int last = pk - 1;
    const int total = scan_stash(ShareCodes<W>{prev, Ks}, (last / a.Kn) * Ks + last % a.Kn + 1, cmap, fmap, red);
    top = pbase + (total & 0xffff);
    nflags = total >> 16;
    fcount = min(fcount + nflags, a.flag_cap);
  }
  // (c) the exit test, alike in every block of every rank.
  const bool go = top > 0 && iters < a.chunk_iters && fcount < a.flag_exit && top <= a.C - 2 * a.K;
  const int k = go ? min(top, a.K) : 0, base = top - k;

  // (b) stash i-1's children that stay on the stack, and its flags.
  if (pk) {
    const int nw = max(0, base - pbase), nf = max(0, min(nflags, a.flag_cap - fprev));
    for (int t = gwarp; 8 * t < nw; t += nwarps) {
      const int j = 8 * t + g;
      const long long pos = (long long)pbase + j;
      if (j < nw && pos < a.C) {
        Row<W> cT, cD;
        share_child<W>(prev, Ks, cmap[j], cT, cD);
        store_part<W>(a.T + pos * s, cT, s, q);
        store_part<W>(a.D + pos * s, cD, s, q);
      }
    }
    for (int t = gwarp; 8 * t < nf; t += nwarps) {
      const int j = 8 * t + g;
      if (j < nf) store_part<W>(a.flags + (long long)(fprev + j) * s, share_flag<W>(prev, Ks, fmap[j]), s, q);
    }
  }
  if (!go) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.ctr[0] = top;
      a.ctr[1] = fcount;
      a.ctr[2] = iters;
      a.ctr[3] = popped;
      const int st[8] = {top, fcount, iters, popped, pbase, pk, 1, 0};
      for (int x = 0; x < 8; ++x) out[x] = st[x];
    }
    return;
  }

  // (d) this rank's share: pop, fixpoint, prune, branch, stash.
  unsigned char* mine = a.stash + ((size_t)(iters & 1) * a.ranks + a.rank) * share_bytes<W>(Ks);
  for (int t = gwarp; 8 * t < Ks; t += nwarps) {
    const int j = 8 * t + g, i = a.rank * a.Kn + j;
    const bool valid = j < a.Kn && i < k;
    const int pos = base + i;
    Row<W> myT{}, myD{};
    if (valid && pk && pos >= pbase) {
      share_child<W>(prev, Ks, cmap[pos - pbase], myT, myD);  // whole in each thread of the quad
    } else if (valid) {
      myT = load_part<W>(rT + (long long)pos * s, s, q);
      myD = load_part<W>(rD + (long long)pos * s, s, q);
    }
    myT = quad_or(myT);
    myD = quad_or(myD);
    const Row<W> uni = myT | myD;
    Row<W> f1, f2;
    quorums<W>(w, myD, uni, q, lane, f1, f2, [] {});
    const int dsize = popc(myD);
    const bool live = valid && dsize <= a.half && any(uni);
    const bool dq = live && any(f1);
    const Row<W> elig = f2 & ~myD;
    const bool br = live && !dq && any(f2) && !any(myD & ~f2) && any(elig);

    // Branch variable: the largest in-degree within quorum minus
    // dontRemove, the lowest lane on ties (K9's).
    unsigned key = 0;
    if (br) {
      for (int x = q; x < s; x += 4) {
        if (!lane_set(elig, x)) continue;
        int m = 0;
        for (int b = 0; b < a.P; ++b) m += popc(f2 & plane_of<W>(planes, b, s, x)) << b;
        key = max(key, ((unsigned)(m + 1) << 8) | (unsigned)(255 - x));
      }
    }
    key = max(key, __shfl_xor_sync(kFull, key, 1));
    key = max(key, __shfl_xor_sync(kFull, key, 2));
    const int best = key ? 255 - (int)(key & 255u) : 0;
    if (q == 0) {
      const Row<W> child = elig & ~lane_row<W>(best);
      const bool incl = br && dsize + 1 <= a.half;
      const bool excl = br && (popc(child) + dsize) > 0;
      reinterpret_cast<Row<W>*>(mine)[j] = valid ? child : Row<W>{};
      reinterpret_cast<Row<W>*>(mine + 8 * W * (size_t)Ks)[j] = valid ? myD : Row<W>{};
      reinterpret_cast<uint16_t*>(mine + 16 * W * (size_t)Ks)[j] =
          valid ? (uint16_t)((int)incl | ((int)excl << 1) | ((int)dq << 2) | (best << 8)) : 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int st[8] = {top, fcount, iters + 1, popped + k, base, k, 0, 0};
    for (int x = 0; x < 8; ++x) out[x] = st[x];
  }
}

// ---- K9's mesh-chunk instance: one cooperative launch a chunk and a card ----

constexpr int kMaxCards = 16;    // cards of one process's mesh (frontier_cuda.MAX_CARDS)
constexpr int kSpinTimeout = 1;  // sync[1]: a peer card did not arrive within spin_cycles

struct MeshArgs {
  Params p;
  int s, half, K, C, chunk_iters, flag_cap, flag_exit, P;
  const unsigned long long* planes;
  int ranks, Kn, Ks;  // the mesh's ranks, states a share and its slots
  const int* mine;    // [nmine] the ranks whose shares this card pops
  int nmine;
  const int8_t* src_T;
  const int8_t* src_D;
  const int* src_ctr;
  int8_t* T;  // [C][s] this card's destination arena
  int8_t* D;
  int8_t* flags;
  int* ctr;              // [4]: top, fcount, iters, popped
  unsigned char* stash;  // [2][ranks][(16 W + 2) Ks], every rank's shares
  int* sync;             // [4]: exchanges of the solve before this chunk, status, arrivals, 0
  int cards;             // 1: no exchange
  unsigned char* peer_stash[kMaxCards];  // the other cards' stashes
  int* peer_sync[kMaxCards];             // and their sync words
  long long spin_cycles;
};

__device__ __forceinline__ int load_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release_sys(int* p, int v) {
  asm volatile("red.release.sys.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Exchange n of the solve (1-based), after a grid barrier: thread 0 of block
// 0 adds this card's arrival to every card's counter and waits for all
// cards' arrivals at n; a second barrier releases the card's blocks.  False,
// in every block, when the wait passed spin_cycles.
__device__ bool exchange(const MeshArgs& a, cg::grid_group& grid, int n) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    __threadfence_system();
    add_release_sys(a.sync + 2, 1);
    for (int c = 0; c + 1 < a.cards; ++c) add_release_sys(a.peer_sync[c] + 2, 1);
    const long long t0 = clock64();
    while (load_acquire_sys(a.sync + 2) < n * a.cards) {
      if (clock64() - t0 > a.spin_cycles) {
        *reinterpret_cast<volatile int*>(a.sync + 1) = kSpinTimeout;
        break;
      }
    }
  }
  grid.sync();
  return *reinterpret_cast<volatile const int*>(a.sync + 1) == 0;
}

// K9's loop over the shares of this card's ranks: (a) every block scans the
// whole stash half i-1 (gathered: this card's shares and the peers'), (b)
// writes its surviving children and flags into this card's arena, the exit
// test, (c) the card's warps pop its ranks' shares of [base, top) and store
// their entries into this card's stash half i and every peer's; a grid
// barrier (and on several cards an exchange) ends the iteration.
template <class Src, bool kS1, int W>
__global__ void __launch_bounds__(kThreads) mesh_chunk_kernel(MeshArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(false, Src::kStream, a.p);
  Warp<Src, kS1, kNodeSlabs<W>> w;
  w.init(smem, l, a.p, false);
  const int s = a.s, Ks = a.Ks, slots = a.ranks * a.Ks;
  const unsigned plane_bytes = round16(8u * a.P * W * s);
  unsigned long long* planes = reinterpret_cast<unsigned long long*>(smem + l.end);
  uint16_t* cmap = reinterpret_cast<uint16_t*>(smem + l.end + plane_bytes);  // [2 slots]
  uint16_t* fmap = cmap + 2 * slots;                                            // [slots]
  int* red = reinterpret_cast<int*>(smem + l.end + plane_bytes + round16(6u * slots));
  for (int i = threadIdx.x; i < a.P * W * s; i += blockDim.x) planes[i] = a.planes[i];

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3, warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + warp, nwarps = gridDim.x * kWarps;
  const int epoch = __ldcg(a.sync);  // this solve's exchanges before this chunk
  int top = a.src_ctr[0];
  if (a.src_T != a.T) {
    const long long nbytes = (long long)top * s;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long vec = nbytes / 16;
    for (long long i = tid; i < vec; i += stride) {
      reinterpret_cast<uint4*>(a.T)[i] = reinterpret_cast<const uint4*>(a.src_T)[i];
      reinterpret_cast<uint4*>(a.D)[i] = reinterpret_cast<const uint4*>(a.src_D)[i];
    }
    for (long long i = 16 * vec + tid; i < nbytes; i += stride) {
      a.T[i] = a.src_T[i];
      a.D[i] = a.src_D[i];
    }
  }
  __syncthreads();
  grid.sync();

  int fcount = 0, iters = 0, popped = 0, pbase = 0, pk = 0, done = 0;
  bool ok = true;
  const int mslots = a.nmine * Ks;
  for (;;) {
    // (a) stash i-1, gathered: the slots of its pk entries.
    const unsigned char* prev = a.stash + ((iters + 1) & 1) * (size_t)slots * (16 * W + 2);
    const int fprev = fcount;
    int nflags = 0;
    if (pk) {
      const int last = pk - 1;
      const int total = scan_stash(ShareCodes<W>{prev, Ks}, (last / a.Kn) * Ks + last % a.Kn + 1, cmap, fmap, red);
      top = pbase + (total & 0xffff);
      nflags = total >> 16;
      fcount = min(fcount + nflags, a.flag_cap);
    }
    const bool go = top > 0 && iters < a.chunk_iters && fcount < a.flag_exit && top <= a.C - 2 * a.K;
    const int k = go ? min(top, a.K) : 0, base = top - k;

    // (b) stash i-1's children that stay on the stack, and its flags, once a card.
    if (pk) {
      const int nw = max(0, base - pbase), nf = max(0, min(nflags, a.flag_cap - fprev));
      for (int t = gwarp; 8 * t < nw; t += nwarps) {
        const int j = 8 * t + g;
        const long long pos = (long long)pbase + j;
        if (j < nw && pos < a.C) {
          Row<W> cT, cD;
          share_child<W>(prev, Ks, cmap[j], cT, cD);
          store_part<W>(a.T + pos * s, cT, s, q);
          store_part<W>(a.D + pos * s, cD, s, q);
        }
      }
      for (int t = gwarp; 8 * t < nf; t += nwarps) {
        const int j = 8 * t + g;
        if (j < nf) store_part<W>(a.flags + (long long)(fprev + j) * s, share_flag<W>(prev, Ks, fmap[j]), s, q);
      }
    }
    if (!go) break;

    // (c) this card's shares: pop, fixpoint, prune, branch, stash.  Ks is a
    // multiple of 8, so a warp's 8 slots lie in one share.
    for (int t = gwarp; 8 * t < mslots; t += nwarps) {
      const int m = 8 * t + g, jr = m / Ks, j = m - jr * Ks, r = __ldg(a.mine + jr), i = r * a.Kn + j;
      const bool valid = j < a.Kn && i < k;
      const int pos = base + i;
      Row<W> myT{}, myD{};
      if (valid && pk && pos >= pbase) {
        share_child<W>(prev, Ks, cmap[pos - pbase], myT, myD);  // whole in each thread of the quad
      } else if (valid) {
        myT = load_part<W>(a.T + (long long)pos * s, s, q);
        myD = load_part<W>(a.D + (long long)pos * s, s, q);
      }
      myT = quad_or(myT);
      myD = quad_or(myD);
      const Row<W> uni = myT | myD;
      Row<W> f1, f2;
      quorums<W>(w, myD, uni, q, lane, f1, f2, [] {});
      const int dsize = popc(myD);
      const bool live = valid && dsize <= a.half && any(uni);
      const bool dq = live && any(f1);
      const Row<W> elig = f2 & ~myD;
      const bool br = live && !dq && any(f2) && !any(myD & ~f2) && any(elig);

      // Branch variable: the largest in-degree within quorum minus
      // dontRemove, the lowest lane on ties (K9's).
      unsigned key = 0;
      if (br) {
        for (int x = q; x < s; x += 4) {
          if (!lane_set(elig, x)) continue;
          int mm = 0;
          for (int b = 0; b < a.P; ++b) mm += popc(f2 & plane_of<W>(planes, b, s, x)) << b;
          key = max(key, ((unsigned)(mm + 1) << 8) | (unsigned)(255 - x));
        }
      }
      key = max(key, __shfl_xor_sync(kFull, key, 1));
      key = max(key, __shfl_xor_sync(kFull, key, 2));
      const int best = key ? 255 - (int)(key & 255u) : 0;
      if (q == 0) {
        const Row<W> child = elig & ~lane_row<W>(best);
        const bool incl = br && dsize + 1 <= a.half;
        const bool excl = br && (popc(child) + dsize) > 0;
        const Row<W> eT = valid ? child : Row<W>{}, eD = valid ? myD : Row<W>{};
        const uint16_t code = valid ? (uint16_t)((int)incl | ((int)excl << 1) | ((int)dq << 2) | (best << 8)) : 0;
        const size_t off = ((size_t)(iters & 1) * a.ranks + r) * share_bytes<W>(Ks);
        for (int c = 0; c < a.cards; ++c) {
          unsigned char* blk = (c ? a.peer_stash[c - 1] : a.stash) + off;
          reinterpret_cast<Row<W>*>(blk)[j] = eT;
          reinterpret_cast<Row<W>*>(blk + 8 * W * (size_t)Ks)[j] = eD;
          reinterpret_cast<uint16_t*>(blk + 16 * W * (size_t)Ks)[j] = code;
        }
      }
    }
    if (a.cards > 1) __threadfence_system();
    grid.sync();
    if (a.cards > 1 && !(ok = exchange(a, grid, epoch + ++done))) break;
    pbase = base;
    pk = k;
    ++iters;
    popped += k;
  }
  // The chunk's last exchange: every card has done its last reads of the
  // stash before any card's next chunk stores into it.
  if (ok && a.cards > 1) {
    grid.sync();
    ok = exchange(a, grid, epoch + ++done);
  }
  if (ok && blockIdx.x == 0 && threadIdx.x == 0) {
    a.ctr[0] = top;
    a.ctr[1] = fcount;
    a.ctr[2] = iters;
    a.ctr[3] = popped;
    a.sync[0] = epoch + done;
  }
}

// K10's leave-one-out rows of a warp's sets in member-major order: position
// p = j kSets + r is set r minus its j-th member, live while set r has more than j
// members (more[j] bit r) and is not yet known not to be minimal.  Fills the
// warp's 16 tile slots with the first live positions from p, 32 positions a
// ballot (each lane tests one, its rank among the live ones a popcount), and
// returns how many it filled; *next is the position after the last.  A set
// has at most 64 W members.
template <int W>
__device__ __forceinline__ int fill_tile(const uint16_t* more, unsigned done, int p, uint16_t* slots, int* next) {
  const int lane = threadIdx.x & 31;
  int filled = 0;
  for (; filled < 16 && p < 64 * W * kSets; p += 32) {
    const int pos = p + lane, j = pos / kSets, r = pos % kSets;
    const bool live = pos < 64 * W * kSets && ((more[j] & ~done) >> r) & 1;
    const unsigned m = __ballot_sync(kFull, live);
    const int rank = filled + __popc(m & ((1u << lane) - 1));
    if (live && rank < 16) {
      slots[rank] = (uint16_t)pos;
      if (rank == 15) *next = pos + 1;
    }
    filled += __popc(m);
  }
  __syncwarp();
  if (filled < 16) *next = p;
  return filled < 16 ? filled : 16;
}

// The row of tile slot x (set r minus its j-th member), 0 past the filled ones.
template <int W>
__device__ __forceinline__ Row<W> slot_row(const Row<W>* sets, const uint16_t* slots, int filled, int x, int* r) {
  *r = -1;
  if (x >= filled) return Row<W>{};
  const int pos = slots[x];
  *r = pos % kSets;
  return drop_nth(sets[*r], pos / kSets);
}

// Bit g of the result: row g of the tile (a ballot's quad lane 4 g).
__device__ __forceinline__ unsigned row_mask(unsigned b) {
  unsigned m = 0;
  for (int g = 0; g < 8; ++g) m |= ((b >> (4 * g)) & 1u) << g;
  return m;
}

template <class Src, bool kS1, int W>
__global__ void __launch_bounds__(kThreads) filter_kernel(FilterArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(true, Src::kStream, a.p);
  Warp<Src, kS1, kNodeSlabs<W>> w;
  w.init(smem, l, a.p, true);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3, warp = threadIdx.x >> 5;
  // A warp's part of the shared memory: its sets, per member index the sets
  // with more members, the tile's slots and the cursor.
  unsigned char* mine = smem + l.end + warp * filter_warp_bytes(W);
  Row<W>* sets = reinterpret_cast<Row<W>*>(mine);
  uint16_t* more = reinterpret_cast<uint16_t*>(mine + 8 * W * kSets);
  uint16_t* slots = more + 64 * W;
  int* cursor = reinterpret_cast<int*>(slots + 16);
  __syncthreads();

  const int s = a.s;
  const Row<W> all = lanes_below<W>(s);
  const int tasks = (a.count + kSets - 1) / kSets;
  // Tasks interleaved over the blocks, so that neighbouring sets (alike in
  // their cost) spread over the SMs.
  for (int t = warp * gridDim.x + blockIdx.x; t < tasks; t += gridDim.x * kWarps) {
    const int n = min(kSets, a.count - kSets * t);  // set kSets t + g in quad g
    const Row<W> d = quad_or(g < n ? load_part<W>(a.flags + (long long)(kSets * t + g) * s, s, q) : Row<W>{});

    // The sets, and per member index j the sets with more than j members.
    __syncwarp();
    if (q == 0) sets[g] = d;
    int size[kSets];
#pragma unroll
    for (int r = 0; r < kSets; ++r) size[r] = r < n ? popc(shfl(d, 4 * r)) : 0;
    for (int j = lane; j < 64 * W; j += 32) {
      unsigned m = 0;
#pragma unroll
      for (int r = 0; r < kSets; ++r) m |= (unsigned)(size[r] > j) << r;
      more[j] = (uint16_t)m;
    }
    __syncwarp();

    // Minimality: the leave-one-out rows in full 16-row tiles under the
    // scoped thresholds; a set with a row that holds a quorum is done.
    unsigned done = 0;
    for (int p = 0; p < 64 * W * kSets;) {
      const int filled = fill_tile<W>(more, done, p, slots, cursor);
      if (!filled) break;
      int ra, rb;
      bool h0, h1;
      if constexpr (W <= 2) {
        uint32_t x0 = word_of(slot_row<W>(sets, slots, filled, g, &ra), q);
        uint32_t x1 = word_of(slot_row<W>(sets, slots, filled, g + 8, &rb), q);
        p = *cursor;
        __syncwarp();
        w.fixpoint(x0, x1, 0u, w.src.thr_q);
        h0 = quad_any(x0 != 0);
        h1 = quad_any(x1 != 0);
      } else {
        const Row<W> r0 = slot_row<W>(sets, slots, filled, g, &ra), r1 = slot_row<W>(sets, slots, filled, g + 8, &rb);
        uint32_t x[4] = {word_of(r0, q), word_of(r1, q), word_of(r0, q + 4), word_of(r1, q + 4)};
        p = *cursor;
        __syncwarp();
        w.fixpoint(x, 0u, w.src.thr_q);
        h0 = quad_any((x[0] | x[2]) != 0);
        h1 = quad_any((x[1] | x[3]) != 0);
      }
      done |= __reduce_or_sync(kFull, (h0 && ra >= 0 ? 1u << ra : 0u) | (h1 && rb >= 0 ? 1u << rb : 0u));
    }
    const unsigned minimal = ((1u << n) - 1) & ~done;

    // The probes of the minimal sets: scc minus D under the probe thresholds.
    unsigned wit = 0;
    if (minimal) {
      bool held;
      if constexpr (W <= 2) {
        uint32_t a0 = word_of((minimal >> g) & 1 ? all & ~d : Row<W>{}, q), a1 = 0;
        w.fixpoint(a0, a1, 0u, w.src.thr_d);
        held = quad_any(a0 != 0);
      } else {
        const Row<W> probe = (minimal >> g) & 1 ? all & ~d : Row<W>{};
        uint32_t x[4] = {word_of(probe, q), 0u, word_of(probe, q + 4), 0u};
        w.fixpoint(x, 0u, w.src.thr_d);
        held = quad_any((x[0] | x[2]) != 0);
      }
      wit = minimal & row_mask(__ballot_sync(kFull, held && q == 0));
    }
    if (lane == 0) {
      atomicAdd(a.out, __popc(minimal));
      if (wit) atomicMin(a.out + 1, kSets * t + __ffs(wit) - 1);
    }
  }
}

template <class Src, bool kS1, int W, bool kTimed = false>
cudaError_t chunk_plan(const ChunkArgs& a, size_t* smem, long long* cap) {
  *smem = make_layout(false, Src::kStream, a.p).end + chunk_extra_bytes(a.s, a.Kp, a.P);
  return resident_blocks<chunk_kernel<Src, kS1, W, kTimed>>(*smem, cap);
}

template <class Src, bool kS1, int W>
cudaError_t chunk_grid(const ChunkArgs& a, int* grid) {
  size_t smem = 0;
  long long cap = 0;
  const cudaError_t err = chunk_plan<Src, kS1, W>(a, &smem, &cap);
  if (err != cudaSuccess) return err;
  const long long want = (a.K + 8 * kWarps - 1) / (8 * kWarps);  // a warp pops 8 states
  *grid = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

template <class Src, bool kS1, int W, bool kTimed = false>
cudaError_t chunk_launch(ChunkArgs& a, int grid, cudaStream_t stream) {
  size_t smem = 0;
  long long cap = 0;
  cudaError_t err = chunk_plan<Src, kS1, W, kTimed>(a, &smem, &cap);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > cap) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)chunk_kernel<Src, kS1, W, kTimed>, dim3(grid), dim3(kThreads),
                                    params, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class Src, bool kS1, int W>
cudaError_t iteration_launch(const IterArgs& a, cudaStream_t stream) {
  const size_t smem = make_layout(false, Src::kStream, a.p).end + chunk_extra_bytes(a.s, a.ranks * a.Ks, a.P);
  long long cap = 0;
  cudaError_t err = resident_blocks<iteration_kernel<Src, kS1, W>>(smem, &cap);
  if (err != cudaSuccess) return err;
  if (cap < 1) return cudaErrorInvalidConfiguration;
  // A warp takes 8 slots of the share; no co-residency needed.
  const int grid = (a.Ks + 8 * kWarps - 1) / (8 * kWarps);
  iteration_kernel<Src, kS1, W><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class Src, bool kS1, int W>
cudaError_t mesh_chunk_launch(MeshArgs& a, cudaStream_t stream) {
  const size_t smem = make_layout(false, Src::kStream, a.p).end + chunk_extra_bytes(a.s, a.ranks * a.Ks, a.P);
  long long cap = 0;
  cudaError_t err = resident_blocks<mesh_chunk_kernel<Src, kS1, W>>(smem, &cap);
  if (err != cudaSuccess) return err;
  // A warp pops 8 slots of this card's shares; every block co-resident.
  const long long want = ((long long)a.nmine * a.Ks + 8 * kWarps - 1) / (8 * kWarps);
  const int grid = (int)(want < cap ? want : cap);
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)mesh_chunk_kernel<Src, kS1, W>, dim3(grid), dim3(kThreads), params,
                                    smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class Src, bool kS1, int W>
cudaError_t filter_launch(const FilterArgs& a, cudaStream_t stream) {
  const size_t smem = make_layout(true, Src::kStream, a.p).end + filter_extra_bytes(a.s);
  long long cap = 0;
  int dev = 0, sms = 0;
  cudaError_t err = resident_blocks<filter_kernel<Src, kS1, W>>(smem, &cap);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // A block an SM at least (the tasks interleave over them), no more blocks
  // than tasks, and no more than the card holds.
  const long long tasks = (a.count + kSets - 1) / kSets;
  long long grid = (tasks + kWarps - 1) / kWarps;
  if (grid < sms) grid = tasks < sms ? tasks : sms;
  if (grid > cap) grid = cap;
  if (grid < 1) return cudaSuccess;
  filter_kernel<Src, kS1, W><<<(int)grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T>
struct Tag {
  using type = T;
};

// f(Tag<Src>, kS1, W), the last two as integral constants, for the instance
// the tables (streamed or resident, one child k-slab or more) and the lanes
// (W = state_words(s) words a state) name; cudaErrorInvalidValue past 256
// lanes.
template <class F>
cudaError_t by_instance(bool stream, int slabs, int s, F&& f) {
  if (s < 1 || s > 256) return cudaErrorInvalidValue;
  auto of = [&](auto w) -> cudaError_t {
    if (stream)
      return slabs <= 1 ? f(Tag<Streamed>{}, std::true_type{}, w) : f(Tag<Streamed>{}, std::false_type{}, w);
    return slabs <= 1 ? f(Tag<Resident>{}, std::true_type{}, w) : f(Tag<Resident>{}, std::false_type{}, w);
  };
  switch (state_words(s)) {
    case 1:
      return of(std::integral_constant<int, 1>{});
    case 2:
      return of(std::integral_constant<int, 2>{});
    case 3:
      return of(std::integral_constant<int, 3>{});
    default:
      return of(std::integral_constant<int, 4>{});
  }
}

Params make_params(const void* blocks, const void* chunks, const int* thr_q, const int* thr_d, int n,
                   int n_units, int units, int depth, int c0, int slabs, int pc, int nblocks) {
  return Params{static_cast<const uint4*>(blocks), static_cast<const int4*>(chunks), thr_q, thr_d, n,
                n_units, units, depth, c0, slabs, pc, nblocks};
}

ChunkArgs chunk_args(const void* blocks, const void* chunks, const int* thr, int n, int n_units, int units,
                     int depth, int c0, int slabs, int pc, int nblocks, int s, int half, int K, int C,
                     int chunk_iters, int flag_cap, int flag_exit, int P, const unsigned long long* planes) {
  ChunkArgs a{};
  a.p = make_params(blocks, chunks, thr, thr, n, n_units, units, depth, c0, slabs, pc, nblocks);
  a.s = s;
  a.half = half;
  a.K = K;
  a.Kp = (K + 7) / 8 * 8;
  a.C = C;
  a.chunk_iters = chunk_iters;
  a.flag_cap = flag_cap;
  a.flag_exit = flag_exit;
  a.P = P;
  a.planes = planes;
  return a;
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The cooperative grid of K9 for these tables, s lanes, K pops and P planes:
// at most the co-resident blocks, a block per 64 popped states.  *cooperative is 0 where the device cannot
// launch cooperatively.  Returns a cudaError_t.
extern "C" int qi_frontier_grid(const void* blocks, const void* chunks, const int* thr, int n,
                                int n_units, int units, int depth, int c0, int slabs, int pc,
                                int nblocks, int stream, int s, int K, int P, int* grid,
                                int* cooperative) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  const ChunkArgs a = chunk_args(blocks, chunks, thr, n, n_units, units, depth, c0, slabs, pc, nblocks, s, 0, K,
                                 0, 0, 0, 0, P, nullptr);
  return by_instance(stream, slabs, s, [&](auto src, auto s1, auto w) {
    return chunk_grid<typename decltype(src)::type, decltype(s1)::value, decltype(w)::value>(a, grid);
  });
}

// One chunk of K9 on `cuda_stream`; with `timing`, the timed instance
// (resident tables, one child slab).  Returns a cudaError_t
// (0 on success).
extern "C" int qi_frontier_chunk(const void* blocks, const void* chunks, const int* thr, int n,
                                 int n_units, int units, int depth, int c0, int slabs, int pc,
                                 int nblocks, int stream, int s, int half, int K, int C,
                                 int chunk_iters, int flag_cap, int flag_exit, int P,
                                 const unsigned long long* planes, const int8_t* src_T, const int8_t* src_D,
                                 const int* src_ctr, int8_t* T, int8_t* D, int8_t* flags, int* ctr,
                                 unsigned long long* st_T, unsigned long long* st_D, uint16_t* st_code,
                                 long long* timing, int grid, void* cuda_stream) {
  ChunkArgs a = chunk_args(blocks, chunks, thr, n, n_units, units, depth, c0, slabs, pc, nblocks, s, half, K, C,
                           chunk_iters, flag_cap, flag_exit, P, planes);
  a.src_T = src_T;
  a.src_D = src_D;
  a.src_ctr = src_ctr;
  a.T = T;
  a.D = D;
  a.flags = flags;
  a.ctr = ctr;
  a.st_T = st_T;
  a.st_D = st_D;
  a.st_code = st_code;
  a.timing = timing;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (timing) {
    if (stream || slabs > 1 || s > 64) return cudaErrorNotSupported;
    return chunk_launch<Resident, true, 1, true>(a, grid, st);
  }
  return by_instance(stream, slabs, s, [&](auto src, auto s1, auto w) {
    return chunk_launch<typename decltype(src)::type, decltype(s1)::value, decltype(w)::value>(a, grid, st);
  });
}

// One iteration of K9's iteration instance for rank `rank` of `ranks` on
// `cuda_stream` (step: the chunk's launches before this one; step 0 reads
// the source arena).  Returns a cudaError_t (0 on success).
extern "C" int qi_frontier_iteration(const void* blocks, const void* chunks, const int* thr, int n,
                                     int n_units, int units, int depth, int c0, int slabs, int pc,
                                     int nblocks, int stream, int s, int half, int K, int C,
                                     int chunk_iters, int flag_cap, int flag_exit, int P,
                                     const unsigned long long* planes, int rank, int ranks, int step,
                                     const int8_t* src_T, const int8_t* src_D, const int* src_ctr, int8_t* T,
                                     int8_t* D, int8_t* flags, int* ctr, unsigned char* stash, int* loop,
                                     void* cuda_stream) {
  if (ranks < 1 || rank < 0 || rank >= ranks || K % ranks || step < 0) return cudaErrorInvalidValue;
  IterArgs a{};
  a.p = make_params(blocks, chunks, thr, thr, n, n_units, units, depth, c0, slabs, pc, nblocks);
  a.s = s;
  a.half = half;
  a.K = K;
  a.C = C;
  a.chunk_iters = chunk_iters;
  a.flag_cap = flag_cap;
  a.flag_exit = flag_exit;
  a.P = P;
  a.planes = planes;
  a.rank = rank;
  a.ranks = ranks;
  a.Kn = K / ranks;
  a.Ks = (a.Kn + 7) / 8 * 8;
  a.step = step;
  a.src_T = src_T;
  a.src_D = src_D;
  a.src_ctr = src_ctr;
  a.T = T;
  a.D = D;
  a.flags = flags;
  a.ctr = ctr;
  a.stash = stash;
  a.loop = loop;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  return by_instance(stream, slabs, s, [&](auto src, auto s1, auto w) {
    return iteration_launch<typename decltype(src)::type, decltype(s1)::value, decltype(w)::value>(a, st);
  });
}

// Peer access from card `dev` to card `peer` (the mesh-chunk instance's
// stores into a peer's stash and counter), enabled once a pair for the
// process.  cudaErrorPeerAccessUnsupported where the pair has no peer path.
// Returns a cudaError_t.
extern "C" int qi_frontier_enable_peer(int dev, int peer) {
  static std::mutex mu;
  static std::set<std::pair<int, int>> enabled;
  std::lock_guard<std::mutex> lock(mu);
  if (enabled.count({dev, peer})) return cudaSuccess;
  int can = 0, was = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return err;
  if (!can) return cudaErrorPeerAccessUnsupported;
  if ((err = cudaGetDevice(&was)) != cudaSuccess || (err = cudaSetDevice(dev)) != cudaSuccess) return err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // enabled before, by this library or by PyTorch's copies
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(was);
  if (err == cudaSuccess) err = back;
  if (err == cudaSuccess) enabled.insert({dev, peer});
  return err;
}

// One chunk of K9's mesh-chunk instance on this card (the current device)
// on `cuda_stream`: the shares of the `nmine` ranks `mine` (a device array)
// of a mesh of `ranks`, `cards` cards in all, the other cards' stashes and
// sync words in the host arrays `peer_stash` and `peer_sync` (cards - 1
// each).  Returns a cudaError_t (0 on success); a spin timeout shows in
// sync[1] once the chunk has run.
extern "C" int qi_frontier_mesh_chunk(const void* blocks, const void* chunks, const int* thr, int n,
                                      int n_units, int units, int depth, int c0, int slabs, int pc,
                                      int nblocks, int stream, int s, int half, int K, int C,
                                      int chunk_iters, int flag_cap, int flag_exit, int P,
                                      const unsigned long long* planes, int ranks, const int* mine, int nmine,
                                      const int8_t* src_T, const int8_t* src_D, const int* src_ctr, int8_t* T,
                                      int8_t* D, int8_t* flags, int* ctr, unsigned char* stash, int* sync,
                                      int cards, unsigned char* const* peer_stash, int* const* peer_sync,
                                      long long spin_cycles, void* cuda_stream) {
  if (ranks < 1 || K % ranks || nmine < 1 || nmine > ranks || cards < 1 || cards > kMaxCards || spin_cycles < 1)
    return cudaErrorInvalidValue;
  MeshArgs a{};
  a.p = make_params(blocks, chunks, thr, thr, n, n_units, units, depth, c0, slabs, pc, nblocks);
  a.s = s;
  a.half = half;
  a.K = K;
  a.C = C;
  a.chunk_iters = chunk_iters;
  a.flag_cap = flag_cap;
  a.flag_exit = flag_exit;
  a.P = P;
  a.planes = planes;
  a.ranks = ranks;
  a.Kn = K / ranks;
  a.Ks = (a.Kn + 7) / 8 * 8;
  a.mine = mine;
  a.nmine = nmine;
  a.src_T = src_T;
  a.src_D = src_D;
  a.src_ctr = src_ctr;
  a.T = T;
  a.D = D;
  a.flags = flags;
  a.ctr = ctr;
  a.stash = stash;
  a.sync = sync;
  a.cards = cards;
  for (int c = 0; c + 1 < cards; ++c) {
    a.peer_stash[c] = peer_stash[c];
    a.peer_sync[c] = peer_sync[c];
  }
  a.spin_cycles = spin_cycles;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  return by_instance(stream, slabs, s, [&](auto src, auto s1, auto w) {
    return mesh_chunk_launch<typename decltype(src)::type, decltype(s1)::value, decltype(w)::value>(a, st);
  });
}

// One flag block of K10 on `cuda_stream`: out[0] += minimal sets, out[1] =
// min(out[1], first witness candidate).  Returns a cudaError_t.
extern "C" int qi_frontier_filter(const void* blocks, const void* chunks, const int* thr_q,
                                  const int* thr_d, int n, int n_units, int units, int depth, int c0,
                                  int slabs, int pc, int nblocks, int stream, int s,
                                  const int8_t* flags, int count, int* out, void* cuda_stream) {
  const FilterArgs a{make_params(blocks, chunks, thr_q, thr_d, n, n_units, units, depth, c0, slabs, pc,
                                 nblocks),
                     s, flags, count, out};
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  return by_instance(stream, slabs, s, [&](auto src, auto s1, auto w) {
    return filter_launch<typename decltype(src)::type, decltype(s1)::value, decltype(w)::value>(a, st);
  });
}
