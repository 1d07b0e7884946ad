// Tensor-core threshold-circuit evaluation for the lane-packed sweeps
// (packed_sweep.cu): one warpgroup (128 threads) evaluates a tile of 64
// candidate rows at once, with the vote counts as matrix products.
//
// A tile's availability is a 64 x lanes 0/1 matrix A; a unit's votes are
//   votes[r][u] = sum_l A[r][l] * members[u][l]  +  sum_c S[r][c] * child[u][c]
// where S holds the satisfaction bits of the child units [c0, units).  Two
// engines compute those products:
//
// - U8: bytes, `wgmma.mma_async m64n32k32 .s32.u8.u8` (sm_90a).  A and S are
//   byte tiles in shared memory; the member and child tables are K-major
//   32 x 32 byte blocks (unit x lane, unit x child), so vote counts up to 255
//   multiply exactly.  Only the blocks a chunk multiplies are stored, chunk
//   after chunk (`Params::first`).  Tables that do not fit one block's shared
//   memory are streamed through a two-stage cp.async ring, a block at a time.
// - B1: bits, `mma.sync m16n8k128 .s32.b1.b1.s32.and.popc`: A and S are
//   uint32 words (LSB-first), the tables `bitset_encode`'s word rows, and a
//   product is sum_w popc(A_w & table_w) — the 0/1 votes of the bitset
//   encoding.
//
// Units are taken 32 at a time (an N-chunk).  For each chunk the host names
// the k-slabs (32 lanes for U8, 128 for B1) where the chunk's member and
// child columns are nonzero (`Params::range`); the packed circuit is block
// diagonal, so a chunk of one group's units issues only that group's slabs.
//
// Both engines share the layout of the accumulators: thread t of the
// warpgroup holds, for n8 block j and v0, v1 in {0, 1}, the vote of row
// 16 * (t / 32) + (t % 32) / 4 + 8 * v1 and unit 8 * j + 2 * (t % 4) + v0 of the
// chunk, in acc[4 * j + 2 * v1 + v0].  The epilogue compares each vote with
// its threshold (signed int32: thresholds may be <= 0 after the restriction
// fold) and writes the satisfaction from the fragments: U8 as two bytes per
// thread and n8 block, B1 as a row word gathered across the four threads of
// a quad.
//
// A fixpoint pass is the JAX `node_sat`: `depth` passes over the chunks of
// the child units (the first without child votes), then one over the chunks
// of the lanes, whose satisfaction, ANDed with the availability (the Q4
// conjunct), is the next availability.  The child passes update S in place,
// chunk after chunk: a chunk may then read some child bits one pass early.
// That is exact, because each pass only raises bits towards the true
// satisfaction (the first pass takes every child as unsatisfied), never past
// it, and `depth` passes reach it.  The tile repeats passes until no row
// changed: rows that are already stable do not change under another pass.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qi_mma {

constexpr int kRows = 64;       // rows of a tile: the wgmma M
constexpr int kThreads = 128;   // one warpgroup
constexpr int kChunk = 32;      // units per N-chunk
constexpr int kMaxGroups = 16;
constexpr int kMaxLanes = 128;
constexpr int kMaxChunks = 32;  // 1024 units
constexpr int kLaneWords = kMaxLanes / 32;
constexpr int kMiss = 0x7fffffff;
// wgmma shared-memory descriptors, no swizzle, K-major: core matrices of 8
// rows x 16 bytes; the two of a 32-byte k-slab 128 bytes apart (LBO), the
// next 8 rows 256 bytes on (SBO).
constexpr int kLbo = 128;
constexpr int kSbo = 256;

struct Params {
  int k;                       // lane groups
  int start[kMaxGroups];       // per-group candidate of row 0
  int base[kMaxGroups];        // lane of the group's enumeration bit 0
  int bits[kMaxGroups];        // enumerated lanes of the group (<= 30)
  uint32_t gmask[kMaxGroups][kLaneWords];  // the group's lanes
  uint32_t scc[kLaneWords];    // every real lane
  int lanes;                   // lanes, a multiple of 32 (<= 128)
  int units;                   // units, a multiple of 32 (<= 1024)
  int c0;                      // first child unit, a multiple of 32
  int kcols;                   // child columns [c0, c0 + kcols)
  int depth;                   // child passes per fixpoint pass
  unsigned mbytes, cbytes;     // the tables' sizes
  uint8_t range[kMaxChunks][4];  // per chunk: member slabs [0, 1), child slabs [2, 3)
  uint16_t first[kMaxChunks][2];  // U8: per chunk, its first member / child block
};

__host__ __device__ inline unsigned round_up(unsigned x, unsigned m) { return (x + m - 1) / m * m; }

// Byte offset of element (r, k) of a K-major byte matrix of R rows (R a
// multiple of 8) in the slab-blocked core-matrix layout: k-slab by k-slab,
// each slab R rows x 32 bytes.  The host builds the tables in this layout
// (kernels/packed_cuda.py `u8_blocks`).
__host__ __device__ inline unsigned blk_off(unsigned r, unsigned k, unsigned R) {
  return (k / 32) * (R * 32) + (r / 8) * 256 + ((k / 16) & 1) * 128 + (r % 8) * 16 + (k % 16);
}

// Shared memory of one block: tables (resident instances), two availability
// tiles, the child-satisfaction tile, the streaming ring, thresholds.
struct Layout {
  unsigned mtab, ctab, a0, a1, s, stage, thr_q, thr_d, end;
};

__host__ __device__ inline Layout make_layout(bool b1, bool stream, const Params& p) {
  Layout l;
  unsigned at = 0;
  auto take = [&](unsigned bytes) {
    const unsigned here = at;
    at = round_up(at + bytes, 1024);
    return here;
  };
  l.mtab = take(stream ? 0 : p.mbytes);
  l.ctab = take(stream ? 0 : p.cbytes);
  l.a0 = take(b1 ? kRows * 16 : kRows * p.lanes);
  l.a1 = take(b1 ? kRows * 16 : kRows * p.lanes);
  l.s = take(b1 ? kRows * p.kcols / 8 : kRows * p.kcols);
  l.stage = take(stream ? 2 * 1024 : 0);
  l.thr_q = take(4 * p.units);
  l.thr_d = take(4 * p.units);
  l.end = at;
  return l;
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void keep(int (&acc)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

// The chunk's satisfaction bits as row words: thread t gets the words of
// rows 16 (t / 32) + (t % 32) / 4 (w0) and that + 8 (w1); `thr` holds the
// chunk's 32 thresholds.
__device__ __forceinline__ void sat_words(const int (&acc)[16], const int* thr, uint32_t& w0,
                                          uint32_t& w1) {
  const int q = threadIdx.x & 3;
  w0 = w1 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int v0 = 0; v0 < 2; ++v0) {
      const int col = 8 * j + 2 * q + v0;
      const int t = thr[col];
      w0 |= (uint32_t)(acc[4 * j + v0] >= t) << col;
      w1 |= (uint32_t)(acc[4 * j + 2 + v0] >= t) << col;
    }
  }
  w0 |= __shfl_xor_sync(0xffffffffu, w0, 1);
  w0 |= __shfl_xor_sync(0xffffffffu, w0, 2);
  w1 |= __shfl_xor_sync(0xffffffffu, w1, 1);
  w1 |= __shfl_xor_sync(0xffffffffu, w1, 2);
}

// ---- U8: wgmma over byte tiles ---------------------------------------------

__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_u8(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 32 bytes of 0/1 (a row's lanes [32 seg, 32 seg + 32)) <-> one word.
__device__ __forceinline__ uint32_t bytes_to_bits(uint32_t x) {
  return (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
}
__device__ __forceinline__ uint32_t bits_to_bytes(uint32_t n) {
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

template <bool kStreamed>
struct U8 {
  using T = uint8_t;
  static constexpr bool kB1 = false;
  static constexpr bool kStream = kStreamed;
  const uint8_t* mtab;  // shared (resident) or global (streamed)
  const uint8_t* ctab;
  uint8_t* stage;       // streamed: two 1 KB blocks

  __device__ void init(const void* m, const void* c, void* st) {
    mtab = static_cast<const uint8_t*>(m);
    ctab = static_cast<const uint8_t*>(c);
    stage = static_cast<uint8_t*>(st);
  }

  // A tile is addressed by (row, 32-lane word); `stride` is unused.
  __device__ __forceinline__ static uint32_t load_word(const uint8_t* t, int /*stride*/, int r,
                                                       int seg) {
    const uint4 lo = *reinterpret_cast<const uint4*>(t + blk_off(r, 32 * seg, kRows));
    const uint4 hi = *reinterpret_cast<const uint4*>(t + blk_off(r, 32 * seg + 16, kRows));
    const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) w |= bytes_to_bits(v[i]) << (4 * i);
    return w;
  }
  __device__ __forceinline__ static void store_word(uint8_t* t, int /*stride*/, int r, int seg,
                                                    uint32_t w) {
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = bits_to_bytes((w >> (4 * i)) & 15u);
    *reinterpret_cast<uint4*>(t + blk_off(r, 32 * seg, kRows)) = make_uint4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(t + blk_off(r, 32 * seg + 16, kRows)) =
        make_uint4(v[4], v[5], v[6], v[7]);
  }

  // The epilogue writes bytes straight from the accumulators: thread t
  // holds rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8, and per n8
  // block j two adjacent units 8 j + 2 (t % 4) + {0, 1}, one 16-bit access
  // each (the accumulators are indexed by unrolled constants only).
  __device__ __forceinline__ static uint16_t sat_pair(const int (&acc)[16], int i, const int* thr,
                                                      int col) {
    return (uint16_t)((acc[i] >= thr[col]) | ((acc[i + 1] >= thr[col + 1]) << 8));
  }

  // Satisfaction of the chunk's units into S columns [col0, col0 + 32).
  __device__ __forceinline__ static void store_sat(uint8_t* s, int /*stride*/, int col0,
                                                   const int (&acc)[16], const int* thr) {
    const int lane = threadIdx.x & 31;
    const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v1 = 0; v1 < 2; ++v1)
        *reinterpret_cast<uint16_t*>(s + blk_off(r0 + 8 * v1, col0 + 8 * j + cq, kRows)) =
            sat_pair(acc, 4 * j + 2 * v1, thr, 8 * j + cq);
  }

  // nxt = sat & cur on lanes [32 c, 32 c + 32); true if a byte changed.
  __device__ __forceinline__ static bool update_avail(const uint8_t* cur, uint8_t* nxt, int c,
                                                      const int (&acc)[16], const int* thr) {
    const int lane = threadIdx.x & 31;
    const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), cq = 2 * (lane & 3);
    bool changed = false;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v1 = 0; v1 < 2; ++v1) {
        const unsigned off = blk_off(r0 + 8 * v1, kChunk * c + 8 * j + cq, kRows);
        const uint16_t old = *reinterpret_cast<const uint16_t*>(cur + off);
        const uint16_t v = old & sat_pair(acc, 4 * j + 2 * v1, thr, 8 * j + cq);
        *reinterpret_cast<uint16_t*>(nxt + off) = v;
        changed |= v != old;
      }
    return changed;
  }

  // Votes of chunk c: member slabs over tile `a`, child slabs over tile `s`.
  __device__ __forceinline__ void votes(int (&acc)[16], const uint8_t* a, const uint8_t* s,
                                        int /*s_stride*/, int c, bool kids, const Params& p) const {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0;
    const int m0 = p.range[c][0], m1 = p.range[c][1];
    const int k0 = kids ? p.range[c][2] : 0, k1 = kids ? p.range[c][3] : 0;
    if (m0 >= m1 && k0 >= k1) return;
    // The host stores only the named blocks, chunk after chunk.
    const uint8_t* mrow = mtab + ((long long)p.first[c][0] - m0) * 1024;
    const uint8_t* crow = ctab + ((long long)p.first[c][1] - k0) * 1024;
    if (!kStream) {
      keep(acc);
      wgmma_fence();
      for (int x = m0; x < m1; ++x) wgmma_u8(acc, smem_desc(a + x * 2048), smem_desc(mrow + x * 1024));
      for (int x = k0; x < k1; ++x) wgmma_u8(acc, smem_desc(s + x * 2048), smem_desc(crow + x * 1024));
      wgmma_commit();
      wgmma_wait();
      keep(acc);
      return;
    }
    // Streamed: block j of the chunk's list (member slabs, then child
    // slabs) lands in stage j % 2 while block j - 1 multiplies.  Every warp
    // reads the whole stage as B, and a warp's `wgmma_wait` covers only its
    // own part of the product, so a stage is refilled only after a barrier
    // that every warp reaches past its wait: block j + 1 is fetched after
    // step j's barrier, which follows every wait on block j - 1 (the stage
    // block j + 1 takes), and block 0 after one that follows the previous
    // call's last product.  (The A and S tiles need no such barrier: a warp
    // writes only the 16 rows of its own accumulators.)
    const int nm = m1 > m0 ? m1 - m0 : 0;
    const int n = nm + (k1 > k0 ? k1 - k0 : 0);
    auto src = [&](int j) { return j < nm ? mrow + (m0 + j) * 1024 : crow + (k0 + j - nm) * 1024; };
    auto fetch = [&](int j) {
      if (threadIdx.x < 64)
        cp_async16(stage + (j & 1) * 1024 + 16 * threadIdx.x, src(j) + 16 * threadIdx.x);
      cp_async_commit();
    };
    __syncthreads();
    fetch(0);
    for (int j = 0; j < n; ++j) {
      cp_async_wait<0>();  // this thread's part of block j
      fence_async_smem();
      __syncthreads();  // every part of block j; every warp past block j - 1's product
      if (j + 1 < n) fetch(j + 1);
      const uint8_t* at = j < nm ? a + (m0 + j) * 2048 : s + (k0 + j - nm) * 2048;
      keep(acc);
      wgmma_fence();
      wgmma_u8(acc, smem_desc(at), smem_desc(stage + (j & 1) * 1024));
      wgmma_commit();
      wgmma_wait();
      keep(acc);
    }
  }
};

// ---- B1: mma.sync and.popc over bit tiles ----------------------------------

__device__ __forceinline__ void mma_b1(int* d, uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

struct B1 {
  using T = uint32_t;
  static constexpr bool kB1 = true;
  static constexpr bool kStream = false;
  const uint32_t* mtab;  // shared: [units][4] words
  const uint32_t* ctab;  // shared: [units][kcols / 32] words

  __device__ void init(const void* m, const void* c, void*) {
    mtab = static_cast<const uint32_t*>(m);
    ctab = static_cast<const uint32_t*>(c);
  }

  __device__ __forceinline__ static uint32_t load_word(const uint32_t* t, int stride, int r, int seg) {
    return t[r * stride + seg];
  }
  __device__ __forceinline__ static void store_word(uint32_t* t, int stride, int r, int seg,
                                                    uint32_t w) {
    t[r * stride + seg] = w;
  }

  // The epilogue gathers a row's 32 bits across a quad (sat_words); one
  // thread of the quad stores each of its two rows' words.
  __device__ __forceinline__ static void store_sat(uint32_t* s, int stride, int col0,
                                                   const int (&acc)[16], const int* thr) {
    uint32_t w0, w1;
    sat_words(acc, thr, w0, w1);
    const int q = threadIdx.x & 3;
    const int row = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + (q == 1 ? 8 : 0);
    if (q < 2) s[row * stride + col0 / 32] = q ? w1 : w0;
  }

  __device__ __forceinline__ static bool update_avail(const uint32_t* cur, uint32_t* nxt, int c,
                                                      const int (&acc)[16], const int* thr) {
    uint32_t w0, w1;
    sat_words(acc, thr, w0, w1);
    const int q = threadIdx.x & 3;
    const int row = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + (q == 1 ? 8 : 0);
    if (q >= 2) return false;
    const uint32_t old = cur[row * kLaneWords + c], v = (q ? w1 : w0) & old;
    nxt[row * kLaneWords + c] = v;
    return v != old;
  }

  __device__ __forceinline__ void votes(int (&acc)[16], const uint32_t* a, const uint32_t* s,
                                        int s_stride, int c, bool kids, const Params& p) const {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int r0 = 16 * (threadIdx.x >> 5) + g;
    const int m0 = p.range[c][0], m1 = p.range[c][1];
    const int k0 = kids ? p.range[c][2] : 0, k1 = kids ? p.range[c][3] : 0;
    for (int x = m0; x < m1; ++x) {
      const uint32_t a0 = a[r0 * kLaneWords + 4 * x + q], a1 = a[(r0 + 8) * kLaneWords + 4 * x + q];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_b1(acc + 4 * j, a0, a1, mtab[(kChunk * c + 8 * j + g) * kLaneWords + 4 * x + q]);
    }
    for (int x = k0; x < k1; ++x) {
      const uint32_t a0 = s[r0 * s_stride + 4 * x + q], a1 = s[(r0 + 8) * s_stride + 4 * x + q];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_b1(acc + 4 * j, a0, a1, ctab[(kChunk * c + 8 * j + g) * s_stride + 4 * x + q]);
    }
  }
};

// ---- shared tile logic --------------------------------------------------------

template <class E>
struct Tile {
  using T = typename E::T;
  E e;
  T* a[2];     // availability tiles
  T* s;        // child satisfaction tile
  int s_stride;  // words per row of s (B1)
  const Params* p;

  // Greatest fixpoint of tile a[cur] under `thr`; returns the tile that
  // holds it.
  __device__ int fixpoint(int cur, const int* thr) {
    const Params& P = *p;
    for (;;) {
      int acc[16];
      for (int i = 0; i < P.depth; ++i) {
        for (int c = P.c0 / kChunk; c < P.units / kChunk; ++c) {
          e.votes(acc, a[cur], s, s_stride, c, i > 0, P);
          E::store_sat(s, s_stride, kChunk * c - P.c0, acc, thr + kChunk * c);
          fence_async_smem();
          __syncthreads();
        }
      }
      int changed = 0;
      for (int c = 0; c < P.lanes / kChunk; ++c) {
        e.votes(acc, a[cur], s, s_stride, c, P.depth > 0, P);
        changed |= E::update_avail(a[cur], a[cur ^ 1], c, acc, thr + kChunk * c);
      }
      fence_async_smem();
      changed = __syncthreads_or(changed);
      cur ^= 1;
      if (!changed) return cur;
    }
  }

  // Fills tile t from f(row, seg) -> 32-lane word; true if any bit is set.
  template <class F>
  __device__ bool fill(T* t, F f) {
    const int segs = p->lanes / 32;
    int any = 0;
    for (int i = threadIdx.x; i < kRows * segs; i += kThreads) {
      const int r = i % kRows, seg = i / kRows;
      const uint32_t w = f(r, seg);
      E::store_word(t, kLaneWords, r, seg, w);
      any |= w != 0;
    }
    fence_async_smem();
    return __syncthreads_or(any);
  }

  // Per row, the groups with a lane set in tile t: part[0][r] | part[1][r].
  __device__ bool group_rows(const T* t, uint32_t (*part)[kRows]) {
    const int r = threadIdx.x % kRows, half = threadIdx.x / kRows;
    uint32_t m = 0;
    for (int seg = half; seg < p->lanes / 32; seg += 2) {
      const uint32_t w = E::load_word(t, kLaneWords, r, seg);
      for (int g = 0; g < p->k; ++g)
        if (w & p->gmask[g][seg]) m |= 1u << g;
    }
    part[half][r] = m;
    return __syncthreads_or(m != 0);
  }
};

// Lanes [base, base + bits) of the 32-lane word `seg` take the low bits of v.
__device__ __forceinline__ uint32_t place(uint64_t v, int base, int seg) {
  const int s = base - 32 * seg;
  if (s >= 0) return s < 32 ? (uint32_t)(v << s) : 0u;
  return -s < 64 ? (uint32_t)(v >> -s) : 0u;
}

}  // namespace qi_mma
