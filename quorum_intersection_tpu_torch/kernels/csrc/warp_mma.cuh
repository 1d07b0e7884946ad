// Warp-level tensor-core threshold-circuit evaluation for the fused sweep
// and the block guard (sweep.cu, guard.cu).
//
// A warp evaluates 16 candidate rows at once, from their first availability
// to their fixpoint, with every per-row value in registers and no barrier
// between warps.  A row's availability (n <= 64 nodes) is the A operand of
// `mma.sync m16n8k128 .row.col .s32.b1.b1.s32.and.popc`: thread t of the warp
// (g = t / 4, q = t % 4) holds word q (nodes [32 q, 32 q + 32)) of rows g and
// g + 8, so only threads q = 0, 1 hold nonzero words.  (The frontier's
// kernels, frontier.cu, take rows of up to 256 nodes: up to 128, the whole
// k-slab, every thread of a quad holds a word; past it a row spans two node
// k-slabs, and thread t also holds word q of slab 1, nodes [128 + 32 q,
// 160 + 32 q), of rows g and g + 8: `Warp`'s kNS.)  A unit's votes
//   votes[r][u] = sum_b 2^b (popc(A[r] & members_b[u]) + popc(S[r] & child_b[u]))
// are and-popc products over bit-planes b (vote count c = sum_b 2^b c_b), taken
// highest plane first (Horner: the sum doubles between planes), so any vote
// multiplicity below 2^8 stays exact; S holds the satisfaction bits of the
// child units [c0, units) in 128-column k-slabs.
//
// Units are taken 32 at a time (a chunk, four n8 blocks).  The host stores,
// per chunk and in the order a pass reads them, one table block per member
// plane and node k-slab (one slab: n <= 128; two for the frontier's rows
// past it, slab 0 then slab 1 for each plane, so a plane's products
// accumulate into one sum and Horner is unchanged) and one per child plane
// and child k-slab that holds a nonzero column of the chunk
// (`Params::chunks`: the first block, the member blocks, the child slabs
// [k0, k1)).  A block is 32 lanes x 4 words:
// lane t's word j is the B fragment of n8 block j, the word q of unit
// 32 c + 8 j + g's slab (kernels/sweep_cuda.py `frag_blocks`), so a warp
// reads a block with one conflict-free 16-byte access a thread.  The
// accumulators follow the m16n8 layout: acc[4 j + 2 v1 + v0] is row g + 8 v1,
// unit 32 c + 8 j + 2 q + v0 (the mapping K4's b1 tile proved on the card,
// circuit_mma.cuh).
//
// The epilogue stays in registers.  Each sum starts at the unit's negated
// threshold (signed int32: thresholds may be <= 0 after the restriction
// fold), so a unit is satisfied where its accumulator is >= 0; the n8 blocks
// past the last real unit are skipped.  Each thread sets its bits, the quad
// ORs them into the chunk's row words (two shuffles a row), and the thread
// whose q names the word keeps it: as the next availability (root chunk c
// is word c & 3 of node slab c >> 2, kept by thread q = c & 3, ANDed with
// the availability: the Q4 conjunct) or as its word of S.  So every thread
// reads back only what it wrote itself, and S, in registers for one k-slab
// and in a per-thread shared slot otherwise, needs no synchronisation
// either.  The child passes update S in place, chunk after chunk: a chunk
// may read some child bits one pass early, which only raises them towards
// the true satisfaction (the first pass takes every child as unsatisfied),
// never past it, so `depth` passes stay exact.  The fixpoint repeats passes until `__any_sync` says no row of the
// warp changed.
//
// Tables live in shared memory where they fit (`Resident`); otherwise each
// thread streams its 16 bytes of the blocks a pass reads through its own
// kStages-deep cp.async ring (`Streamed`), in the order the pass reads them.
// A thread refills only the ring slot it read itself one block earlier, so
// the ring needs no barrier either; the chunk list and thresholds are then
// read through the read-only cache.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace qi_warp {

constexpr int kWarps = 8;               // warps per block, sharing the tables
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;               // rows a warp evaluates at once: the mma M
constexpr int kChunk = 32;              // units per chunk: four n8 blocks
constexpr int kStages = 4;              // streamed: blocks in flight per thread
constexpr int kMiss = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const uint4* blocks;  // [nblocks][32 lanes] table blocks
  const int4* chunks;   // [units / 32]: first block, member blocks, child slabs k0, k1
  const int* thr_q;     // [units] negated signed thresholds
  const int* thr_d;     // [units] the D probe's, negated (the guard passes thr_q)
  int n;                // nodes (<= 64; <= 256, two node k-slabs, for the frontier)
  int n_units;          // real units
  int units;            // units padded to a chunk
  int depth;            // child passes per fixpoint pass
  int c0;               // first child column, a multiple of 32
  int slabs;            // child k-slabs of S
  int pc;               // child bit-planes
  int nblocks;
};

__host__ __device__ inline unsigned round16(unsigned x) { return (x + 15u) & ~15u; }

// Shared memory of one block; kernels/sweep_cuda.py `smem_bytes` mirrors it.
struct Layout {
  unsigned decode, blocks, chunks, thr_q, thr_d, ring, s, end;
};

__host__ __device__ inline Layout make_layout(bool sweep, bool stream, const Params& p) {
  Layout l;
  unsigned at = 0;
  auto take = [&](unsigned bytes) {
    const unsigned here = at;
    at = round16(at + bytes);
    return here;
  };
  l.decode = take(sweep ? 8u * 4 * 256 : 0);
  l.blocks = take(stream ? 0 : 512u * p.nblocks);
  l.chunks = take(stream ? 0 : 16u * (p.units / kChunk));
  l.thr_q = take(stream ? 0 : 4u * p.units);
  l.thr_d = take(stream || !sweep ? 0 : 4u * p.units);
  l.ring = take(stream ? 512u * kStages * kWarps : 0);
  l.s = take(p.slabs > 1 ? 256u * p.slabs * kWarps : 0);
  l.end = at;
  return l;
}

__device__ __forceinline__ void mma_b1(int* d, uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
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

// Word q (nodes [32 q, 32 q + 32)) of a 64-bit node row.
__device__ __forceinline__ uint32_t word_of(uint64_t row, int q) {
  return q < 2 ? (uint32_t)(row >> (32 * q)) : 0u;
}

// Word q of a 128-bit node row (the frontier's states past 64 lanes; x the
// lower 64 nodes): all four threads of a quad hold a word.
__device__ __forceinline__ uint32_t word_of(ulonglong2 row, int q) {
  return (uint32_t)((q < 2 ? row.x : row.y) >> (32 * (q & 1)));
}

__device__ __forceinline__ bool quad_any(bool x) {
  unsigned v = x;
  v |= __shfl_xor_sync(kFull, v, 1);
  v |= __shfl_xor_sync(kFull, v, 2);
  return v != 0;
}

// Tables copied into shared memory once per block.
struct Resident {
  static constexpr bool kStream = false;
  const uint4* blocks;
  const int4* chunks;
  const int* thr_q;
  const int* thr_d;
  int lane;

  __device__ void init(unsigned char* smem, const Layout& l, const Params& p, bool sweep) {
    uint4* b = reinterpret_cast<uint4*>(smem + l.blocks);
    int4* c = reinterpret_cast<int4*>(smem + l.chunks);
    int* tq = reinterpret_cast<int*>(smem + l.thr_q);
    int* td = sweep ? reinterpret_cast<int*>(smem + l.thr_d) : tq;
    for (int i = threadIdx.x; i < 32 * p.nblocks; i += blockDim.x) b[i] = p.blocks[i];
    for (int i = threadIdx.x; i < p.units / kChunk; i += blockDim.x) c[i] = p.chunks[i];
    for (int i = threadIdx.x; i < p.units; i += blockDim.x) {
      tq[i] = p.thr_q[i];
      if (sweep) td[i] = p.thr_d[i];
    }
    blocks = b;
    chunks = c;
    thr_q = tq;
    thr_d = td;
    lane = threadIdx.x & 31;
  }
  __device__ __forceinline__ int4 chunk(int c) const { return chunks[c]; }
  __device__ __forceinline__ int2 thr2(const int* t, int u) const {
    return *reinterpret_cast<const int2*>(t + u);
  }
  __device__ __forceinline__ void begin(int, int, bool) {}
  __device__ __forceinline__ uint4 next(int idx) { return blocks[idx * 32 + lane]; }
};

// Tables left in device memory; each thread streams its part of the blocks a
// pass reads through its own ring (see the header comment).
struct Streamed {
  static constexpr bool kStream = true;
  const uint4* blocks;
  const int4* chunks;
  const int* thr_q;
  const int* thr_d;
  uint4* ring;  // this thread's slot of stage 0; stage s at ring[32 s]
  int lane, pc;
  int fc, fc_hi, fi, fn, ffirst;  // the fetch cursor: chunk, block in it, its count and first
  bool fkids;
  int head, tail;  // blocks read, blocks fetched (committed groups) in this pass

  __device__ void init(unsigned char* smem, const Layout& l, const Params& p, bool sweep) {
    blocks = p.blocks;
    chunks = p.chunks;
    thr_q = p.thr_q;
    thr_d = sweep ? p.thr_d : p.thr_q;
    lane = threadIdx.x & 31;
    pc = p.pc;
    ring = reinterpret_cast<uint4*>(smem + l.ring) + (threadIdx.x >> 5) * 32 * kStages + lane;
  }
  __device__ __forceinline__ int4 chunk(int c) const { return __ldg(chunks + c); }
  __device__ __forceinline__ int2 thr2(const int* t, int u) const {
    return __ldg(reinterpret_cast<const int2*>(t + u));
  }
  // Moves the fetch cursor to the next block of the pass, if any.
  __device__ __forceinline__ void advance() {
    while (fi >= fn && ++fc < fc_hi) {
      const int4 m = chunk(fc);
      ffirst = m.x;
      fn = m.y + (fkids ? pc * (m.w - m.z) : 0);
      fi = 0;
    }
  }
  // Fetches the next block of the pass into the slot read one block ago (by
  // this thread, into a register an mma has consumed since), or commits an
  // empty group past the pass's end, so the group count stays in step.
  __device__ __forceinline__ void push() {
    if (fc < fc_hi) {
      cp_async16(ring + 32 * (tail % kStages), blocks + (ffirst + fi) * 32 + lane);
      ++fi;
      advance();
    }
    cp_async_commit();
    ++tail;
  }
  __device__ __forceinline__ void begin(int c_lo, int c_hi, bool kids) {
    fc = c_lo - 1;
    fc_hi = c_hi;
    fkids = kids;
    fi = fn = 0;
    advance();
    head = tail = 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) push();
  }
  __device__ __forceinline__ uint4 next(int) {
    cp_async_wait<kStages - 2>();  // this thread's part of block `head` has landed
    const uint4 v = ring[32 * (head % kStages)];
    ++head;
    push();
    return v;
  }
};

// One warp's evaluator over table source Src; kS1: S fits one k-slab and
// lives in two registers; kNS: the node k-slabs of an availability row (1 up
// to 128 nodes; 2, the frontier's rows of 129-256 nodes).  A thread's words
// of rows g and g + 8 are a[2 x] and a[2 x + 1], x the node slab.
template <class Src, bool kS1, int kNS = 1>
struct Warp {
  static_assert(kNS == 1 || kNS == 2, "an availability row spans one or two node k-slabs");
  Src src;
  Params p;
  uint2* s_slot;  // !kS1: this thread's S word pair of slab x at s_slot[32 x]
  uint32_t s0, s1;
  int q;

  __device__ void init(unsigned char* smem, const Layout& l, const Params& params, bool sweep) {
    p = params;
    src.init(smem, l, p, sweep);
    const int lane = threadIdx.x & 31;
    q = lane & 3;
    s_slot = reinterpret_cast<uint2*>(smem + l.s) + (threadIdx.x >> 5) * 32 * p.slabs + lane;
    s0 = s1 = 0;
  }

  __device__ __forceinline__ uint2 s_get(int x) const {
    if (kS1) return make_uint2(s0, s1);
    return s_slot[32 * x];
  }
  __device__ __forceinline__ void s_put(int x, uint32_t w0, uint32_t w1) {
    if (kS1) {
      s0 = w0;
      s1 = w1;
    } else {
      s_slot[32 * x] = make_uint2(w0, w1);
    }
  }

  __device__ __forceinline__ static void mma4(int (&acc)[16], uint32_t a0, uint32_t a1, uint4 b,
                                              int nb) {
    const uint32_t w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nb) mma_b1(acc + 4 * j, a0, a1, w[j]);
  }
  // One member plane's products: a block a node slab, into one sum.
  __device__ __forceinline__ void member_plane(int (&acc)[16], const uint32_t (&t)[2 * kNS], int& idx, int nb) {
#pragma unroll
    for (int x = 0; x < kNS; ++x) mma4(acc, t[2 * x], t[2 * x + 1], src.next(idx++), nb);
  }
  __device__ __forceinline__ static void twice(int (&acc)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] <<= 1;
  }

  // Votes less thresholds of chunk c's units for rows g and g + 8 (t: this
  // thread's words of their availability; nthr: the negated thresholds), in
  // the n8 blocks below nb (those that hold a real unit).  Starting the sum
  // at the negated threshold leaves the compare a sign test.
  __device__ __forceinline__ void votes(int (&acc)[16], int c, int nb, bool kids, const uint32_t (&t)[2 * kNS],
                                        const int* nthr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int2 th = j < nb ? src.thr2(nthr, kChunk * c + 8 * j + 2 * q) : make_int2(0, 0);
      acc[4 * j] = acc[4 * j + 2] = th.x;
      acc[4 * j + 1] = acc[4 * j + 3] = th.y;
    }
    const int4 m = src.chunk(c);
    kids = kids && m.z < m.w;
    int idx = m.x;
    if (m.y == kNS) {
      member_plane(acc, t, idx, nb);
    } else if (m.y > kNS) {
      int h[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) h[i] = 0;
      for (int i = 0; i < m.y; i += kNS) {  // member planes, the highest first
        if (i) twice(h);
        member_plane(h, t, idx, nb);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += h[i];
    }
    if (!kids) return;
    if (p.pc == 1) {
      for (int x = m.z; x < m.w; ++x) {
        const uint2 s = s_get(x);
        mma4(acc, s.x, s.y, src.next(idx++), nb);
      }
      return;
    }
    int h[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) h[i] = 0;
    for (int b = 0; b < p.pc; ++b) {  // child planes, the highest first
      if (b) twice(h);
      for (int x = m.z; x < m.w; ++x) {
        const uint2 s = s_get(x);
        mma4(h, s.x, s.y, src.next(idx++), nb);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += h[i];
  }

  // The chunk's satisfaction (votes at or above threshold: acc >= 0) as row
  // words, w0 of row g and w1 of row g + 8, in every thread of the quad.
  __device__ __forceinline__ void sat(const int (&acc)[16], int nb, uint32_t& w0, uint32_t& w1) const {
    w0 = w1 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nb) {
        const int col = 8 * j + 2 * q;
        w0 |= ((uint32_t)(acc[4 * j] >= 0) | ((uint32_t)(acc[4 * j + 1] >= 0) << 1)) << col;
        w1 |= ((uint32_t)(acc[4 * j + 2] >= 0) | ((uint32_t)(acc[4 * j + 3] >= 0) << 1)) << col;
      }
    }
    w0 |= __shfl_xor_sync(kFull, w0, 1);
    w0 |= __shfl_xor_sync(kFull, w0, 2);
    w1 |= __shfl_xor_sync(kFull, w1, 1);
    w1 |= __shfl_xor_sync(kFull, w1, 2);
  }

  // n8 blocks of chunk c that hold a real unit.
  __device__ __forceinline__ int blocks_of(int c) const { return min(4, (p.n_units - kChunk * c + 7) / 8); }

  // Greatest fixpoint of rows g and g + 8 in place (a: this thread's words
  // of each, a[2 x + v] row g + 8 v in node slab x), with the frozen word f
  // (of node slab 0) always available but never kept, under the negated
  // thresholds nthr: passes until no row of the warp changes.
  __device__ __forceinline__ void fixpoint(uint32_t (&a)[2 * kNS], uint32_t f, const int* nthr) {
    const int roots = (p.n + kChunk - 1) / kChunk;
    const int lo = p.c0 / kChunk, hi = p.units / kChunk;
    int acc[16];
    uint32_t w0, w1;
    while (__any_sync(kFull, any_of(a))) {
      uint32_t t[2 * kNS];
#pragma unroll
      for (int i = 0; i < 2 * kNS; ++i) t[i] = i < 2 ? a[i] | f : a[i];
      for (int pass = 0; pass < p.depth; ++pass) {
        src.begin(lo, hi, pass > 0);
        for (int c = lo; c < hi; ++c) {
          const int nb = blocks_of(c);
          votes(acc, c, nb, pass > 0, t, nthr);
          sat(acc, nb, w0, w1);
          if (q == ((c - lo) & 3)) s_put((c - lo) >> 2, w0, w1);
        }
      }
      src.begin(0, roots, p.depth > 0);
      uint32_t nw[2 * kNS];
#pragma unroll
      for (int i = 0; i < 2 * kNS; ++i) nw[i] = 0;
      for (int c = 0; c < roots; ++c) {
        const int nb = blocks_of(c);
        votes(acc, c, nb, p.depth > 0, t, nthr);
        sat(acc, nb, w0, w1);
        if constexpr (kNS == 1) {
          if (q == c) {
            nw[0] = w0 & a[0];
            nw[1] = w1 & a[1];
          }
        } else if (q == (c & 3)) {  // root chunk c: word c & 3 of node slab c >> 2
          if (c < 4) {
            nw[0] = w0 & a[0];
            nw[1] = w1 & a[1];
          } else {
            nw[2] = w0 & a[2];
            nw[3] = w1 & a[3];
          }
        }
      }
      bool moved = false;
#pragma unroll
      for (int i = 0; i < 2 * kNS; ++i) moved = moved || nw[i] != a[i];
      const bool changed = __any_sync(kFull, moved);
#pragma unroll
      for (int i = 0; i < 2 * kNS; ++i) a[i] = nw[i];
      if (!changed) break;
    }
  }
  // The one-slab form (the sweep, the guard and the frontier up to 128
  // lanes): a0, a1 this thread's words of rows g and g + 8.
  __device__ __forceinline__ void fixpoint(uint32_t& a0, uint32_t& a1, uint32_t f, const int* nthr) {
    static_assert(kNS == 1, "rows of two node slabs take the array form");
    uint32_t a[2] = {a0, a1};
    fixpoint(a, f, nthr);
    a0 = a[0];
    a1 = a[1];
  }

 private:
  __device__ __forceinline__ static bool any_of(const uint32_t (&a)[2 * kNS]) {
    uint32_t o = a[0];
#pragma unroll
    for (int i = 1; i < 2 * kNS; ++i) o |= a[i];
    return o != 0;
  }
};

// Blocks of `Kernel` the card holds at once at `smem` bytes.  A sweep or a
// guard launches many programs of one shape, so the answer is kept per
// (device, smem); the kernel's shared-memory limit only grows, which keeps
// every cached size launchable from any host thread.
template <auto Kernel>
cudaError_t resident_blocks(size_t smem, long long* cap) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, long long> known;
  static std::map<int, size_t> limit;  // per device; the default is 48 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find({dev, smem});
  if (hit != known.end()) {
    *cap = hit->second;
    return cudaSuccess;
  }
  size_t& lim = limit.emplace(dev, 48 * 1024).first->second;
  if (smem > lim) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    lim = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // one block does not fit an SM
  *cap = known[{dev, smem}] = (long long)sms * per_sm;
  return cudaSuccess;
}

// Grid of a persistent grid-stride loop over `tiles` 16-row tiles: as many
// resident blocks as the card holds, never more than the tiles need; 0
// blocks (and cudaSuccess) when there is nothing to do.
template <auto Kernel>
cudaError_t plan_grid(size_t smem, long long tiles, int* grid) {
  *grid = 0;
  long long cap = 0;
  const cudaError_t err = resident_blocks<Kernel>(smem, &cap);
  if (err != cudaSuccess) return err;
  const long long want = (tiles + kWarps - 1) / kWarps;
  *grid = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace qi_warp
