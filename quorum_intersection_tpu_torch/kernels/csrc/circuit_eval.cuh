// Threshold-circuit evaluation shared by the fused sweep and the block
// guard (sweep.cu, guard.cu): one candidate row per thread, every set held as a few
// machine words in registers.
//
// A row's availability is NW words of `Word` (uint64_t for the bit-plane
// kernels, uint32_t for the bitset kernel); bit v of word v / B is node v.
// A vote count c[u][j] splits into bit-planes, c = sum_b 2^b plane_b, so
//   votes[u] = sum_b 2^b popc(avail & plane_b[u])
// is exact for any multiplicity (the bitset encoding is the one-plane case).
// Child votes of inner units run the same way over a satisfaction mask of W
// words that covers units [c0, units) only: every child unit lies there
// (c0 is the first child unit rounded down to a word), so the root units
// that no one nests never take mask bits.  Thresholds compare in signed
// int32: after the restriction fold they may be <= 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qi {

constexpr int kThreads = 256;
constexpr int kMissIndex = 0x7fffffff;

__device__ __forceinline__ int popc(uint64_t x) { return __popcll(x); }
__device__ __forceinline__ int popc(uint32_t x) { return __popc(x); }

template <typename Word>
struct Tables {
  const Word* member_planes;  // [pm][units][NW]
  const Word* child_planes;   // [pc][units][W]: bit (c - c0) = bit b of child[u][c]
  const int* thr;             // [units] signed thresholds
  int n, units, pm, pc, depth, c0;
};

// Satisfaction bits of units [u_lo, u_hi) (at most one word of them).
template <typename Word, int NW, int W>
__device__ __forceinline__ Word sat_word(int u_lo, int u_hi, bool kids, const Word (&avail)[NW],
                                         const Word (&prev)[W], const Tables<Word>& t) {
  Word word = 0;
  for (int u = u_lo; u < u_hi; ++u) {
    int votes = 0;
    for (int b = 0; b < t.pm; ++b) {
      const Word* row = t.member_planes + ((size_t)b * t.units + u) * NW;
      int c = 0;
#pragma unroll
      for (int x = 0; x < NW; ++x) c += popc(avail[x] & row[x]);
      votes += c << b;
    }
    if (kids) {
      for (int b = 0; b < t.pc; ++b) {
        const Word* row = t.child_planes + ((size_t)b * t.units + u) * W;
        int c = 0;
#pragma unroll
        for (int x = 0; x < W; ++x) c += popc(prev[x] & row[x]);
        votes += c << b;
      }
    }
    word |= (Word)(votes >= t.thr[u]) << (u - u_lo);
  }
  return word;
}

// Nodes with a satisfied slice under `avail`, the Q4 self-availability
// conjunct applied: `depth` passes over the child units, then one over the
// node roots (the JAX `node_sat`'s depth + 1 synchronous sweeps).
template <typename Word, int NW, int W>
__device__ __forceinline__ void node_sat(const Word (&avail)[NW], const Tables<Word>& t,
                                         Word (&out)[NW]) {
  constexpr int B = 8 * sizeof(Word);
  Word prev[W];
#pragma unroll
  for (int x = 0; x < W; ++x) prev[x] = 0;
  for (int pass = 0; pass < t.depth; ++pass) {
    Word cur[W];
#pragma unroll
    for (int x = 0; x < W; ++x) {
      const int lo = t.c0 + B * x;
      cur[x] = sat_word<Word, NW, W>(lo, min(t.units, lo + B), pass > 0, avail, prev, t);
    }
#pragma unroll
    for (int x = 0; x < W; ++x) prev[x] = cur[x];
  }
#pragma unroll
  for (int x = 0; x < NW; ++x) {
    const int lo = B * x;
    out[x] = sat_word<Word, NW, W>(lo, min(t.n, lo + B), t.depth > 0, avail, prev, t) & avail[x];
  }
}

template <typename Word, int NW>
__device__ __forceinline__ bool any_bit(const Word (&a)[NW]) {
  Word acc = 0;
#pragma unroll
  for (int x = 0; x < NW; ++x) acc |= a[x];
  return acc != 0;
}

// Greatest fixpoint of `a`, in place: drop members whose slice fails (with
// `frozen` always available but never filtered) until stable.  The
// fixpoint only ever clears bits, so popc(a ^ nxt) is the change.
template <typename Word, int NW, int W>
__device__ __forceinline__ void fixpoint(Word (&a)[NW], const Word (&frozen)[NW],
                                         const Tables<Word>& t) {
  while (any_bit<Word, NW>(a)) {
    Word total[NW], nxt[NW];
#pragma unroll
    for (int x = 0; x < NW; ++x) total[x] = a[x] | frozen[x];
    node_sat<Word, NW, W>(total, t, nxt);
    int changed = 0;
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      nxt[x] &= a[x];
      changed += popc(a[x] ^ nxt[x]);
    }
    if (!changed) break;
#pragma unroll
    for (int x = 0; x < NW; ++x) a[x] = nxt[x];
  }
}

// Shared memory the circuit tables take, and their copy into it.
template <typename Word, int NW, int W>
__host__ __device__ inline size_t table_bytes(int units, int pm, int pc) {
  return sizeof(Word) * ((size_t)pm * units * NW + (size_t)pc * units * W) +
         sizeof(int) * 2 * (size_t)units;
}

// Copies [member planes | child planes | thr_q | thr_d] into `smem` and
// returns the two tables that read it.
template <typename Word, int NW, int W>
__device__ __forceinline__ void load_tables(Word* smem, const Word* member_planes,
                                            const Word* child_planes, const int* thr_q,
                                            const int* thr_d, int n, int units, int pm, int pc,
                                            int depth, int c0, Tables<Word>& tq,
                                            Tables<Word>& td) {
  Word* mp = smem;
  Word* cp = mp + (size_t)pm * units * NW;
  int* sq = reinterpret_cast<int*>(cp + (size_t)pc * units * W);
  int* sd = sq + units;
  for (int e = threadIdx.x; e < pm * units * NW; e += blockDim.x) mp[e] = member_planes[e];
  for (int e = threadIdx.x; e < pc * units * W; e += blockDim.x) cp[e] = child_planes[e];
  for (int e = threadIdx.x; e < units; e += blockDim.x) {
    sq[e] = thr_q[e];
    sd[e] = thr_d[e];
  }
  tq = Tables<Word>{mp, cp, sq, n, units, pm, pc, depth, c0};
  td = Tables<Word>{mp, cp, sd, n, units, pm, pc, depth, c0};
}

// Grid for a grid-stride loop over `rows`: as many resident blocks as the
// card holds at this shared-memory size, never more than the rows need.
// Returns 0 blocks (and cudaSuccess) when there is nothing to do.
template <typename Kernel>
cudaError_t plan_grid(Kernel kernel, size_t smem, long long rows, int* grid) {
  *grid = 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // the tables do not fit one block
  const long long want = (rows + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * per_sm;
  *grid = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

}  // namespace qi
