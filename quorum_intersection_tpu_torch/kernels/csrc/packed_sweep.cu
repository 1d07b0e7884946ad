// Lane-packed quorum-intersection sweeps for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (kernels/packed_cuda.py).  Two kernels:
//
// - packed_sweep_dense replaces the JAX package's Pallas kernel
//   `pallas_packed_program_factory` (backends/tpu/pallas_sweep.py:343, kernel
//   at :404) and its XLA twin `kernels.packed_sweep_program_factory`
//   (backends/tpu/kernels.py:445): vote counts as bit-planes over a 128-lane
//   row of two uint64_t words;
// - packed_sweep_bitset replaces `pallas_bitset_program_factory`
//   (pallas_sweep.py:556, kernel at :622): 0/1 votes as `bitset_encode`'s
//   uint32 words (LSB-first), one native popcount per word.
//
// The circuit is K <= 16 SCC-restricted circuits fused block-diagonally
// (encode.pack_circuits): group g owns lanes [g*slot, g*slot + size_g), its
// local node 0 fixed out of the enumeration.  A program covers `rows` rows;
// row r decodes candidate starts[g] + r for EVERY group at once:
//   S     = for each g, bits [0, size_g - 1) of starts[g] + r on lanes
//           [base_g, base_g + size_g - 1), base_g = g*slot + 1
//   Q     = greatest fixpoint of S under the Q thresholds
//   D     = greatest fixpoint of scc & ~Q under the D thresholds (Q6 fold)
//   hit_g = (Q & group_g) != 0 && (D & group_g) != 0
// and out[g] is the smallest starts[g] + r with hit_g (atomicMin into a (K,)
// int32 vector the wrapper initialised to INT32_MAX).  Block-diagonality
// makes every group's fixpoint its own, so the D probe leaves out the lanes
// of groups whose Q is empty: they cannot hit, and no other group reads them.
//
// Design: one thread per row, as the fused unpacked sweep (sweep.cu), with
// the shared evaluator of circuit_eval.cuh; the per-group survivor test
// `popc(q & group_mask[g]) > 0` stands in for the TPU's (B, Np) x (Np, Kp)
// indicator matmul.  A warp reduces its hits per group, then one lane does
// one atomicMin per group.  Group starts, decode bases and masks ride in the
// kernel's parameter block; the tables live in shared memory.
//
// What bounds it: operations.  The tables are at most a few hundred KB and
// the output K int32, while each row runs two fixpoints of (depth + 1) passes
// over U units; the popcount pipe is the roof.

#include "circuit_eval.cuh"

namespace {

using qi::kMissIndex;
using qi::kThreads;
constexpr int kMaxGroups = 16;

template <typename Word, int NW>
struct Packs {
  int k;
  int start[kMaxGroups];
  int base[kMaxGroups];  // lane of the group's local node 1
  int bits[kMaxGroups];  // enumerated nodes: size_g - 1 (<= 30)
  Word mask[kMaxGroups][NW];
  Word scc[NW];
};

// Lanes [base, base + bits) of word x take bits of v (v < 2^30).
template <typename Word>
__device__ __forceinline__ Word place(uint64_t v, int base, int x) {
  constexpr int B = 8 * sizeof(Word);
  const int s = base - B * x;
  if (s >= 0) return s < B ? (Word)(v << s) : 0;
  return -s < 64 ? (Word)(v >> -s) : 0;
}

template <typename Word, int NW>
__device__ __forceinline__ bool meets(const Word (&a)[NW], const Word (&m)[NW]) {
  Word acc = 0;
#pragma unroll
  for (int x = 0; x < NW; ++x) acc |= a[x] & m[x];
  return acc != 0;
}

template <typename Word, int NW, int W>
__global__ void __launch_bounds__(kThreads)
packed_kernel(const Word* __restrict__ member_planes, const Word* __restrict__ child_planes,
              const int* __restrict__ thr_q, const int* __restrict__ thr_d, int n, int units,
              int pm, int pc, int depth, int c0, const Packs<Word, NW> p, long long rows,
              int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  qi::Tables<Word> tq, td;
  qi::load_tables<Word, NW, W>(reinterpret_cast<Word*>(smem_raw), member_planes, child_planes,
                               thr_q, thr_d, n, units, pm, pc, depth, c0, tq, td);
  __syncthreads();

  const Word none[NW] = {};
  int best[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) best[g] = kMissIndex;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += stride) {
    Word q[NW] = {};
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= p.k) break;
      // The wrapper keeps starts[g] + rows <= 2^31; bits at or above
      // size_g - 1 decode to nothing (overshoot aliases, masked on the host).
      const uint64_t v = (uint64_t)(p.start[g] + r) & ((1ull << p.bits[g]) - 1);
#pragma unroll
      for (int x = 0; x < NW; ++x) q[x] |= place<Word>(v, p.base[g], x);
    }
    qi::fixpoint<Word, NW, W>(q, none, tq);
    Word d[NW] = {};
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= p.k) break;
      if (meets<Word, NW>(q, p.mask[g])) {
#pragma unroll
        for (int x = 0; x < NW; ++x) d[x] |= p.mask[g][x];
      }
    }
    if (!qi::any_bit<Word, NW>(d)) continue;
#pragma unroll
    for (int x = 0; x < NW; ++x) d[x] &= p.scc[x] & ~q[x];
    qi::fixpoint<Word, NW, W>(d, none, td);
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= p.k) break;
      const int idx = (int)(p.start[g] + r);
      if (meets<Word, NW>(q, p.mask[g]) && meets<Word, NW>(d, p.mask[g]) && idx < best[g])
        best[g] = idx;
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g >= p.k) break;
    const int m = __reduce_min_sync(0xffffffffu, best[g]);
    if ((threadIdx.x & 31) == 0 && m != kMissIndex) atomicMin(out + g, m);
  }
}

template <typename Word, int NW, int W>
cudaError_t launch(const Word* member_planes, const Word* child_planes, const int* thr_q,
                   const int* thr_d, int n, int units, int pm, int pc, int depth, int c0,
                   const Packs<Word, NW>& p, long long rows, int* out, cudaStream_t stream) {
  const size_t smem = qi::table_bytes<Word, NW, W>(units, pm, pc);
  int grid = 0;
  cudaError_t err = qi::plan_grid(packed_kernel<Word, NW, W>, smem, rows, &grid);
  if (err != cudaSuccess || grid < 1) return err;
  packed_kernel<Word, NW, W><<<grid, kThreads, smem, stream>>>(
      member_planes, child_planes, thr_q, thr_d, n, units, pm, pc, depth, c0, p, rows, out);
  return cudaGetLastError();
}

// Host arrays → the kernel's parameter block.
template <typename Word, int NW>
bool fill_packs(Packs<Word, NW>& p, int k, const int* starts, const int* base, const int* bits,
                const Word* masks, const Word* scc) {
  if (k < 1 || k > kMaxGroups) return false;
  p.k = k;
  for (int g = 0; g < kMaxGroups; ++g) {
    const bool live = g < k;
    p.start[g] = live ? starts[g] : 0;
    p.base[g] = live ? base[g] : 0;
    p.bits[g] = live ? bits[g] : 0;
    if (live && (p.bits[g] < 0 || p.bits[g] > 30)) return false;
    for (int x = 0; x < NW; ++x) p.mask[g][x] = live ? masks[g * NW + x] : 0;
  }
  for (int x = 0; x < NW; ++x) p.scc[x] = scc[x];
  return true;
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dense (bit-plane) packed sweep.  Tables: member planes [pm][units][2],
// child planes [pc][units][words] from unit c0, thresholds [units] each.
// Host arrays: starts/base/bits [k], masks [k][2], scc [2].  Returns a
// cudaError_t (0 on success).
extern "C" int qi_packed_dense(const uint64_t* member_planes, const uint64_t* child_planes,
                               const int* thr_q, const int* thr_d, int n, int units, int pm,
                               int pc, int depth, int c0, int words, int k, const int* starts,
                               const int* base, const int* bits, const uint64_t* masks,
                               const uint64_t* scc, long long rows, int* out, void* stream) {
  Packs<uint64_t, 2> p;
  if (!fill_packs<uint64_t, 2>(p, k, starts, base, bits, masks, scc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QI_DENSE_CASE(W)                                                                      \
  case W:                                                                                     \
    return launch<uint64_t, 2, W>(member_planes, child_planes, thr_q, thr_d, n, units, pm, pc, \
                                  depth, c0, p, rows, out, s);
  switch (words) {
    QI_DENSE_CASE(1)
    QI_DENSE_CASE(2)
    QI_DENSE_CASE(4)
    QI_DENSE_CASE(8)
    QI_DENSE_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QI_DENSE_CASE
}

// Bitset packed sweep.  Tables: member words [units][4], child words
// [units][words] from unit c0, thresholds [units] each.  Host arrays:
// starts/base/bits [k], masks [k][4], scc [4].
extern "C" int qi_packed_bitset(const uint32_t* member_words, const uint32_t* child_words,
                                const int* thr_q, const int* thr_d, int n, int units, int depth,
                                int c0, int words, int k, const int* starts, const int* base,
                                const int* bits, const uint32_t* masks, const uint32_t* scc,
                                long long rows, int* out, void* stream) {
  Packs<uint32_t, 4> p;
  if (!fill_packs<uint32_t, 4>(p, k, starts, base, bits, masks, scc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QI_BITSET_CASE(W)                                                                    \
  case W:                                                                                    \
    return launch<uint32_t, 4, W>(member_words, child_words, thr_q, thr_d, n, units, 1, 1,   \
                                  depth, c0, p, rows, out, s);
  switch (words) {
    QI_BITSET_CASE(1)
    QI_BITSET_CASE(2)
    QI_BITSET_CASE(4)
    QI_BITSET_CASE(8)
    QI_BITSET_CASE(16)
    QI_BITSET_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QI_BITSET_CASE
}
