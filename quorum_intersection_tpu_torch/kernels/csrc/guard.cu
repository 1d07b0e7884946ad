// Block guard of the sweep's prune plan for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (kernels/guard_cuda.py).  Two instances:
//
// - guard_dense replaces the JAX package's Pallas kernel
//   `pallas_guard_factory` (backends/tpu/pallas_sweep.py:257, kernel at :285)
//   and its XLA twin `kernels.guard_program_factory` (backends/tpu/
//   kernels.py:359): vote counts as bit-planes over one uint64_t row, so any
//   multiplicity is exact (the Pallas kernel takes int8 votes only);
// - guard_bitset replaces the guard half of the JAX bitset engine,
//   `kernels.bitset_guard_program_factory` (kernels.py:722): 0/1 votes as
//   `bitset_encode`'s uint32 words (LSB-first), two words per row.
//
// For each row r of the (B, n) maximal-candidate masks (n <= 64):
//   Q      = greatest fixpoint of masks[r] under the Q thresholds (scoped)
//   out[r] = |Q|
// A zero count proves that the block's maximal candidate holds no quorum:
// the fixpoint is monotone in its candidate set, so no window of the block
// can hit, and the drive skips the block.
//
// Design: one thread per row in a grid-stride loop, the circuit evaluated by
// circuit_eval.cuh from tables in shared memory, as in the sweep kernels;
// no decode, no D probe, no frozen row (the Q thresholds fill both table
// slots).  The JAX guards pad rows to a fixed chunk or grid block; here the
// wrapper passes exactly B rows and the loop bound is the ragged edge.
//
// What bounds it: each row runs up to n + 1 fixpoint passes of depth + 1
// sweeps over U units, against its n - 1 candidate bits in (the kernel
// takes them as one 8-byte word) and a 4-byte count out.  At the drive's at
// most 2^14 rows that is microseconds of work: the launch and the host's
// mask upload around it dominate.

#include "circuit_eval.cuh"

namespace {

using qi::kThreads;

template <typename Word, int NW, int W>
__global__ void __launch_bounds__(kThreads)
guard_kernel(const Word* __restrict__ member_planes, const Word* __restrict__ child_planes,
             const int* __restrict__ thr, int n, int units, int pm, int pc, int depth, int c0,
             const Word* __restrict__ masks, long long rows, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  qi::Tables<Word> tq, same;
  qi::load_tables<Word, NW, W>(reinterpret_cast<Word*>(smem_raw), member_planes, child_planes,
                               thr, thr, n, units, pm, pc, depth, c0, tq, same);
  __syncthreads();

  const Word none[NW] = {};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += stride) {
    Word a[NW];
#pragma unroll
    for (int x = 0; x < NW; ++x) a[x] = masks[r * NW + x];
    qi::fixpoint<Word, NW, W>(a, none, tq);
    int count = 0;
#pragma unroll
    for (int x = 0; x < NW; ++x) count += qi::popc(a[x]);
    out[r] = count;
  }
}

template <typename Word, int NW, int W>
cudaError_t launch(const Word* member_planes, const Word* child_planes, const int* thr, int n,
                   int units, int pm, int pc, int depth, int c0, const Word* masks,
                   long long rows, int* out, cudaStream_t stream) {
  const size_t smem = qi::table_bytes<Word, NW, W>(units, pm, pc);
  int grid = 0;
  cudaError_t err = qi::plan_grid(guard_kernel<Word, NW, W>, smem, rows, &grid);
  if (err != cudaSuccess || grid < 1) return err;
  guard_kernel<Word, NW, W><<<grid, kThreads, smem, stream>>>(
      member_planes, child_planes, thr, n, units, pm, pc, depth, c0, masks, rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dense (bit-plane) guard.  Tables: member planes [pm][units], child planes
// [pc][units][words] from unit c0, thresholds [units]; masks [rows] (bit v
// is node v).  Returns a cudaError_t (0 on success).
extern "C" int qi_guard_dense(const uint64_t* member_planes, const uint64_t* child_planes,
                              const int* thr, int n, int units, int pm, int pc, int depth, int c0,
                              int words, const uint64_t* masks, long long rows, int* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QI_DENSE_CASE(W)                                                                      \
  case W:                                                                                     \
    return launch<uint64_t, 1, W>(member_planes, child_planes, thr, n, units, pm, pc, depth, \
                                  c0, masks, rows, out, s);
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

// Bitset guard.  Tables: member words [units][2], child words [units][words]
// from unit c0, thresholds [units]; masks [rows][2].
extern "C" int qi_guard_bitset(const uint32_t* member_words, const uint32_t* child_words,
                               const int* thr, int n, int units, int depth, int c0, int words,
                               const uint32_t* masks, long long rows, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QI_BITSET_CASE(W)                                                                    \
  case W:                                                                                    \
    return launch<uint32_t, 2, W>(member_words, child_words, thr, n, units, 1, 1, depth, c0, \
                                  masks, rows, out, s);
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
