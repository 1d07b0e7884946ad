// Fused quorum-intersection sweep for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (kernels/sweep_cuda.py).
//
// Replaces the JAX package's fused Pallas kernel
// `pallas_sweep_program_factory` (backends/tpu/pallas_sweep.py:119, kernel at
// :158) and the default XLA program `kernels.sweep_program_factory`
// (backends/tpu/kernels.py:305, step at :244), which compute the same
// function.  Unlike the Pallas kernel it also takes the D-probe thresholds of
// an SCC-restricted circuit (the Q6 fold) and the hi row of the two-level
// wide decode, so it serves every sweep of the CLI path.
//
// For each candidate index idx in [start, start + rows):
//   S     = hi_mask | {lo_nodes[j] : bit j of idx, j < lo_bits}
//   Q     = greatest fixpoint of S under the Q thresholds (scoped)
//   D     = greatest fixpoint of scc & ~Q under the D thresholds, with the
//           frozen row always available but never filtered
//   hit   = Q != 0 && D != 0
// and the program's output is the smallest hit idx (atomicMin into one int32
// the wrapper initialised to INT32_MAX).
//
// Design: one thread per candidate row (grid-stride), availability as one
// uint64_t (n <= 64 nodes after SCC restriction), the circuit evaluated by
// circuit_eval.cuh over bit-planes with a W-word child satisfaction mask
// (W in 1, 2, 4, 8, 16: up to 1024 units).  The planes, the thresholds and
// four byte-indexed decode tables live in shared memory, read as warp-wide
// broadcasts.
//
// What bounds it: operations.  Every input is a few KB and the output is 4
// bytes, while each row runs two fixpoints of (depth + 1) passes over U
// units.  The integer pipe's popcount rate is the roof; the design keeps all
// per-row state in registers and every table read a broadcast.

#include "circuit_eval.cuh"

namespace {

using qi::kMissIndex;
using qi::kThreads;
constexpr int kDecodeEntries = 4 * 256;  // one table per index byte

template <int W>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const uint64_t* __restrict__ member_planes,
             const uint64_t* __restrict__ child_planes,
             const int* __restrict__ thr_q, const int* __restrict__ thr_d,
             const int* __restrict__ lo_nodes, int lo_bits,
             uint64_t hi_mask, uint64_t scc_mask, uint64_t frozen,
             int n, int units, int pm, int pc, int depth, int c0,
             long long start, long long rows, int* __restrict__ out) {
  extern __shared__ uint64_t smem[];
  uint64_t* decode = smem;

  // decode[256 k + v]: the nodes that byte k of an index equal to v enables.
  for (int e = threadIdx.x; e < kDecodeEntries; e += blockDim.x) {
    const int k = e >> 8, v = e & 255;
    uint64_t m = 0;
    for (int i = 0; i < 8; ++i) {
      const int bit = 8 * k + i;
      if (bit < lo_bits && ((v >> i) & 1)) m |= 1ull << lo_nodes[bit];
    }
    decode[e] = m;
  }
  qi::Tables<uint64_t> cq, cd;
  qi::load_tables<uint64_t, 1, W>(decode + kDecodeEntries, member_planes, child_planes, thr_q,
                                  thr_d, n, units, pm, pc, depth, c0, cq, cd);
  __syncthreads();

  const uint64_t none[1] = {0};
  const uint64_t frz[1] = {frozen};
  int best = kMissIndex;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += stride) {
    // The backend keeps start + rows <= 2^31, so the index fits 31 bits and
    // bits at or above lo_bits decode to nothing (chunk-tail aliases).
    const uint32_t idx = (uint32_t)(start + r);
    uint64_t q[1] = {hi_mask | decode[idx & 255] | decode[256 + ((idx >> 8) & 255)] |
                     decode[512 + ((idx >> 16) & 255)] | decode[768 + (idx >> 24)]};
    qi::fixpoint<uint64_t, 1, W>(q, none, cq);
    if (!q[0]) continue;
    uint64_t d[1] = {scc_mask & ~q[0]};
    qi::fixpoint<uint64_t, 1, W>(d, frz, cd);
    if (d[0] && (int)idx < best) best = (int)idx;
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0 && best != kMissIndex) atomicMin(out, best);
}

template <int W>
cudaError_t launch(const uint64_t* member_planes, const uint64_t* child_planes,
                   const int* thr_q, const int* thr_d, const int* lo_nodes, int lo_bits,
                   uint64_t hi_mask, uint64_t scc_mask, uint64_t frozen, int n, int units,
                   int pm, int pc, int depth, int c0, long long start, long long rows, int* out,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(uint64_t) * kDecodeEntries + qi::table_bytes<uint64_t, 1, W>(units, pm, pc);
  int grid = 0;
  cudaError_t err = qi::plan_grid(sweep_kernel<W>, smem, rows, &grid);
  if (err != cudaSuccess || grid < 1) return err;
  sweep_kernel<W><<<grid, kThreads, smem, stream>>>(
      member_planes, child_planes, thr_q, thr_d, lo_nodes, lo_bits, hi_mask, scc_mask, frozen,
      n, units, pm, pc, depth, c0, start, rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t (0 on success).  `words` is the child mask width W
// (1, 2, 4, 8 or 16 words of 64 units from unit c0).
extern "C" int qi_sweep_fused(const uint64_t* member_planes, const uint64_t* child_planes,
                              const int* thr_q, const int* thr_d, const int* lo_nodes,
                              int lo_bits, uint64_t hi_mask, uint64_t scc_mask,
                              uint64_t frozen, int n, int units, int words, int c0, int pm,
                              int pc, int depth, long long start, long long rows, int* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QI_SWEEP_CASE(W)                                                                    \
  case W:                                                                                   \
    return launch<W>(member_planes, child_planes, thr_q, thr_d, lo_nodes, lo_bits, hi_mask, \
                     scc_mask, frozen, n, units, pm, pc, depth, c0, start, rows, out, s);
  switch (words) {
    QI_SWEEP_CASE(1)
    QI_SWEEP_CASE(2)
    QI_SWEEP_CASE(4)
    QI_SWEEP_CASE(8)
    QI_SWEEP_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QI_SWEEP_CASE
}
