// Block guard of the sweep's prune plan for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (kernels/guard_cuda.py).
//
// Replaces the JAX package's Pallas kernel `pallas_guard_factory`
// (backends/tpu/pallas_sweep.py:257, kernel at :285), its XLA twin
// `kernels.guard_program_factory` (backends/tpu/kernels.py:359) and the guard
// half of the bitset engine, `kernels.bitset_guard_program_factory`
// (kernels.py:722).  The dense and the bitset encodings are one evaluator: the
// bitset encoding's 0/1 votes are the one-plane case of the bit-plane tables.
//
// For each row r of the (B, n) maximal-candidate masks (n <= 64, two uint32
// words a row, bit v of the row is node v):
//   Q      = greatest fixpoint of masks[r] under the Q thresholds (scoped)
//   out[r] = |Q|
// A zero count proves that the block's maximal candidate holds no quorum:
// the fixpoint is monotone in its candidate set, so no window of the block
// can hit, and the drive skips the block.
//
// What bounds it: each row runs up to n + 1 fixpoint passes of depth + 1
// sweeps over U units, against its candidate bits in (8 bytes) and a 4-byte
// count out.  At the drive's at most 2^14 rows that is microseconds of work.
// The design is the fused sweep's warp evaluator (warp_mma.cuh: b1 and-popc
// votes on the tensor cores, 16 rows a warp, no barrier in the fixpoint)
// with rows loaded from device memory instead of decoded, the Q fixpoint
// only, and exactly B counts written (the ragged edge masked).

#include "warp_mma.cuh"

namespace {

using namespace qi_warp;

template <class Src, bool kS1>
__global__ void __launch_bounds__(kThreads)
guard_kernel(Params p, const uint32_t* __restrict__ masks, long long rows, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(false, Src::kStream, p);
  Warp<Src, kS1> w;
  w.init(smem, l, p, false);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const long long tiles = (rows + kRows - 1) / kRows;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); t < tiles;
       t += (long long)gridDim.x * kWarps) {
    const long long r0 = t * kRows + g, r1 = r0 + 8;
    uint32_t a0 = q < 2 && r0 < rows ? masks[2 * r0 + q] : 0u;
    uint32_t a1 = q < 2 && r1 < rows ? masks[2 * r1 + q] : 0u;
    w.fixpoint(a0, a1, 0u, w.src.thr_q);
    int c0 = __popc(a0), c1 = __popc(a1);
    c0 += __shfl_xor_sync(kFull, c0, 1);
    c0 += __shfl_xor_sync(kFull, c0, 2);
    c1 += __shfl_xor_sync(kFull, c1, 1);
    c1 += __shfl_xor_sync(kFull, c1, 2);
    if (q == 0 && r0 < rows) out[r0] = c0;
    if (q == 1 && r1 < rows) out[r1] = c1;
  }
}

template <class Src, bool kS1>
cudaError_t launch(const Params& p, const uint32_t* masks, long long rows, int* out,
                   cudaStream_t stream) {
  const size_t smem = make_layout(false, Src::kStream, p).end;
  int grid = 0;
  cudaError_t err = plan_grid<guard_kernel<Src, kS1>>(smem, (rows + kRows - 1) / kRows, &grid);
  if (err != cudaSuccess || grid < 1) return err;
  guard_kernel<Src, kS1><<<grid, kThreads, smem, stream>>>(p, masks, rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Tables as kernels/sweep_cuda.py `plane_tables` builds them, thr negated;
// masks [rows][2] uint32 words.  Returns a cudaError_t (0 on success).
extern "C" int qi_guard(const void* blocks, const void* chunks, const int* thr, int n, int n_units,
                        int units, int depth, int c0, int slabs, int pc, int nblocks, int stream,
                        const uint32_t* masks, long long rows, int* out, void* cuda_stream) {
  const Params p{static_cast<const uint4*>(blocks), static_cast<const int4*>(chunks), thr, thr,
                 n, n_units, units, depth, c0, slabs, pc, nblocks};
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const bool s1 = slabs <= 1;
  if (stream)
    return s1 ? launch<Streamed, true>(p, masks, rows, out, s) : launch<Streamed, false>(p, masks, rows, out, s);
  return s1 ? launch<Resident, true>(p, masks, rows, out, s) : launch<Resident, false>(p, masks, rows, out, s);
}
