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
// For each candidate index idx in [start, start + rows) (K1), or, in the
// sharded instance, each idx = start + (r / sub) * stride + r % sub of row r
// in [0, rows) (one rank's share of the JAX package's mesh-sharded step K11,
// `TpuSweepBackend._build_sharded_step`, backends/tpu/sweep.py:2196-2261:
// sub-block `sub` rows of each of rows / sub blocks `stride` apart):
//   S     = hi_mask | {lo_nodes[j] : bit j of idx, j < lo_bits}
//   Q     = greatest fixpoint of S under the Q thresholds (scoped)
//   D     = greatest fixpoint of scc & ~Q under the D thresholds, with the
//           frozen row always available but never filtered
//   hit   = Q != 0 && D != 0
// and the program's output is the smallest hit idx (atomicMin into one int32
// the wrapper initialised to INT32_MAX).
//
// What bounds it: operations.  Every input is a few KB and the output is 4
// bytes, while each row runs two fixpoints of (depth + 1) passes over U
// units.  The Pallas kernel takes the votes as int8 matrix products on the
// TPU's matrix unit; counted with popcounts, one thread per row, they would
// sit on the integer pipe's roof.  This kernel takes them on the tensor cores
// as b1 and-popc products (warp_mma.cuh): a warp decodes 16 rows straight
// into the A fragment, runs the Q fixpoint and, while some row of the warp
// has a non-empty Q, the D probe, all in registers and with no barrier
// between warps.  What remains per pass is the epilogue (a compare per row
// and unit, the quad's shuffles), so the kernel skips the n8 blocks past the
// last real unit.  Persistent grid-stride blocks of eight warps share the
// tables and the four byte-indexed decode tables in shared memory, or stream
// the tables where they do not fit (chosen on the host from their size).
//
// The sharded instance differs only in the index map, a template argument,
// so the contiguous instance compiles to the code it had before.  One
// launch covers a rank's whole share of a program (up to 1024 sub-blocks at
// STEPS_RAMP's top), where K1 a sub-block would take a launch each; its
// bound is K1's, over the rows it covers.  The min over ranks is the
// caller's (parallel/mesh.py `mesh_pmin`: a gather on the home card, then
// NCCL's all_reduce(MIN) across processes).

#include "warp_mma.cuh"

namespace {

using namespace qi_warp;
constexpr int kDecodeEntries = 4 * 256;  // one table per index byte

// The node row of candidate idx: the hi row and the decoded low bits (the
// backend keeps start + rows <= 2^31, so bits at or above lo_bits decode to
// nothing: chunk-tail aliases).
__device__ __forceinline__ uint64_t decode_row(const uint64_t* decode, uint64_t hi, uint32_t idx) {
  return hi | decode[idx & 255] | decode[256 + ((idx >> 8) & 255)] |
         decode[512 + ((idx >> 16) & 255)] | decode[768 + (idx >> 24)];
}

// Row r → candidate index: K1's contiguous range.
struct Contiguous {
  long long start;
  __device__ __forceinline__ uint32_t operator()(long long r) const { return (uint32_t)(start + r); }
};

// Row r → candidate index: K11's rank share, sub-block r / sub of a program
// at stride `stride`.  The wrapper keeps rows and every index below 2^31, so
// the division runs in 32 bits.
struct Strided {
  long long start;
  uint32_t sub, stride;
  __device__ __forceinline__ uint32_t operator()(long long r) const {
    const uint32_t rr = (uint32_t)r;
    return (uint32_t)start + (rr / sub) * stride + rr % sub;
  }
};

template <class Src, bool kS1, class Map>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(Params p, const int* __restrict__ lo_nodes, int lo_bits, uint64_t hi_mask,
             uint64_t scc_mask, uint64_t frozen, Map map, long long rows,
             int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(true, Src::kStream, p);
  uint64_t* decode = reinterpret_cast<uint64_t*>(smem + l.decode);
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
  Warp<Src, kS1> w;
  w.init(smem, l, p, true);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const uint32_t scc_w = word_of(scc_mask, q), frozen_w = word_of(frozen, q);
  const long long tiles = (rows + kRows - 1) / kRows;
  int best = kMiss;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); t < tiles;
       t += (long long)gridDim.x * kWarps) {
    const long long r0 = t * kRows + g, r1 = r0 + 8;
    const uint32_t idx0 = map(r0), idx1 = map(r1);
    uint32_t a0 = r0 < rows ? word_of(decode_row(decode, hi_mask, idx0), q) : 0u;
    uint32_t a1 = r1 < rows ? word_of(decode_row(decode, hi_mask, idx1), q) : 0u;
    w.fixpoint(a0, a1, 0u, w.src.thr_q);
    const bool q0 = quad_any(a0 != 0), q1 = quad_any(a1 != 0);
    if (!__any_sync(kFull, q0 || q1)) continue;  // no row of the warp has a quorum
    uint32_t d0 = q0 ? scc_w & ~a0 : 0u, d1 = q1 ? scc_w & ~a1 : 0u;
    w.fixpoint(d0, d1, frozen_w, w.src.thr_d);
    // Every thread takes part in the shuffles (no short-circuit around them).
    const bool d0_any = quad_any(d0 != 0), d1_any = quad_any(d1 != 0);
    const bool h0 = q0 && d0_any, h1 = q1 && d1_any;
    if (q == 0) {
      if (h0 && (int)idx0 < best) best = (int)idx0;
      if (h1 && (int)idx1 < best) best = (int)idx1;
    }
  }
  best = __reduce_min_sync(kFull, best);
  if (lane == 0 && best != kMiss) atomicMin(out, best);
}

template <class Src, bool kS1, class Map>
cudaError_t launch(const Params& p, const int* lo_nodes, int lo_bits, uint64_t hi_mask,
                   uint64_t scc_mask, uint64_t frozen, Map map, long long rows, int* out,
                   cudaStream_t stream) {
  const size_t smem = make_layout(true, Src::kStream, p).end;
  int grid = 0;
  cudaError_t err = plan_grid<sweep_kernel<Src, kS1, Map>>(smem, (rows + kRows - 1) / kRows, &grid);
  if (err != cudaSuccess || grid < 1) return err;
  sweep_kernel<Src, kS1, Map><<<grid, kThreads, smem, stream>>>(p, lo_nodes, lo_bits, hi_mask,
                                                                scc_mask, frozen, map, rows, out);
  return cudaGetLastError();
}

// The table instance (resident or streamed) and the one-slab case, for
// either index map.
template <class Map>
cudaError_t dispatch(const Params& p, int stream, const int* lo_nodes, int lo_bits,
                     uint64_t hi_mask, uint64_t scc_mask, uint64_t frozen, Map map, long long rows,
                     int* out, cudaStream_t s) {
  const bool s1 = p.slabs <= 1;
  if (stream)
    return s1 ? launch<Streamed, true>(p, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, map, rows, out, s)
              : launch<Streamed, false>(p, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, map, rows, out, s);
  return s1 ? launch<Resident, true>(p, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, map, rows, out, s)
            : launch<Resident, false>(p, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, map, rows, out, s);
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t (0 on success).  Tables as kernels/sweep_cuda.py
// `plane_tables` builds them, thr_q and thr_d negated; `stream` picks the
// streamed instance.
extern "C" int qi_sweep_fused(const void* blocks, const void* chunks, const int* thr_q,
                              const int* thr_d, const int* lo_nodes, int lo_bits,
                              uint64_t hi_mask, uint64_t scc_mask, uint64_t frozen, int n,
                              int n_units, int units, int depth, int c0, int slabs, int pc,
                              int nblocks, int stream, long long start, long long rows, int* out,
                              void* cuda_stream) {
  const Params p{static_cast<const uint4*>(blocks), static_cast<const int4*>(chunks), thr_q, thr_d,
                 n, n_units, units, depth, c0, slabs, pc, nblocks};
  return dispatch(p, stream, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, Contiguous{start}, rows,
                  out, static_cast<cudaStream_t>(cuda_stream));
}

// The sharded instance (K11's per-rank body): as qi_sweep_fused, over the
// rows r in [0, rows) at idx = start + (r / sub) * stride + r % sub.  The
// wrapper has checked 1 <= sub <= stride and every index below 2^31.
extern "C" int qi_sweep_sharded(const void* blocks, const void* chunks, const int* thr_q,
                                const int* thr_d, const int* lo_nodes, int lo_bits,
                                uint64_t hi_mask, uint64_t scc_mask, uint64_t frozen, int n,
                                int n_units, int units, int depth, int c0, int slabs, int pc,
                                int nblocks, int stream, long long start, long long sub,
                                long long stride, long long rows, int* out, void* cuda_stream) {
  const Params p{static_cast<const uint4*>(blocks), static_cast<const int4*>(chunks), thr_q, thr_d,
                 n, n_units, units, depth, c0, slabs, pc, nblocks};
  const Strided map{start, (uint32_t)sub, (uint32_t)stride};
  return dispatch(p, stream, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, map, rows, out,
                  static_cast<cudaStream_t>(cuda_stream));
}
