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
// uint64_t (n <= 64 nodes after SCC restriction).  A vote count c[u][j]
// splits into bit-planes, c = sum_b 2^b plane_b, so
//   votes[u] = sum_b 2^b popc(avail & plane_b[u])
// is exact for any multiplicity; child votes of inner units run the same way
// over a U-bit satisfaction mask held in W <= 4 words.  The planes, the
// thresholds and four byte-indexed decode tables live in shared memory, read
// as warp-wide broadcasts.  Thresholds compare in signed int32: after the
// restriction fold they may be <= 0 ("satisfied by constants alone").
//
// What bounds it: operations.  Every input is a few KB and the output is 4
// bytes, while each row runs two fixpoints of (depth + 1) passes over U
// units.  The integer pipe's popcount rate is the roof; the design keeps all
// per-row state in registers and every table read a broadcast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDecodeEntries = 4 * 256;  // one table per index byte
constexpr int kMissIndex = 0x7fffffff;

struct Circuit {
  const uint64_t* member_planes;  // [pm][U]: bit j of plane b = bit b of members[u][j]
  const uint64_t* child_planes;   // [pc][U][W]: bit v = bit b of child[u][v]
  const int* thr;                 // [U] signed thresholds
  int n, units, pm, pc, depth;
};

// Nodes with a satisfied slice under `avail` (the Q4 self-availability
// conjunct applied), after `depth` child passes — the JAX `node_sat`.
template <int W>
__device__ __forceinline__ uint64_t node_sat(uint64_t avail, const Circuit& c) {
  uint64_t prev[W];
#pragma unroll
  for (int w = 0; w < W; ++w) prev[w] = 0;
  for (int pass = 0; pass <= c.depth; ++pass) {
    // Only the node units feed the result, so the last pass stops at n.
    const int lim = pass == c.depth ? c.n : c.units;
    uint64_t cur[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint64_t word = 0;
      const int u_end = min(lim, 64 * (w + 1));
      for (int u = 64 * w; u < u_end; ++u) {
        int votes = 0;
        for (int b = 0; b < c.pm; ++b)
          votes += __popcll(avail & c.member_planes[b * c.units + u]) << b;
        if (pass > 0) {
          for (int b = 0; b < c.pc; ++b) {
            const uint64_t* row = c.child_planes + (size_t)(b * c.units + u) * W;
            int kids = 0;
#pragma unroll
            for (int x = 0; x < W; ++x) kids += __popcll(prev[x] & row[x]);
            votes += kids << b;
          }
        }
        word |= (uint64_t)(votes >= c.thr[u]) << (u - 64 * w);
      }
      cur[w] = word;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) prev[w] = cur[w];
  }
  return prev[0] & avail;
}

// Greatest fixpoint of `a`: drop members whose slice fails until stable.
template <int W>
__device__ __forceinline__ uint64_t fixpoint(uint64_t a, uint64_t frozen, const Circuit& c) {
  while (a) {
    const uint64_t nxt = node_sat<W>(a | frozen, c) & a;
    if (nxt == a) break;
    a = nxt;
  }
  return a;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const uint64_t* __restrict__ member_planes,
             const uint64_t* __restrict__ child_planes,
             const int* __restrict__ thr_q, const int* __restrict__ thr_d,
             const int* __restrict__ lo_nodes, int lo_bits,
             uint64_t hi_mask, uint64_t scc_mask, uint64_t frozen,
             int n, int units, int pm, int pc, int depth,
             long long start, long long rows, int* __restrict__ out) {
  extern __shared__ uint64_t smem[];
  uint64_t* decode = smem;
  uint64_t* mp = decode + kDecodeEntries;
  uint64_t* cp = mp + pm * units;
  int* tq = reinterpret_cast<int*>(cp + pc * units * W);
  int* td = tq + units;

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
  for (int e = threadIdx.x; e < pm * units; e += blockDim.x) mp[e] = member_planes[e];
  for (int e = threadIdx.x; e < pc * units * W; e += blockDim.x) cp[e] = child_planes[e];
  for (int e = threadIdx.x; e < units; e += blockDim.x) {
    tq[e] = thr_q[e];
    td[e] = thr_d[e];
  }
  __syncthreads();

  const Circuit cq{mp, cp, tq, n, units, pm, pc, depth};
  const Circuit cd{mp, cp, td, n, units, pm, pc, depth};
  int best = kMissIndex;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += stride) {
    // The backend keeps start + rows <= 2^31, so the index fits 31 bits and
    // bits at or above lo_bits decode to nothing (chunk-tail aliases).
    const uint32_t idx = (uint32_t)(start + r);
    const uint64_t avail = hi_mask | decode[idx & 255] | decode[256 + ((idx >> 8) & 255)] |
                           decode[512 + ((idx >> 16) & 255)] | decode[768 + (idx >> 24)];
    const uint64_t q = fixpoint<W>(avail, 0, cq);
    if (q && fixpoint<W>(scc_mask & ~q, frozen, cd) && (int)idx < best) best = (int)idx;
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if ((threadIdx.x & 31) == 0 && best != kMissIndex) atomicMin(out, best);
}

template <int W>
cudaError_t launch(const uint64_t* member_planes, const uint64_t* child_planes,
                   const int* thr_q, const int* thr_d, const int* lo_nodes, int lo_bits,
                   uint64_t hi_mask, uint64_t scc_mask, uint64_t frozen, int n, int units,
                   int pm, int pc, int depth, long long start, long long rows, int* out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(uint64_t) * (kDecodeEntries + (size_t)pm * units +
                                          (size_t)pc * units * W) +
                      sizeof(int) * 2 * (size_t)units;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sweep_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_kernel<W>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long want = (rows + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(want < cap ? want : cap);
  if (grid < 1) return cudaSuccess;
  sweep_kernel<W><<<grid, kThreads, smem, stream>>>(
      member_planes, child_planes, thr_q, thr_d, lo_nodes, lo_bits, hi_mask, scc_mask, frozen,
      n, units, pm, pc, depth, start, rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t (0 on success).  `words` = ceil(units / 64), 1..4.
extern "C" int qi_sweep_fused(const uint64_t* member_planes, const uint64_t* child_planes,
                              const int* thr_q, const int* thr_d, const int* lo_nodes,
                              int lo_bits, uint64_t hi_mask, uint64_t scc_mask,
                              uint64_t frozen, int n, int units, int words, int pm, int pc,
                              int depth, long long start, long long rows, int* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1:
      return launch<1>(member_planes, child_planes, thr_q, thr_d, lo_nodes, lo_bits, hi_mask,
                       scc_mask, frozen, n, units, pm, pc, depth, start, rows, out, s);
    case 2:
      return launch<2>(member_planes, child_planes, thr_q, thr_d, lo_nodes, lo_bits, hi_mask,
                       scc_mask, frozen, n, units, pm, pc, depth, start, rows, out, s);
    case 3:
      return launch<3>(member_planes, child_planes, thr_q, thr_d, lo_nodes, lo_bits, hi_mask,
                       scc_mask, frozen, n, units, pm, pc, depth, start, rows, out, s);
    case 4:
      return launch<4>(member_planes, child_planes, thr_q, thr_d, lo_nodes, lo_bits, hi_mask,
                       scc_mask, frozen, n, units, pm, pc, depth, start, rows, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
