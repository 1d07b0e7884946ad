// PageRank power loop for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (kernels/pagerank_cuda.py).
//
// Replaces the JAX package's jitted power loop `_jitted_power_loops`
// (analytics/pagerank.py:116-174: the dense program at :160, the sparse one
// at :165), a lax.while_loop that runs to convergence without a host round
// trip.  Plain PyTorch calls would sync with the host every iteration for
// the `diff > conv` test; this kernel runs the whole loop in one cooperative
// launch and the caller reads back the result once.
//
// Input: the in-edge CSR (row_ptr [n+1], src [E] sorted by destination,
// outdeg [n] float) and seg_ptr [n+1], the running count of the edge
// segments of at most `seg` entries each row is cut into (the wrapper's
// SEGMENT_ENTRIES).  Per iteration, in float32 as in the JAX program:
//   (A) rank = e0 (first iteration) or tmp / total; send = (1-m) inv_out rank;
//       a per-block partial of sum(outdeg * send)                  | grid sync
//   (B) one warp per segment: seg_sum = sum of send[src[i]] over it | grid sync
//   (C) tmp[w] = m/n + sum of row w's segment sums, in order;
//       a per-block partial of sum(|tmp - rank|)                    | grid sync
// then every block sums the partials in block order (the same sum in every
// block, so no broadcast is needed), forms total and diff, and applies the
// stop test `diff > conv && it < max_iterations` itself.  The gather is in
// CSR order with fixed warp-shuffle trees: deterministic, no atomics.  At
// the end the kernel writes rank = tmp / total, the iteration count and the
// last diff.
//
// What bounds it: an iteration needs E src indices (4 E bytes; the
// gathered send values stay in L2, an n-float vector) plus about 20 n bytes
// of vertex vectors, at 3.35 TB/s; at a million edges that is under 3
// microseconds, so three grid barriers (a few microseconds each) set the
// pace.  Heavy rows (a validator trusted
// by 10^5 watchers) are cut into segments so that no single warp walks
// one; the segment sums of a row are added in segment order.
//
// Grid barriers: cooperative_groups' grid.sync() under
// cudaLaunchCooperativeKernel (no relocatable-device-code build needed).
// The grid is no larger than the co-resident block count; blocks stride
// over vertices and warps over segments.  Built without fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The block's sum of x, the same tree for every block; all threads return
// it.  `red` holds kWarps + 1 floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float y = lane < kWarps ? red[lane] : 0.f;
    y = warp_sum(y);
    if (lane == 0) red[kWarps] = y;
  }
  __syncthreads();
  return red[kWarps];
}

// Sum of part[0..g) in a fixed order, identical in every block.
__device__ __forceinline__ float grid_partials_sum(const float* part, int g, float* red) {
  float x = 0.f;
  for (int i = threadIdx.x; i < g; i += kThreads) x += part[i];
  return block_sum(x, red);
}

struct Args {
  int n;
  const int* row_ptr;
  const int* src;
  const float* outdeg;
  const int* seg_ptr;
  int seg;  // CSR entries a segment, at most
  float m, conv;
  int max_iterations;
  float* rank;     // [n]: the result
  float* tmp;      // [n]
  float* send;     // [n]
  float* seg_sum;  // [segments]
  int* seg_row;    // [segments]
  float* part;     // [3 * gridDim.x]: total (two buffers by parity), diff
  int* out_iterations;
  float* out_diff;
};

__global__ void __launch_bounds__(kThreads) pagerank_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[kWarps + 1];
  const int g = gridDim.x;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)g * kThreads;
  const int warp = (int)(tid >> 5), lane = threadIdx.x & 31, warps = (int)(stride >> 5);
  const int n = a.n;
  const int segments = a.seg_ptr[n];
  const float base = a.m / (float)n;
  const float c1 = 1.f - a.m;

  // Each segment's row, and e0.
  for (long long w = tid; w < n; w += stride) {
    for (int s = a.seg_ptr[w]; s < a.seg_ptr[w + 1]; ++s) a.seg_row[s] = (int)w;
    a.rank[w] = w == 0 ? 1.f : 0.f;
  }
  float diff = a.conv + 1.f, total = 1.f;
  int it = 0;
  grid.sync();
  while (diff > a.conv && it < a.max_iterations) {
    float* part_total = a.part + (it & 1) * g;
    float* part_diff = a.part + 2 * g;
    // (A) rank and send, sum(outdeg * send).
    float acc = 0.f;
    for (long long v = tid; v < n; v += stride) {
      float r = it == 0 ? a.rank[v] : a.tmp[v] / total;
      if (it != 0) a.rank[v] = r;
      const float od = a.outdeg[v];
      const float inv = od > 0.f ? 1.f / fmaxf(od, 1.f) : 0.f;
      const float s = c1 * inv * r;
      a.send[v] = s;
      acc += od * s;
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) part_total[blockIdx.x] = acc;
    grid.sync();
    // (B) segment sums of the gathered sends.
    for (int s = warp; s < segments; s += warps) {
      const int w = a.seg_row[s];
      const int begin = a.row_ptr[w] + (s - a.seg_ptr[w]) * a.seg;
      const int end = min(begin + a.seg, a.row_ptr[w + 1]);
      float x = 0.f;
      for (int i = begin + lane; i < end; i += 32) x += a.send[a.src[i]];
      x = warp_sum(x);
      if (lane == 0) a.seg_sum[s] = x;
    }
    grid.sync();
    // (C) tmp and sum(|tmp - rank|).
    acc = 0.f;
    for (long long w = tid; w < n; w += stride) {
      float x = 0.f;
      for (int s = a.seg_ptr[w]; s < a.seg_ptr[w + 1]; ++s) x += a.seg_sum[s];
      const float t = base + x;
      a.tmp[w] = t;
      acc += fabsf(t - a.rank[w]);
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) part_diff[blockIdx.x] = acc;
    grid.sync();
    total = a.m + grid_partials_sum(part_total, g, red);
    diff = grid_partials_sum(part_diff, g, red);
    ++it;
  }
  if (it > 0)
    for (long long v = tid; v < n; v += stride) a.rank[v] = a.tmp[v] / total;
  if (tid == 0) {
    *a.out_iterations = it;
    *a.out_diff = diff;
  }
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The cooperative grid for `work` threads' worth of work: at most the
// co-resident block count.  *cooperative is 0 where the device cannot
// launch cooperatively.  Returns a cudaError_t (0 on success).
extern "C" int qi_pagerank_grid(long long work, int* grid, int* cooperative) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pagerank_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  long long want = (work + kThreads - 1) / kThreads;
  long long most = (long long)per_sm * sms;
  *grid = (int)(want < 1 ? 1 : (want < most ? want : most));
  return cudaSuccess;
}

// One launch of the whole power loop on `stream`.  Returns a cudaError_t.
extern "C" int qi_pagerank(int n, const int* row_ptr, const int* src, const float* outdeg,
                           const int* seg_ptr, int seg, float m, float conv, int max_iterations,
                           float* rank, float* tmp, float* send, float* seg_sum, int* seg_row,
                           float* part, int grid, int* out_iterations, float* out_diff,
                           void* cuda_stream) {
  Args a{n, row_ptr, src, outdeg, seg_ptr, seg, m, conv, max_iterations, rank, tmp, send,
         seg_sum, seg_row, part, out_iterations, out_diff};
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)pagerank_kernel, dim3(grid),
                                                dim3(kThreads), params, 0,
                                                static_cast<cudaStream_t>(cuda_stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
