// PageRank power loop for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (kernels/pagerank_cuda.py).
//
// Replaces the JAX package's jitted power loop `_jitted_power_loops`
// (analytics/pagerank.py:116-174: the dense program at :160, the sparse one
// at :165), a lax.while_loop that runs to convergence without a host round
// trip.  The whole loop is one cooperative launch; the caller reads the
// result back once.
//
// Input: the in-edge CSR (row_ptr [n+1], src [E] sorted by destination and
// then source, outdeg [n] float).  The JAX body of iteration k, in float32:
//   send_k = (1-m) inv_out rank_k        tmp_k = m/n + A^T send_k
//   T_k    = m + sum(outdeg * send_k)    diff_k = sum |tmp_k - rank_k|
//   rank_{k+1} = tmp_k / T_k
// T_k and diff_k depend only on rank_k = tmp_{k-1} / T_{k-1} and on tmp_k,
// so one pass an iteration does all of it, from the unnormalised vector:
// every gathered entry is c1 inv[s] (tmp_{k-1}[s] / T_{k-1}), the JAX
// expression per entry, tmp_k goes to the other of two buffers by parity,
// and each block's partials of T_k and diff_k go to partial buffers by
// parity.  Then ONE grid barrier, after which every block sums the partials
// in the same fixed order and applies `diff > conv && it < max_iterations`
// itself.  Iteration 0 gathers from e0 (buffer 1 holds e0, T_{-1} = 1).
//
// The rows, classified by the prologue from their degree: at most kLight
// entries, a thread each, in the vertex pass that also forms every vertex's
// T term; longer ones cut into segments of `seg` entries (chosen on the host
// from E and the grid), a warp a segment.  A one-segment row is finished by
// its warp.  A longer row is finished by the LAST of its segments to
// arrive: each writes its sum and takes a ticket (a release-acquire
// fetch_add at device scope); the warp that draws the last ticket reads the
// row's segment sums and adds them with a fixed shuffle tree in segment
// order, writes tmp and the row's diff term into a slot of its own in the
// partials, and resets the ticket.  The atomic decides only who adds, never
// the order, so the result is the same bits from launch to launch; no
// atomic touches a float.  Every sum is in a fixed order with fixed shuffle
// trees (products by __fmul_rn, so nvcc contracts no product into an FMA),
// so tests/_torch_pagerank_schedule.py reproduces the kernel's bits on the
// CPU.
//
// The prologue builds the segment table on the device (two grid barriers,
// once a call): each block counts the segments and slots of its own range
// of rows, then scans the counts of the blocks before it and writes its
// rows' segments.  The wrapper does one launch a call, on one workspace
// tensor, with no PyTorch kernel beside it.
//
// What bounds it: an iteration needs E src indices (4 E bytes) plus about
// 20 n bytes of vertex vectors at 3.35 TB/s: at a million edges 2.4
// microseconds.  What sets the pace instead is the chain of dependent L2
// round trips an iteration, and at a million edges the L2 sectors the
// gathers pull, so the design cuts both: one grid barrier; a warp keeps its
// first segment's row, source indices and their c1 inv[s] in registers
// across iterations (they never change), so its gather is one round of
// 4-byte tmp loads, all in flight at once; a thread loads its first
// vertices before the segment pass; no serial tail after the barrier.
//
// Grid barriers: cooperative_groups' grid.sync() under
// cudaLaunchCooperativeKernel (no relocatable-device-code build needed).
// The timed instance (kTimed) has warp 0 of block 0 add clock64() cycles
// per part of an iteration and count the grid barriers it passes, in the
// prologue and in the loop.  Built without fast math.

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads a block (pagerank_cuda.THREADS); 512 were slower in turns
constexpr int kWarps = kThreads / 32;
constexpr int kLight = 16;  // rows of at most this many entries: a thread each (pagerank_cuda.LIGHT_ENTRIES)
constexpr int kPhases = 6;  // the timed instance's parts of an iteration (pagerank_cuda.TIMED_PHASES)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float2 warp_sum2(float2 x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x.x += __shfl_xor_sync(kFull, x.x, o);
    x.y += __shfl_xor_sync(kFull, x.y, o);
  }
  return x;
}

__device__ __forceinline__ int4 add4(int4 a, int4 b) { return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w); }

__device__ __forceinline__ int4 shfl_xor4(int4 v, int o) {
  return make_int4(__shfl_xor_sync(kFull, v.x, o), __shfl_xor_sync(kFull, v.y, o), __shfl_xor_sync(kFull, v.z, o),
                   __shfl_xor_sync(kFull, v.w, o));
}

__device__ __forceinline__ int4 shfl_up4(int4 v, int o) {
  return make_int4(__shfl_up_sync(kFull, v.x, o), __shfl_up_sync(kFull, v.y, o), __shfl_up_sync(kFull, v.z, o),
                   __shfl_up_sync(kFull, v.w, o));
}

__device__ __forceinline__ int4 warp_sum4(int4 x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = add4(x, shfl_xor4(x, o));
  return x;
}

// The block's sum of a pair, the same tree in every block; all threads
// return it.  `red` holds 33 float2.
__device__ __forceinline__ float2 block_sum2(float2 x, float2* red) {
  x = warp_sum2(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float2 y = lane < kWarps ? red[lane] : make_float2(0.f, 0.f);
    y = warp_sum2(y);
    if (lane == 0) red[32] = y;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ int4 block_sum4(int4 x, int4* red) {
  x = warp_sum4(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int4 y = lane < kWarps ? red[lane] : make_int4(0, 0, 0, 0);
    y = warp_sum4(y);
    if (lane == 0) red[32] = y;
  }
  __syncthreads();
  return red[32];
}

// Exclusive scan of v over the block, in thread order.
__device__ __forceinline__ int4 block_scan4(int4 v, int4* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int4 inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int4 t = shfl_up4(inc, o);
    if (lane >= o) inc = add4(inc, t);
  }
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int4 w = lane < kWarps ? red[lane] : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int4 t = shfl_up4(w, o);
      if (lane >= o) w = add4(w, t);
    }
    if (lane < kWarps) red[lane] = w;
  }
  __syncthreads();
  const int4 before = warp > 0 ? red[warp - 1] : make_int4(0, 0, 0, 0);
  return make_int4(before.x + inc.x - v.x, before.y + inc.y - v.y, before.z + inc.z - v.z,
                   before.w + inc.w - v.w);
}

// x plus the gathered entries src[i], src[i + step], ... below `end`, in
// that order; each is c1 inv[s] * (tmp_{k-1}[s] / T_{k-1}), as JAX forms it.
// kBatch index loads, then kBatch pair loads, are in flight before the
// first division: the order of the adds stays the entries' order.
template <int kBatch>
__device__ __forceinline__ float gather_run(float x, const float* cv, const float* prev, const int* src, int i,
                                            int end, int step, float total) {
  for (; i < end; i += step * kBatch) {
    int u[kBatch];
    float c[kBatch], t[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) u[b] = i + step * b < end ? __ldg(src + i + step * b) : -1;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      c[b] = u[b] >= 0 ? cv[u[b]] : 0.f;
      t[b] = u[b] >= 0 ? prev[u[b]] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (u[b] >= 0) x += __fmul_rn(c[b], __fdiv_rn(t[b], total));
  }
  return x;
}

// A row's segments: none for a light row.
__device__ __forceinline__ int segments_of(int degree, int seg) {
  return degree > kLight ? (degree + seg - 1) / seg : 0;
}

// The kBatch entries of a lane in one segment: c (= c1 inv[s]) times
// tmp_{k-1}[s] / T_{k-1} for the cached sources u (-1: none), added in order.
template <int kBatch>
__device__ __forceinline__ float gather_cached(const int (&u)[kBatch], const float (&c)[kBatch], const float* prev,
                                               float total) {
  float t[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) t[b] = u[b] >= 0 ? prev[u[b]] : 0.f;
  float x = 0.f;
#pragma unroll
  for (int b = 0; b < kBatch; ++b)
    if (u[b] >= 0) x += __fmul_rn(c[b], __fdiv_rn(t[b], total));
  return x;
}

struct Args {
  int n;
  const int* row_ptr;
  const int* src;
  const float* outdeg;
  int seg;  // CSR entries a segment, at most
  float m, conv;
  int max_iterations;
  float* rank;          // [n]: the result
  int* out_iterations;  // [1]
  float* out_diff;      // [1]
  float* cv;            // [n]: c1 inv_out
  float* tmp;           // [2][n]: tmp by parity
  int4* segs;           // [seg_cap]: {row, index in the row, the row's segments, its slot or -1}
  float* seg_sum;       // [seg_cap]
  int* ticket;          // [slot_cap]: per row of several segments
  float2* part;         // [2][g + slot_cap]: {total, diff} partials by parity
  int4* count;          // [g]: the prologue's {segments, slots} per block
  long long* timing;    // the timed instance: [kPhases] cycles of warp 0 of block 0, then iterations,
                        // then the grid barriers passed in the loop and in the prologue
};

template <bool kTimed>
__global__ void __launch_bounds__(kThreads) pagerank_kernel(Args a) {
  // A lane's gathers in flight: a whole segment of 32 * kBatch = 1024
  // entries (one block an SM leaves a thread the registers), and a
  // thread's vertices.
  constexpr int kBatch = 32;
  constexpr int kVertices = 8;
  cg::grid_group grid = cg::this_grid();
  __shared__ float2 red2[33];
  __shared__ int4 red4[33];
  const int g = gridDim.x;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)g * kThreads;
  const int lane = threadIdx.x & 31;
  const int warp = (int)(tid >> 5), warps = (int)(stride >> 5);
  const int n = a.n, seg = a.seg;
  const float base = a.m / (float)n;
  const float c1 = 1.f - a.m;
  const int* __restrict__ row_ptr = a.row_ptr;
  // Every grid barrier of the kernel; the timed instance counts them.
  long long barriers = 0;
  auto sync = [&]() {
    grid.sync();
    if constexpr (kTimed) ++barriers;
  };

  // -- prologue: the vectors, then the segment table ----------------------
  // Block b owns a contiguous range of rows, each of its threads a
  // contiguous piece of that range: the table comes out in row order.
  const long long per_block = ((long long)n + g - 1) / g;
  const long long lo = min((long long)n, per_block * blockIdx.x), hi = min((long long)n, lo + per_block);
  const long long per_thread = (hi - lo + kThreads - 1) / kThreads;
  const long long tlo = min(hi, lo + per_thread * threadIdx.x), thi = min(hi, tlo + per_thread);
#pragma unroll 4
  for (long long v = tid; v < n; v += stride) {
    const float od = a.outdeg[v];
    const float c = __fmul_rn(c1, od > 0.f ? 1.f / fmaxf(od, 1.f) : 0.f);
    a.cv[v] = c;
    a.tmp[n + v] = v == 0 ? 1.f : 0.f;  // e0, read by iteration 0
  }
  int4 mine = make_int4(0, 0, 0, 0);  // this thread's {segments, slots}
#pragma unroll 4
  for (long long w = tlo; w < thi; ++w) {
    const int k = segments_of(__ldg(row_ptr + w + 1) - __ldg(row_ptr + w), seg);
    mine = add4(mine, make_int4(k, k > 1, 0, 0));
  }
  {
    const int4 c = block_sum4(mine, red4);
    if (threadIdx.x == 0) a.count[blockIdx.x] = c;
  }
  sync();
  int segments, slots;
  {
    int4 before = make_int4(0, 0, 0, 0), all = make_int4(0, 0, 0, 0);
    for (int b = threadIdx.x; b < g; b += kThreads) {
      const int4 cb = a.count[b];
      if (b < (int)blockIdx.x) before = add4(before, cb);
      all = add4(all, cb);
    }
    before = block_sum4(before, red4);
    all = block_sum4(all, red4);
    segments = all.x;
    slots = all.y;
    const int4 at = add4(before, block_scan4(mine, red4));
    int s = at.x, slot = at.y;
#pragma unroll 4
    for (long long w = tlo; w < thi; ++w) {
      const int k = segments_of(__ldg(row_ptr + w + 1) - __ldg(row_ptr + w), seg);
      for (int j = 0; j < k; ++j) a.segs[s + j] = make_int4((int)w, j, k, k > 1 ? slot : -1);
      if (k > 1) a.ticket[slot++] = 0;
      s += k;
    }
  }
  sync();
  [[maybe_unused]] const long long prologue_barriers = barriers;

  // This warp's first segment, kept across iterations: its entry and each
  // lane's sources (-1: none) and their c1 inv[s], when the segment fits a
  // lane's batch.
  const bool cached = warp < segments && seg <= 32 * kBatch;
  int4 first = make_int4(0, 0, 0, -1);
  int u[kBatch];
  float uc[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) u[b] = -1, uc[b] = 0.f;
  if (cached) {
    first = a.segs[warp];
    const int begin = row_ptr[first.x] + first.y * seg, end = min(begin + seg, row_ptr[first.x + 1]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (begin + lane + 32 * b < end) u[b] = __ldg(a.src + begin + lane + 32 * b);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (u[b] >= 0) uc[b] = a.cv[u[b]];
  }

  // The timed instance: warp 0 of block 0 adds the cycles since the last
  // mark to part ph.
  long long t_acc[kPhases] = {};
  long long t_last = clock64();
  const bool timer = kTimed && blockIdx.x == 0 && threadIdx.x < 32;
  auto mark = [&](int ph) {
    if constexpr (kTimed) {
      const long long now = clock64();
      if (timer) t_acc[ph] += now - t_last;
      t_last = now;
    }
  };

  const int pstride = g + slots;
  float total = 1.f;  // T_{k-1}; 1 before iteration 0, whose rank is e0
  float diff = a.conv + 1.f;
  int it = 0;
  while (diff > a.conv && it < a.max_iterations) {
    const float* prev = a.tmp + ((it + 1) & 1) * (long long)n;
    float* cur = a.tmp + (it & 1) * (long long)n;
    float2* part = a.part + (it & 1) * pstride;
    float acc_t = 0.f, acc_d = 0.f;
    // (0) this thread's first vertices, loaded before the segment pass.
    float p[kVertices], pc[kVertices], od[kVertices];
    int rb[kVertices], re[kVertices];
    auto load_vertices = [&](long long v0) {
#pragma unroll
      for (int q = 0; q < kVertices; ++q) {
        const long long v = v0 + q * stride;
        if (v < n) {
          p[q] = prev[v];
          pc[q] = a.cv[v];
          od[q] = __ldg(a.outdeg + v);
          rb[q] = __ldg(row_ptr + v);
          re[q] = __ldg(row_ptr + v + 1);
        }
      }
    };
    load_vertices(tid);
    // (1) the heavy rows' segments, a warp each.
    for (int s = warp; s < segments; s += warps) {
      const int4 e = s == warp && cached ? first : a.segs[s];
      const float own = prev[e.x];  // the row's tmp_{k-1}, for its diff
      float x;
      if (s == warp && cached) {
        x = gather_cached<kBatch>(u, uc, prev, total);
      } else {
        const int begin = row_ptr[e.x] + e.y * seg;
        x = gather_run<kBatch>(0.f, a.cv, prev, a.src, begin + lane, min(begin + seg, row_ptr[e.x + 1]), 32,
                               total);
      }
      x = warp_sum(x);
      mark(0);
      if (e.z == 1) {
        if (lane == 0) {
          const float t = base + x;
          cur[e.x] = t;
          acc_d += fabsf(t - __fdiv_rn(own, total));
        }
      } else {
        // Several segments: the warp that brings the last adds them all in
        // segment order and finishes the row.
        int last = 0;
        if (lane == 0) {
          a.seg_sum[s] = x;
          cuda::atomic_ref<int, cuda::thread_scope_device> ticket(a.ticket[e.w]);
          last = ticket.fetch_add(1, cuda::memory_order_acq_rel) == e.z - 1;
        }
        if (__shfl_sync(kFull, last, 0)) {
          __syncwarp();
          const float* row_sums = a.seg_sum + (s - e.y);
          float y = 0.f;
          for (int j = lane; j < e.z; j += 32) y += __ldcg(row_sums + j);
          y = warp_sum(y);
          if (lane == 0) {
            a.ticket[e.w] = 0;
            const float t = base + y;
            cur[e.x] = t;
            part[g + e.w] = make_float2(0.f, fabsf(t - __fdiv_rn(own, total)));
          }
        }
      }
      mark(1);
    }
    // (2) the vertex pass: every vertex's T term; the light rows' tmp and
    // diff.  kVertices vertices' loads in flight at once, taken in the order
    // v, v + stride, ...
    for (long long v0 = tid; v0 < n; v0 += kVertices * stride) {
      if (v0 != tid) load_vertices(v0);
#pragma unroll
      for (int q = 0; q < kVertices; ++q) {
        const long long v = v0 + q * stride;
        if (v < n) {
          const float r = __fdiv_rn(p[q], total);
          acc_t += __fmul_rn(od[q], __fmul_rn(pc[q], r));
          if (re[q] - rb[q] <= kLight) {
            const float t = base + gather_run<4>(0.f, a.cv, prev, a.src, rb[q], re[q], 1, total);
            cur[v] = t;
            acc_d += fabsf(t - r);
          }
        }
      }
    }
    mark(2);
    // (3) the block's partials.
    const float2 bs = block_sum2(make_float2(acc_t, acc_d), red2);
    if (threadIdx.x == 0) part[blockIdx.x] = bs;
    mark(3);
    sync();
    mark(4);
    // (4) the stop test: the partials in a fixed order, the same in every block.
    float2 sum = make_float2(0.f, 0.f);
    for (int i = threadIdx.x; i < pstride; i += kThreads) {
      const float2 q = __ldcg(part + i);
      sum.x += q.x;
      sum.y += q.y;
    }
    sum = block_sum2(sum, red2);
    total = a.m + sum.x;
    diff = sum.y;
    ++it;
    mark(5);
  }
  const float* last = a.tmp + ((it + 1) & 1) * (long long)n;
#pragma unroll 4
  for (long long v = tid; v < n; v += stride) a.rank[v] = __fdiv_rn(last[v], total);
  if (tid == 0) {
    *a.out_iterations = it;
    *a.out_diff = diff;
  }
  if constexpr (kTimed) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      for (int i = 0; i < kPhases; ++i) a.timing[i] = t_acc[i];
      a.timing[kPhases] = it;
      a.timing[kPhases + 1] = barriers - prologue_barriers;
      a.timing[kPhases + 2] = prologue_barriers;
    }
  }
}

// The workspace's layout, in bytes from its start (16-byte aligned parts):
// rank [n], iterations, diff, cv [n], tmp [2n], segs, seg_sum, ticket,
// part, count.
struct Layout {
  long long rank, iterations, diff, cv, tmp, segs, seg_sum, ticket, part, count, bytes;
};

inline long long align16(long long x) { return (x + 15) / 16 * 16; }

// Upper bounds for E entries, segments of `seg` and `grid` blocks: a
// segmented row has more than kLight entries, a row of several segments
// more than `seg`.
Layout layout(long long n, long long n_edges, int seg, int grid) {
  const long long seg_cap = n_edges / seg + n_edges / (kLight + 1) + 1;
  const long long slot_cap = n_edges / (seg + 1) + 1;
  Layout l;
  l.rank = 0;
  l.iterations = align16(4 * n);
  l.diff = l.iterations + 4;
  l.cv = l.iterations + 16;
  l.tmp = l.cv + align16(4 * n);
  l.segs = l.tmp + align16(8 * n);
  l.seg_sum = l.segs + 16 * seg_cap;
  l.ticket = l.seg_sum + align16(4 * seg_cap);
  l.part = l.ticket + align16(4 * slot_cap);
  l.count = l.part + align16(16 * (grid + slot_cap));
  l.bytes = l.count + 16LL * grid;
  return l;
}

template <bool kTimed>
cudaError_t launch(const Args& args, int grid, cudaStream_t stream) {
  Args a = args;
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)pagerank_kernel<kTimed>, dim3(grid), dim3(kThreads),
                                                params, 0, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The current device's SM count, the co-resident blocks an SM of the
// `threads`-thread instance, and whether it launches cooperatively.
// Returns a cudaError_t (0 on success).
extern "C" int qi_pagerank_device(int threads, int* sms, int* per_sm, int* cooperative) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (threads != kThreads) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pagerank_kernel<false>, kThreads, 0);
}

// The workspace bytes a call of n vertices, E entries, segments of `seg`
// and `grid` blocks takes.
extern "C" long long qi_pagerank_bytes(long long n, long long n_edges, int seg, int grid) {
  return layout(n, n_edges, seg, grid).bytes;
}

// One launch of the whole power loop on `stream`, over a workspace of
// qi_pagerank_bytes(n, n_edges, seg, grid) bytes; the rank lies at its
// start, the iteration count (int) and the last diff (float) at the next
// 16-byte boundary.  With `timing` ([kPhases + 3] int64), the timed
// instance.  Returns a cudaError_t.
extern "C" int qi_pagerank(int n, int n_edges, const int* row_ptr, const int* src, const float* outdeg, float m,
                           float conv, int max_iterations, int seg, int threads, int grid, void* workspace,
                           long long* timing, void* cuda_stream) {
  const Layout l = layout(n, n_edges, seg, grid);
  char* ws = static_cast<char*>(workspace);
  const Args a{n, row_ptr, src, outdeg, seg, m, conv, max_iterations,
               reinterpret_cast<float*>(ws + l.rank), reinterpret_cast<int*>(ws + l.iterations),
               reinterpret_cast<float*>(ws + l.diff), reinterpret_cast<float*>(ws + l.cv),
               reinterpret_cast<float*>(ws + l.tmp),
               reinterpret_cast<int4*>(ws + l.segs), reinterpret_cast<float*>(ws + l.seg_sum),
               reinterpret_cast<int*>(ws + l.ticket), reinterpret_cast<float2*>(ws + l.part),
               reinterpret_cast<int4*>(ws + l.count), timing};
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (threads != kThreads) return cudaErrorInvalidValue;
  return timing ? launch<true>(a, grid, st) : launch<false>(a, grid, st);
}
