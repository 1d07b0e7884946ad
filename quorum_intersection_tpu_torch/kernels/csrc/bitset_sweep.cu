// Unpacked bitset sweep for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (kernels/bitset_sweep_cuda.py).
//
// Replaces the JAX package's `bitset_sweep_program_factory`
// (backends/tpu/kernels.py:664; step `bitset_sweep_step` :635, fixpoint
// `bitset_fixpoint` :608, `bitset_node_sat` :596, votes `popcount_votes`
// :561): the same function as the fused sweep (sweep.cu), computed over the
// `bitset_encode` words (encode/circuit.py) instead of vote matrices.
//
// For each candidate index idx in [start, start + rows):
//   S     = hi_mask | {lo_nodes[j] : bit j of idx, j < lo_bits}
//   Q     = greatest fixpoint of S under the Q thresholds
//   D     = greatest fixpoint of scc & ~Q under the D thresholds, with the
//           frozen words OR-ed into the availability but never filtered
//   hit   = Q != 0 && D != 0
// and the program's output is the smallest hit idx (atomicMin into one int32
// the wrapper initialised to INT32_MAX on the launch's stream).
//
// A node-sat pass: unit u's direct votes are popc(avail_0 & m0[u]) +
// popc(avail_1 & m1[u]) (n <= 64: two words); its satisfaction bit is votes
// >= thr[u]; `rounds` inner rounds add popc(sat_k & child_k[u]) over the
// unit's nonzero child words k in [k0[u], k1[u]) (its child row as
// bitset_encode packs it, trimmed to that range); the node words are the
// first ceil(n / 32) satisfaction words, AND the availability.
//
// What bounds it: operations.  The tables are a few KB (a 3001-unit circuit
// about 400 KB) and the output 4 bytes, while each row runs two fixpoints of
// passes over every unit: per unit a popcount of each availability word, a
// compare, a bit set.  The host picks one of two instances from the
// circuit's shape (kernels/bitset_sweep_cuda.py `bitset_tables`).
//
// The lane instance (narrow circuits: at most 128 units, as the bitset
// workloads, the full-width network and the snapshot have): one candidate
// row a lane, 32 consecutive rows a warp.  The row's availability, frozen
// and satisfaction words live in registers (at most four unit words: the
// word loops are unrolled, so no register array is indexed at run time);
// a pass walks the units in a host-made order, each unit's 16-byte record
// {m0, m1, thr - 1, nonzero child words} a warp-uniform shared load (a
// broadcast), and its satisfaction bit is the sign of thr - 1 - votes (a
// node word is built by one funnel shift a unit).  The host renumbers the
// inner units by height (children before parents, the node units keep
// positions [0, n)), so one pass evaluates each unit once and exactly: the
// same words as `rounds` synchronous inner rounds, which reach the true
// evaluation at the circuit's height (encode/circuit.py).  A unit with
// children adds the popcounts of its dense child row (CW words: the unit
// words a child bit may fall in; CW = 0, no child code at all, where no
// unit has children) against the words built so far.  No
// ballot, shared slot or warp barrier inside a pass: a fixpoint loops while
// `__any_sync` finds a lane whose words changed (a converged lane's pass is
// idempotent), a lane whose Q is empty enters the D fixpoint with nothing
// available, and the warp's least hit is the lowest lane of one ballot
// after both fixpoints.  A row's availability is four byte-table lookups
// (tables built from lo_nodes at block start, 8 KB of shared memory).
//
// The warp instance (wider circuits): one warp per candidate row, lanes
// over units (lane l takes units l, l + 32, ...), so a warp's 32 unit
// verdicts are one __ballot_sync: the satisfaction word itself, written by
// lane 0 to the warp's two ping-pong slots in shared memory (ceil(U / 32)
// words each).  Every branch is warp-uniform (the words come from ballots),
// a row's fixpoint takes as many passes as that row needs, and no register
// holds a per-unit value, so wide circuits cost time, not spills.  The last
// inner round computes only the node words.  The unit records (members and
// both thresholds in one 16-byte load), the child ranges and the trimmed
// child words sit in shared memory where they fit one block (the resident
// instance) and are read through L1/L2 otherwise (the streamed instance);
// the host picks from their size.
//
// Both walk their rows (a lane instance's warp: its groups of 32) in
// ascending order with a grid stride, stop at their first hit and, reading
// the current minimum as they go, at a row at or above it.

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMiss = 0x7fffffff;

struct Tables {
  const uint4* units;      // (units,) {m0, m1, thr_q, thr_d}; padded units never satisfied
  const int2* ranges;      // (units,) {base, k0 | k1 << 16}: child word k at words[base + k]
  const uint32_t* words;   // the trimmed child words
  int n_words;             // entries of `words`
  int units_pad;           // a multiple of 32
  int uw;                  // satisfaction words: units_pad / 32
  int nw;                  // node words: ceil(n / 32), 1 or 2
  int rounds;              // inner rounds (the circuit's depth where it has inner units)
};

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared memory of one block: the tables (resident instance only), then two
// satisfaction slots of uw words per warp.
__host__ __device__ inline size_t table_bytes(const Tables& t) {
  return 16 * (size_t)t.units_pad + 8 * (size_t)t.units_pad + round16(4 * (size_t)t.n_words);
}
__host__ __device__ inline size_t smem_bytes(const Tables& t, bool resident, int warps) {
  return (resident ? table_bytes(t) : 0) + 8 * (size_t)t.uw * warps;
}

template <bool kResident>
struct Warp {
  const uint4* units;
  const int2* ranges;
  const uint32_t* words;
  uint32_t* slot_a;
  uint32_t* slot_b;
  int uw, nw, rounds;

  __device__ __forceinline__ uint4 unit(int u) const {
    if (kResident) return units[u];
    return __ldg(units + u);
  }
  __device__ __forceinline__ int2 range(int u) const {
    if (kResident) return ranges[u];
    return __ldg(ranges + u);
  }
  __device__ __forceinline__ uint32_t child(int e) const {
    if (kResident) return words[e];
    return __ldg(words + e);
  }

  // Satisfied-node words of availability (a0, a1) under the Q (d_side
  // false) or D thresholds, before the AND with the availability.
  __device__ __forceinline__ uint2 node_sat(uint32_t a0, uint32_t a1, bool d_side, int lane) const {
    uint32_t* cur = slot_a;
    const int base_chunks = rounds ? uw : nw;
    for (int j = 0; j < base_chunks; ++j) {
      const uint4 r = unit(32 * j + lane);
      const int votes = __popc(a0 & r.x) + __popc(a1 & r.y);
      const uint32_t w = __ballot_sync(kFull, votes >= (int)(d_side ? r.w : r.z));
      if (lane == 0) cur[j] = w;
    }
    for (int round = 0; round < rounds; ++round) {
      __syncwarp();
      uint32_t* nxt = cur == slot_a ? slot_b : slot_a;
      const int chunks = round + 1 == rounds ? nw : uw;
      for (int j = 0; j < chunks; ++j) {
        const int u = 32 * j + lane;
        const uint4 r = unit(u);
        int votes = __popc(a0 & r.x) + __popc(a1 & r.y);
        const int2 g = range(u);
        const int k1 = (int)((uint32_t)g.y >> 16);
        for (int k = g.y & 0xffff; k < k1; ++k) votes += __popc(cur[k] & child(g.x + k));
        const uint32_t w = __ballot_sync(kFull, votes >= (int)(d_side ? r.w : r.z));
        if (lane == 0) nxt[j] = w;
      }
      cur = nxt;
    }
    __syncwarp();
    const uint2 s = make_uint2(cur[0], nw > 1 ? cur[1] : 0u);
    __syncwarp();  // every lane has read before the next pass writes
    return s;
  }

  // Greatest fixpoint from (a0, a1), frozen words (f0, f1) always available.
  __device__ __forceinline__ uint2 fixpoint(uint32_t a0, uint32_t a1, uint32_t f0, uint32_t f1,
                                            bool d_side, int lane) const {
    for (;;) {
      const uint2 s = node_sat(a0 | f0, a1 | f1, d_side, lane);
      const uint32_t n0 = s.x & a0, n1 = s.y & a1;
      if (n0 == a0 && n1 == a1) return make_uint2(a0, a1);
      a0 = n0;
      a1 = n1;
    }
  }
};

// No __launch_bounds__: under (256) ptxas held the streamed instance to 32
// registers and spilled 44/36 bytes of its loop state to local memory;
// without it both instances take 40 registers and spill nothing.  Blocks
// have at most 256 threads (kernels/bitset_sweep_cuda.py WARPS).
template <bool kResident>
__global__ void
bitset_sweep_kernel(Tables t, const int* __restrict__ lo_nodes, int lo_bits, uint64_t hi_mask,
                    uint64_t scc_mask, uint64_t frozen, long long start, long long rows,
                    int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Warp<kResident> w;
  size_t off = 0;
  if (kResident) {
    uint4* units = reinterpret_cast<uint4*>(smem);
    int2* ranges = reinterpret_cast<int2*>(smem + 16 * (size_t)t.units_pad);
    uint32_t* words = reinterpret_cast<uint32_t*>(smem + 24 * (size_t)t.units_pad);
    for (int i = threadIdx.x; i < t.units_pad; i += blockDim.x) {
      units[i] = t.units[i];
      ranges[i] = t.ranges[i];
    }
    for (int i = threadIdx.x; i < t.n_words; i += blockDim.x) words[i] = t.words[i];
    w.units = units;
    w.ranges = ranges;
    w.words = words;
    off = table_bytes(t);
  } else {
    w.units = t.units;
    w.ranges = t.ranges;
    w.words = t.words;
  }
  w.slot_a = reinterpret_cast<uint32_t*>(smem + off) + 2 * (size_t)t.uw * warp;
  w.slot_b = w.slot_a + t.uw;
  w.uw = t.uw;
  w.nw = t.nw;
  w.rounds = t.rounds;
  __syncthreads();

  // Lane j decodes index bit j into node lo_nodes[j].
  const int node = lane < lo_bits ? lo_nodes[lane] : -1;
  const uint32_t hi0 = (uint32_t)hi_mask, hi1 = (uint32_t)(hi_mask >> 32);
  const uint32_t scc0 = (uint32_t)scc_mask, scc1 = (uint32_t)(scc_mask >> 32);
  const uint32_t fr0 = (uint32_t)frozen, fr1 = (uint32_t)(frozen >> 32);
  const long long stride = (long long)gridDim.x * warps;
  int best = kMiss, seen = 0;
  for (long long r = (long long)blockIdx.x * warps + warp; r < rows; r += stride) {
    const int idx = (int)(start + r);
    if ((seen++ & 31) == 0) {  // every 32 rows: the current minimum, from lane 0
      int cur = 0;
      if (lane == 0) cur = *reinterpret_cast<volatile int*>(out);
      best = __shfl_sync(kFull, cur, 0);
    }
    if (idx >= best) break;  // a smaller hit is already in
    const bool on = node >= 0 && ((idx >> lane) & 1);
    const uint32_t a0 = __reduce_or_sync(kFull, on && node < 32 ? 1u << node : 0u) | hi0;
    const uint32_t a1 = __reduce_or_sync(kFull, on && node >= 32 ? 1u << (node - 32) : 0u) | hi1;
    const uint2 q = w.fixpoint(a0, a1, 0u, 0u, false, lane);
    if ((q.x | q.y) == 0) continue;
    const uint2 d = w.fixpoint(scc0 & ~q.x, scc1 & ~q.y, fr0, fr1, true, lane);
    if (d.x | d.y) {
      if (lane == 0) atomicMin(out, idx);
      break;  // this warp's later rows hold larger indices
    }
  }
}

// ---- the lane instance --------------------------------------------------

constexpr int kLaneWarps = 8;
constexpr int kDecodeEntries = 4 * 256;  // one table per index byte
constexpr size_t kDecodeBytes = 8 * kDecodeEntries;

struct LaneTables {
  const uint4* rec_q;     // (n_units,) {m0, m1, thr_q - 1, child word mask}, units at their positions
  const uint4* rec_d;     // the same records with thr_d - 1
  const uint32_t* child;  // (n_units, CW) child words over positions; null where no unit has children
  int n;                  // node units: positions [0, n)
  int inner_end;          // inner units evaluated: positions [n, inner_end), children first
  int n_units;            // records
};

// `cw`: child words a unit (0 where no unit has children).
__host__ __device__ inline size_t lane_smem_bytes(int n_units, int cw) {
  return kDecodeBytes + 32 * (size_t)n_units + round16(4 * (size_t)cw * n_units);
}

template <int CW>
struct ChildRow {
  uint32_t w[CW];
};

template <int CW>
__device__ __forceinline__ ChildRow<CW> child_row(const uint32_t* p) {
  if constexpr (CW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    return ChildRow<CW>{{v.x, v.y, v.z, v.w}};
  } else if constexpr (CW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return ChildRow<CW>{{v.x, v.y}};
  } else {
    return ChildRow<CW>{{*p}};
  }
}

struct LaneView {
  const uint4* rec;
  const uint32_t* child;
  int n, inner_end;
};

// Satisfaction words a lane keeps: the child words, or one unused word.
template <int CW>
constexpr int kSatWords = CW > 0 ? CW : 1;

// thr - 1 - votes of unit `p`: negative (its sign bit set) where the unit
// is satisfied.  `s` holds the inner units' satisfaction bits built so far
// (every child of p among them).
template <int CW, int NW>
__device__ __forceinline__ uint32_t unit_c(const LaneView& v, int p, const uint32_t (&s)[kSatWords<CW>],
                                           uint32_t a0, uint32_t a1) {
  const uint4 r = v.rec[p];
  int c = (int)r.z - __popc(a0 & r.x);
  if constexpr (NW > 1) c -= __popc(a1 & r.y);
  if constexpr (CW > 0) {
    if (r.w) {
      const ChildRow<CW> cw = child_row<CW>(v.child + CW * p);
#pragma unroll
      for (int k = 0; k < CW; ++k)
        if (CW == 1 || ((r.w >> k) & 1)) c -= __popc(s[k] & cw.w[k]);
    }
  }
  return (uint32_t)c;
}

// Satisfied-node words of availability (a0, a1), before the AND with it:
// the inner units in height order into `s`, then each node word built by
// a funnel shift of its units' sign bits, highest unit first (no node unit
// is a child, so their order is free).
template <int CW, int NW>
__device__ __forceinline__ uint2 lane_node_sat(const LaneView& v, uint32_t a0, uint32_t a1) {
  uint32_t s[kSatWords<CW>];
#pragma unroll
  for (int j = 0; j < kSatWords<CW>; ++j) s[j] = 0u;
  if constexpr (CW > 0) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int end = min(32 * j + 32, v.inner_end);
      for (int p = max(32 * j, v.n); p < end; ++p) s[j] |= (unit_c<CW, NW>(v, p, s, a0, a1) >> 31) << (p & 31);
    }
  }
  uint32_t w[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    w[j] = 0u;
    for (int p = min(32 * j + 32, v.n) - 1; p >= 32 * j; --p)
      w[j] = __funnelshift_l(unit_c<CW, NW>(v, p, s, a0, a1), w[j], 1);
  }
  if constexpr (NW > 1) return make_uint2(w[0], w[1]);
  return make_uint2(w[0], 0u);
}

// Each lane's greatest fixpoint from (a0, a1), frozen words (f0, f1)
// always available; the warp loops until no lane's words change.
template <int CW, int NW>
__device__ __forceinline__ void lane_fixpoint(const LaneView& v, uint32_t& a0, uint32_t& a1, uint32_t f0,
                                              uint32_t f1) {
  for (;;) {
    const uint2 s = lane_node_sat<CW, NW>(v, a0 | f0, a1 | f1);
    const uint32_t n0 = s.x & a0, n1 = s.y & a1;
    const bool changed = n0 != a0 || n1 != a1;
    a0 = n0;
    a1 = n1;
    if (!__any_sync(kFull, changed)) return;
  }
}

template <int CW, int NW>
__global__ void __launch_bounds__(32 * kLaneWarps)
bitset_lane_kernel(LaneTables t, const int* __restrict__ lo_nodes, int lo_bits, uint64_t hi_mask,
                   uint64_t scc_mask, uint64_t frozen, long long start, long long rows,
                   int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* decode = reinterpret_cast<uint2*>(smem);
  uint4* rec_q = reinterpret_cast<uint4*>(smem + kDecodeBytes);
  uint4* rec_d = rec_q + t.n_units;
  uint32_t* child = reinterpret_cast<uint32_t*>(rec_d + t.n_units);
  // decode[256 k + v]: the nodes that byte k of an index equal to v enables.
  for (int e = threadIdx.x; e < kDecodeEntries; e += blockDim.x) {
    const int k = e >> 8, val = e & 255;
    uint64_t m = 0;
    for (int i = 0; i < 8; ++i) {
      const int bit = 8 * k + i;
      if (bit < lo_bits && ((val >> i) & 1)) m |= 1ull << lo_nodes[bit];
    }
    decode[e] = make_uint2((uint32_t)m, (uint32_t)(m >> 32));
  }
  for (int i = threadIdx.x; i < t.n_units; i += blockDim.x) {
    rec_q[i] = t.rec_q[i];
    rec_d[i] = t.rec_d[i];
  }
  for (int i = threadIdx.x; i < CW * t.n_units; i += blockDim.x) child[i] = t.child[i];
  __syncthreads();

  const LaneView vq{rec_q, child, t.n, t.inner_end}, vd{rec_d, child, t.n, t.inner_end};
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t hi0 = (uint32_t)hi_mask, hi1 = (uint32_t)(hi_mask >> 32);
  const uint32_t scc0 = (uint32_t)scc_mask, scc1 = (uint32_t)(scc_mask >> 32);
  const uint32_t fr0 = (uint32_t)frozen, fr1 = (uint32_t)(frozen >> 32);
  const long long groups = (rows + 31) >> 5, stride = (long long)gridDim.x * warps;
  int best = kMiss;
  for (long long g = (long long)blockIdx.x * warps + warp; g < groups; g += stride) {
    const int base = (int)(start + (g << 5));
    if (base >= best) break;  // a smaller hit is already in
    int cur = 0;  // the current minimum, for the next group: its load overlaps this one
    if (lane == 0) cur = *reinterpret_cast<volatile int*>(out);
    uint32_t a0 = 0u, a1 = 0u;  // rows past the end: nothing available, no hit
    if ((g << 5) + lane < rows) {
      const uint32_t idx = (uint32_t)base + lane;  // bits at or above lo_bits decode to nothing
      const uint2 b0 = decode[idx & 255], b1 = decode[256 + ((idx >> 8) & 255)];
      const uint2 b2 = decode[512 + ((idx >> 16) & 255)], b3 = decode[768 + (idx >> 24)];
      a0 = hi0 | b0.x | b1.x | b2.x | b3.x;
      a1 = hi1 | b0.y | b1.y | b2.y | b3.y;
    }
    lane_fixpoint<CW, NW>(vq, a0, a1, 0u, 0u);
    const bool has_q = (a0 | a1) != 0u;
    bool hit = false;
    if (__any_sync(kFull, has_q)) {
      uint32_t d0 = has_q ? scc0 & ~a0 : 0u, d1 = has_q ? scc1 & ~a1 : 0u;
      lane_fixpoint<CW, NW>(vd, d0, d1, fr0, fr1);
      hit = (d0 | d1) != 0u;
    }
    const unsigned hits = __ballot_sync(kFull, hit);
    if (hits) {
      if (lane == 0) atomicMin(out, base + __ffs(hits) - 1);
      break;  // this warp's later groups hold larger indices
    }
    best = __shfl_sync(kFull, cur, 0);
  }
}

// ---- launches --------------------------------------------------------------

// Blocks of `threads` threads that fit one SM at once, times the SMs: looked
// up once per (device, kernel, shared memory, threads).  A kernel's dynamic
// shared memory limit only ever rises, so a cached shape keeps fitting.
cudaError_t blocks_per_card(const void* kernel, size_t smem, int threads, long long* cap) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t, int>, long long> known;
  static std::map<std::pair<int, const void*>, size_t> limit;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, kernel, smem, threads);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *cap = hit->second;
    return cudaSuccess;
  }
  size_t& lim = limit.emplace(std::make_pair(dev, kernel), 48 * 1024).first->second;
  if (smem > lim) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    lim = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // one block does not fit an SM
  *cap = known[key] = (long long)sms * per_sm;
  return cudaSuccess;
}

template <bool kResident>
cudaError_t launch(const Tables& t, int warps, const int* lo_nodes, int lo_bits, uint64_t hi_mask,
                   uint64_t scc_mask, uint64_t frozen, long long start, long long rows, int* out,
                   cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  const size_t smem = smem_bytes(t, kResident, warps);
  long long cap = 0;
  cudaError_t err = blocks_per_card((const void*)bitset_sweep_kernel<kResident>, smem, 32 * warps, &cap);
  if (err != cudaSuccess) return err;
  const long long want = (rows + warps - 1) / warps;
  const int grid = (int)(want < cap ? want : cap);
  bitset_sweep_kernel<kResident><<<grid, 32 * warps, smem, stream>>>(
      t, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, start, rows, out);
  return cudaGetLastError();
}

template <int CW, int NW>
cudaError_t launch_lanes(const LaneTables& t, const int* lo_nodes, int lo_bits, uint64_t hi_mask,
                         uint64_t scc_mask, uint64_t frozen, long long start, long long rows, int* out,
                         cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  const size_t smem = lane_smem_bytes(t.n_units, CW);
  long long cap = 0;
  cudaError_t err = blocks_per_card((const void*)bitset_lane_kernel<CW, NW>, smem, 32 * kLaneWarps, &cap);
  if (err != cudaSuccess) return err;
  const long long want = ((rows + 31) / 32 + kLaneWarps - 1) / kLaneWarps;
  const int grid = (int)(want < cap ? want : cap);
  bitset_lane_kernel<CW, NW><<<grid, 32 * kLaneWarps, smem, stream>>>(
      t, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, start, rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory one block of `warps` warps takes (the wrapper checks it
// against the opt-in limit before any launch).
extern "C" long long qi_bitset_sweep_smem(int units_pad, int n_words, int resident, int warps) {
  Tables t{};
  t.units_pad = units_pad;
  t.uw = units_pad / 32;
  t.n_words = n_words;
  return (long long)smem_bytes(t, resident != 0, warps);
}

// Returns a cudaError_t (0 on success).  Tables as kernels/bitset_sweep_cuda.py
// `bitset_tables` builds them; `resident` picks the instance.
extern "C" int qi_bitset_sweep(const void* units, const void* ranges, const void* words,
                               int n_words, int units_pad, int nw, int rounds, int resident,
                               int warps, const int* lo_nodes, int lo_bits, uint64_t hi_mask,
                               uint64_t scc_mask, uint64_t frozen, long long start,
                               long long rows, int* out, void* cuda_stream) {
  const Tables t{static_cast<const uint4*>(units), static_cast<const int2*>(ranges),
                 static_cast<const uint32_t*>(words), n_words, units_pad, units_pad / 32, nw,
                 rounds};
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  return resident ? launch<true>(t, warps, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, start, rows, out, s)
                  : launch<false>(t, warps, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, start, rows, out, s);
}

// Shared memory of one lane-instance block (the wrapper checks it against
// its own count).
extern "C" long long qi_bitset_lanes_smem(int n_units, int cw) {
  return (long long)lane_smem_bytes(n_units, cw);
}

// Returns a cudaError_t (0 on success).  Tables as kernels/bitset_sweep_cuda.py
// `lane_tables` builds them: (cw, nw) one of (0, 1), (0, 2), (1, 1), (2, 1),
// (2, 2), (4, 1), (4, 2).
extern "C" int qi_bitset_sweep_lanes(const void* rec_q, const void* rec_d, const void* child, int n,
                                     int inner_end, int n_units, int cw, int nw, const int* lo_nodes,
                                     int lo_bits, uint64_t hi_mask, uint64_t scc_mask, uint64_t frozen,
                                     long long start, long long rows, int* out, void* cuda_stream) {
  const LaneTables t{static_cast<const uint4*>(rec_q), static_cast<const uint4*>(rec_d),
                     static_cast<const uint32_t*>(child), n, inner_end, n_units};
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
#define QI_LANES(C, N) \
  if (cw == C && nw == N) return launch_lanes<C, N>(t, lo_nodes, lo_bits, hi_mask, scc_mask, frozen, start, rows, out, s)
  QI_LANES(0, 1);
  QI_LANES(0, 2);
  QI_LANES(1, 1);
  QI_LANES(2, 1);
  QI_LANES(2, 2);
  QI_LANES(4, 1);
  QI_LANES(4, 2);
#undef QI_LANES
  return cudaErrorInvalidValue;
}
