// Lane-packed quorum-intersection sweeps for Hopper (sm_90a) on the tensor
// cores, with a plain C interface loaded through ctypes
// (kernels/packed_cuda.py).  One kernel, three instances:
//
// - packed_sweep_dense replaces the JAX package's Pallas kernel
//   `pallas_packed_program_factory` (backends/tpu/pallas_sweep.py:343, kernel
//   at :404) and its XLA twin `kernels.packed_sweep_program_factory`
//   (backends/tpu/kernels.py:445): votes as `wgmma` u8 products over byte
//   tiles (circuit_mma.cuh, engine U8), with the tables resident in shared
//   memory or, when they do not fit, streamed through it;
// - packed_sweep_bitset replaces `pallas_bitset_program_factory`
//   (pallas_sweep.py:556, kernel at :622): 0/1 votes as `mma.sync` b1
//   and-popc products over `bitset_encode`'s uint32 words (engine B1).  On
//   the same 0/1 packs the U8 instance ran slower (PERF.md §6).
//
// The circuit is K <= 16 SCC-restricted circuits fused block-diagonally
// (encode.pack_circuits): group g owns lanes [g*slot, g*slot + size_g), its
// local node 0 fixed out of the enumeration.  A program covers `rows` rows;
// row r decodes candidate starts[g] + r for EVERY group at once:
//   S     = for each g, bits [0, size_g - 1) of starts[g] + r on lanes
//           [base_g, base_g + size_g - 1), base_g = g*slot + 1
//   Q     = greatest fixpoint of S under the Q thresholds
//   D     = greatest fixpoint of scc & ~Q under the D thresholds (Q6 fold),
//           over the lanes of the groups whose Q is not empty
//   hit_g = (Q & group_g) != 0 && (D & group_g) != 0
// and out[g] is the smallest starts[g] + r with hit_g (atomicMin into a (K,)
// int32 vector the wrapper initialised to INT32_MAX).
//
// What bounds it on this card: operations.  The tables are at most about a
// megabyte and the output K int32, while every row runs two fixpoints of
// (depth + 1) vote products over the units.  The earlier design (one thread
// per row, a popcount per unit and word) ran on the integer pipe at about 1%
// of the int8 tensor-core bound.  This one puts the products on the tensor
// cores: a block (one warpgroup) takes 64 rows at a time, as the Pallas
// kernel takes a block of rows, and iterates the tile until no row changes,
// the block-level early exit of the Pallas `while_loop`.  Only the k-slabs
// the host names per 32-unit chunk are multiplied, so the block-diagonal
// zeros of other groups are skipped, and the D probe is skipped for a tile
// with no candidate Q.  Blocks are persistent and grid-stride over tiles;
// the tables load into shared memory once per block.

#include <map>
#include <mutex>
#include <utility>

#include "circuit_mma.cuh"

namespace {

using namespace qi_mma;

template <class E>
__global__ void __launch_bounds__(kThreads)
packed_kernel(const void* __restrict__ mtab, const void* __restrict__ ctab,
              const int* __restrict__ thr_q, const int* __restrict__ thr_d,
              const __grid_constant__ Params p, long long rows, int* __restrict__ out) {
  using T = typename E::T;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ uint32_t qrows[2][kRows], drows[2][kRows];
  __shared__ int best[kMaxGroups];
  const Layout lay = make_layout(E::kB1, E::kStream, p);
  const int tid = threadIdx.x;

  // Tables (resident instances) and thresholds into shared memory, tiles zeroed.
  E eng;
  if (E::kStream) {
    eng.init(mtab, ctab, smem + lay.stage);
  } else {
    for (unsigned i = tid; i < p.mbytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem + lay.mtab)[i] = static_cast<const uint4*>(mtab)[i];
    for (unsigned i = tid; i < p.cbytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(smem + lay.ctab)[i] = static_cast<const uint4*>(ctab)[i];
    eng.init(smem + lay.mtab, smem + lay.ctab, nullptr);
  }
  for (unsigned i = tid; i < (lay.thr_q - lay.a0) / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem + lay.a0)[i] = make_uint4(0, 0, 0, 0);
  int* sq = reinterpret_cast<int*>(smem + lay.thr_q);
  int* sd = reinterpret_cast<int*>(smem + lay.thr_d);
  for (int u = tid; u < p.units; u += kThreads) {
    sq[u] = thr_q[u];
    sd[u] = thr_d[u];
  }
  if (tid < kMaxGroups) best[tid] = kMiss;
  fence_async_smem();
  __syncthreads();

  Tile<E> tile{eng,
               {reinterpret_cast<T*>(smem + lay.a0), reinterpret_cast<T*>(smem + lay.a1)},
               reinterpret_cast<T*>(smem + lay.s), p.kcols / 32, &p};
  const long long tiles = (rows + kRows - 1) / kRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    // The wrapper keeps starts[g] + rows <= 2^31; bits at or above
    // size_g - 1 decode to nothing (overshoot aliases, masked on the host).
    // Rows at or past `rows` decode to the empty set and cannot hit.
    if (!tile.fill(tile.a[0], [&](int r, int seg) {
          uint32_t w = 0;
          if (row0 + r < rows)
            for (int g = 0; g < p.k; ++g)
              w |= place((uint64_t)(p.start[g] + row0 + r) & ((1ull << p.bits[g]) - 1), p.base[g],
                         seg);
          return w;
        }))
      continue;
    int cur = tile.fixpoint(0, sq);
    if (!tile.group_rows(tile.a[cur], qrows)) continue;  // no Q in the tile: no D probe
    const T* q = tile.a[cur];
    // D starts from scc & ~Q on the lanes of the groups whose Q is not empty.
    if (!tile.fill(tile.a[cur ^ 1], [&](int r, int seg) {
          const uint32_t live = qrows[0][r] | qrows[1][r];
          uint32_t lanes = 0;
          for (int g = 0; g < p.k; ++g)
            if (live >> g & 1) lanes |= p.gmask[g][seg];
          return p.scc[seg] & ~E::load_word(q, kLaneWords, r, seg) & lanes;
        }))
      continue;
    cur = tile.fixpoint(cur ^ 1, sd);
    tile.group_rows(tile.a[cur], drows);
    if (tid < kRows) {
      uint32_t hit = (qrows[0][tid] | qrows[1][tid]) & (drows[0][tid] | drows[1][tid]);
      while (hit) {
        const int g = __ffs(hit) - 1;
        hit &= hit - 1;
        atomicMin(best + g, (int)(p.start[g] + row0 + tid));
      }
    }
  }
  __syncthreads();
  if (tid < p.k && best[tid] != kMiss) atomicMin(out + tid, best[tid]);
}

// Blocks of instance E the card holds at once at `smem` bytes.  The packed
// drive launches thousands of programs of a few shapes, so the answer is
// kept per (device, smem); the instance's shared-memory limit only grows,
// which keeps every cached size launchable from any host thread.
template <class E>
cudaError_t resident_blocks(size_t smem, long long* cap) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, long long> known;
  static std::map<int, size_t> limit;  // per device; the default is 48 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find({dev, smem});
  if (hit != known.end()) {
    *cap = hit->second;
    return cudaSuccess;
  }
  size_t& lim = limit.emplace(dev, 48 * 1024).first->second;
  if (smem > lim) {
    err = cudaFuncSetAttribute(packed_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    lim = smem;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, packed_kernel<E>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // the tables do not fit one block
  *cap = known[{dev, smem}] = (long long)sms * per_sm;
  return cudaSuccess;
}

template <class E>
cudaError_t launch(const void* mtab, const void* ctab, const int* thr_q, const int* thr_d,
                   const Params& p, long long rows, int* out, cudaStream_t stream) {
  const size_t smem = make_layout(E::kB1, E::kStream, p).end;
  long long cap = 0;
  const cudaError_t err = resident_blocks<E>(smem, &cap);
  if (err != cudaSuccess) return err;
  const long long tiles = (rows + kRows - 1) / kRows;
  const int grid = (int)(tiles < cap ? tiles : cap);
  if (grid < 1) return cudaSuccess;
  packed_kernel<E><<<grid, kThreads, smem, stream>>>(mtab, ctab, thr_q, thr_d, p, rows, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* qi_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One packed program.  engine: 0 = U8 (wgmma, tables resident), 1 = U8
// streamed, 2 = B1 (mma.sync and-popc).  Tables (packed_cuda.py) of mbytes
// and cbytes: U8 member and child byte blocks, the named ones only, or B1
// member words [units][4] and child words [units][kcols / 32]; thresholds
// [units] each.  Host arrays: starts, base, bits [k]; gmask [k][4] and scc
// [4] lane words; ranges [units / 32][4]; first [units / 32][2] (U8: each
// chunk's first member and child block).
// Returns a cudaError_t (0 on success).
extern "C" int qi_packed_sweep(int engine, const void* mtab, const void* ctab, const int* thr_q,
                               const int* thr_d, int k, const int* starts, const int* base,
                               const int* bits, const uint32_t* gmask, const uint32_t* scc,
                               int lanes, int units, int c0, int kcols, int depth, int mbytes,
                               int cbytes, const uint8_t* ranges, const uint16_t* first,
                               long long rows, int* out,
                               void* stream) {
  if (k < 1 || k > kMaxGroups || lanes < 32 || lanes > kMaxLanes || lanes % 32 ||
      units < lanes || units > kMaxChunks * kChunk || units % kChunk || c0 % kChunk ||
      kcols < 0 || kcols % 32)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.k = k;
  for (int g = 0; g < k; ++g) {
    if (bits[g] < 0 || bits[g] > 30) return (int)cudaErrorInvalidValue;
    p.start[g] = starts[g];
    p.base[g] = base[g];
    p.bits[g] = bits[g];
    for (int x = 0; x < kLaneWords; ++x) p.gmask[g][x] = gmask[g * kLaneWords + x];
  }
  for (int x = 0; x < kLaneWords; ++x) p.scc[x] = scc[x];
  p.lanes = lanes;
  p.units = units;
  p.c0 = c0;
  p.kcols = kcols;
  p.depth = depth;
  p.mbytes = mbytes;
  p.cbytes = cbytes;
  for (int c = 0; c < units / kChunk; ++c) {
    for (int x = 0; x < 4; ++x) p.range[c][x] = ranges[4 * c + x];
    for (int x = 0; x < 2; ++x) p.first[c][x] = first[2 * c + x];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (engine) {
    case 0:
      return (int)launch<U8<false>>(mtab, ctab, thr_q, thr_d, p, rows, out, s);
    case 1:
      return (int)launch<U8<true>>(mtab, ctab, thr_q, thr_d, p, rows, out, s);
    case 2:
      return (int)launch<B1>(mtab, ctab, thr_q, thr_d, p, rows, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
