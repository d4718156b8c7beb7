// Warp tiles: the skeleton the stride-1 depth walk (depth_scan.cu, K2),
// the stride-2 pair walk (pair_scan.cu, K3) and the banked-PHF walks
// (phf_scan.cu, K4 and K5, which stage raw bytes with a loader of their
// own) share.  The plan kernel (plan_scan.cu, K1) follows the same design
// with its own copy.
//
// A warp walks kWarpTile positions at a time (kPer a lane) with shared
// memory of its own: a two-stage ring of the tile's staged words plus
// kHalo words past it, filled by 16-byte cp.async while the previous
// tile walks; the tile's fin bits out[]; a packed list of live walkers.
// No block barrier is taken during the walk.  A block's kWarps warp
// tiles make a block tile of kTile positions, and persistent blocks (the
// SMs x the resident blocks an SM takes, occupancy API, current device)
// take block tiles grid-stride.  Count mode sums in registers across
// tiles: one block reduction and one atomic per block per launch.
//
// Here: the cp.async ring, the probe over a pre-decoded table, the
// list's ballot slot, the tile's outputs, the count reduction and the
// persistent grid.  The compacted phase-B walk (planb_scan.cu, K6) and
// the compaction probe (probe_compact.cu, P2) take the last two.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wt {

constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;        // positions per lane of a warp's tile
constexpr int kWarpTile = 32 * kPer;       // positions per warp tile
constexpr int kTile = kWarps * kWarpTile;  // per block tile
constexpr int kHalo = 32;      // staged words a tile's windows read past it
constexpr int kMinBlocks = 5;  // resident blocks per SM (shared memory)
constexpr int kRing = kWarpTile + kHalo;  // staged words of one stage

static_assert(kWarpTile % 4 == 0 && kRing % 4 == 0,
              "a warp tile is whole 16-byte copies and stores");
static_assert(kWarpTile <= 256, "a list entry keeps its offset in 8 bits");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of the staged words of the warp tile at `start` and
// kHalo past them; every lane of the warp calls it.
__device__ __forceinline__ void load_tile(int* dst,
                                          const int* __restrict__ src,
                                          long long start, int lane) {
  const int4* s = reinterpret_cast<const int4*>(src + start);
  int4* d = reinterpret_cast<int4*>(dst);
  for (int i = lane; i < kRing / 4; i += 32) cp_async16(d + i, s + i);
}

// banks[(off + (idx >> 7) - k0) * 128 + (idx & 127)] inside k0 <= idx >> 7
// < k0 + nb, else ~0u (-1), from the table's ready operands base = off *
// 128, lo = k0 * 128, span = nb * 128: one subtract, one unsigned
// compare, one load.
__device__ __forceinline__ unsigned probe(const int* __restrict__ banks,
                                          unsigned base, unsigned lo,
                                          unsigned span, unsigned idx) {
  const unsigned u = idx - lo;
  return u < span ? static_cast<unsigned>(__ldg(banks + base + u)) : ~0u;
}

// The lanes with `live` set, in lane order: this lane's slot n + rank;
// `n` grows by their number.  Every lane of the warp calls it.
__device__ __forceinline__ int ballot_slot(bool live, int& n) {
  const unsigned m = __ballot_sync(0xffffffffu, live);
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
  const int slot = n + __popc(m & lt);
  n += __popc(m);
  return slot;
}

// The shift of a count-mode scan: positions below it do not count.  A
// chained scan reads the previous scan's total on the device.
__device__ __forceinline__ int count_shift(
    int shift, const unsigned long long* __restrict__ prev) {
  if (!prev) return shift;
  return static_cast<int>((*prev + static_cast<unsigned>(shift)) & 1ull);
}

// The warp tile's outputs from its out[]: cnt = popc and bits in 16-byte
// stores (bitmap mode), or the popcounts of positions >= sh added to
// `sum` (count mode).
template <bool kBitmap>
__device__ __forceinline__ void tile_outputs(const unsigned* out,
                                             long long start, int lane,
                                             int sh, int* __restrict__ cnt,
                                             int* __restrict__ bits,
                                             unsigned long long& sum) {
  const uint4* out4 = reinterpret_cast<const uint4*>(out);
#pragma unroll
  for (int q = lane; q < kWarpTile / 4; q += 32) {
    const uint4 o = out4[q];
    if (kBitmap) {
      reinterpret_cast<int4*>(cnt + start)[q] =
          make_int4(__popc(o.x), __popc(o.y), __popc(o.z), __popc(o.w));
      reinterpret_cast<uint4*>(bits + start)[q] = o;
    } else {
      const long long p4 = start + 4 * q;
      sum += (p4 >= sh ? __popc(o.x) : 0) + (p4 + 1 >= sh ? __popc(o.y) : 0) +
             (p4 + 2 >= sh ? __popc(o.z) : 0) +
             (p4 + 3 >= sh ? __popc(o.w) : 0);
    }
  }
}

// Count mode, after the last tile: the block's sum to *total, one atomic
// per block.  Every thread of the block calls it.
__device__ __forceinline__ void block_total(unsigned long long sum,
                                            unsigned long long* warp_sums,
                                            unsigned long long* total) {
  for (int d = 16; d > 0; d >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
    if (t) atomicAdd(total, t);
  }
}

// Resident blocks per SM of `kern` with `smem` bytes of dynamic shared
// memory, on the current device.
template <typename Kernel>
cudaError_t occupancy(Kernel kern, int smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads,
                                                       smem);
}

constexpr int kMaxDevices = 64;

// The resident blocks of `kern` (kThreads a block, `smem` bytes of
// dynamic shared memory) on the whole current device: the SMs x the
// blocks an SM takes, asked once per device and kept in `known`, one
// array per kernel.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kern, int smem, int* known,
                            int* resident) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && known[dev]) {
    *resident = known[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = occupancy(kern, smem, &per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = sms * per_sm;
  if (dev < kMaxDevices) known[dev] = *resident;
  return cudaSuccess;
}

// The persistent grid of `kern` for `n_pos` positions: one block per
// block tile, at most the resident blocks of the whole current device.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kern, int smem, int n_pos, int* known,
                            int* grid) {
  int resident = 0;
  const cudaError_t e = resident_blocks(kern, smem, known, &resident);
  if (e != cudaSuccess) return e;
  const int tiles = (n_pos + kTile - 1) / kTile;
  *grid = tiles < resident ? tiles : resident;
  return cudaSuccess;
}

}  // namespace wt
