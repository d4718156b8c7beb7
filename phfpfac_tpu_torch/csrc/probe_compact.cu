// In-kernel compaction probe (P2): what it costs to pack the live
// walkers of a block inside the kernel, against a copy-only kernel with
// the same reads and writes.
//
// Replaces the Pallas TPU probe bench/pack_probe.py (make_kernel with
// do_pack, over _pack_tile's prefix sum and butterfly shifts; and the
// copy-only make_kernel without it).  The plain torch versions are
// probes/compact.py::probe_compact_plain / probe_copy_plain.
//
// A tile is 1024 consecutive int32 displacements, one per thread of a
// 1024-thread block; a lane is live when its displacement is not 0.
// Each lane carries `m` payload planes, as the TPU probe does: the
// displacement and m - 1 copies of the tile shifted left by 1..m-1
// lanes (zeros shifted in), folded with xor into the one value written.
//
// * probe_copy: out[i] = the lane's folded value, in place; counts[tile]
//   = the tile's first displacement.  No compaction.
// * probe_compact: the live lanes' folded values, in lane order, at the
//   front of the tile's own output range, zeros behind them;
//   counts[tile] = the number of live lanes.  This is what the TPU
//   kernel computes.  Hopper form: ballot per warp, a shuffle scan over
//   the 32 warp counts, the pack staged through shared memory so that
//   the tile is written back with coalesced stores.
// * probe_compact_atomic: the same pack appended to ONE global buffer,
//   a block taking its range with one atomicAdd on a device counter:
//   what the compacted plan scan's phase A does (plan_scan.cu).  Lanes
//   are ordered inside a tile and tiles are unordered.
//
// What bounds it on an H100: bytes.  4 B read and 4 B written per lane;
// the ballot, two barriers and the staging add no traffic, and the
// measured difference to probe_copy is their price.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kWarps = kTile / 32;
constexpr int kMaxPlanes = 8;

enum Mode { kCopy, kPack, kPackAtomic };

template <int kMode>
__global__ void __launch_bounds__(kTile)
probe_compact_kernel(const int* __restrict__ disp, int m,
                     int* __restrict__ out, int* __restrict__ counts) {
  __shared__ int tile[kTile + kMaxPlanes];
  __shared__ int packed[kTile];
  __shared__ int warp_base[kWarps];
  __shared__ int total, block_base;
  const int i = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int d = disp[base + i];
  tile[i] = d;
  if (i < kMaxPlanes) tile[kTile + i] = 0;
  __syncthreads();
  int fold = d;
  for (int j = 1; j < m; ++j) fold ^= tile[i + j];

  if (kMode == kCopy) {
    out[base + i] = fold;
    if (i == 0) counts[blockIdx.x] = d;
    return;
  }

  const bool live = d != 0;
  const unsigned int ballot = __ballot_sync(0xffffffffu, live);
  const int lane = i & 31, wid = i >> 5;
  if (lane == 0) warp_base[wid] = __popc(ballot);
  __syncthreads();
  if (wid == 0) {  // exclusive scan of the 32 warp counts
    const int c = warp_base[lane];
    int incl = c;
    for (int s = 1; s < 32; s <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += up;
    }
    warp_base[lane] = incl - c;
    if (lane == 31) {
      total = incl;
      if (kMode == kPackAtomic) block_base = incl ? atomicAdd(counts, incl) : 0;
    }
  }
  __syncthreads();
  const int slot = warp_base[wid] + __popc(ballot & ((1u << lane) - 1u));
  if (kMode == kPackAtomic) {
    if (live) out[block_base + slot] = fold;
    return;
  }
  if (live) packed[slot] = fold;
  __syncthreads();
  out[base + i] = i < total ? packed[i] : 0;
  if (i == 0) counts[blockIdx.x] = total;
}

template <int kMode>
int launch(const int* disp, int n, int m, int* out, int* counts,
           void* stream) {
  if (n < 0 || n % kTile || m < 1 || m > kMaxPlanes || !out || !counts)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  probe_compact_kernel<kMode>
      <<<n / kTile, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
          disp, m, out, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// disp, out: int32 [n], n a multiple of 1024; counts: int32 [n / 1024].
extern "C" int probe_copy(const int* disp, int n, int m, int* out,
                          int* counts, void* stream) {
  return launch<kCopy>(disp, n, m, out, counts, stream);
}

extern "C" int probe_compact(const int* disp, int n, int m, int* out,
                             int* counts, void* stream) {
  return launch<kPack>(disp, n, m, out, counts, stream);
}

// out: int32 [n], filled from the front in tile-arrival order; counts:
// int32 [1], zeroed by the caller, the number of live lanes afterwards.
extern "C" int probe_compact_atomic(const int* disp, int n, int m, int* out,
                                    int* counts, void* stream) {
  return launch<kPackAtomic>(disp, n, m, out, counts, stream);
}
