// In-kernel compaction probe (P2): what it costs to pack the live
// walkers of a tile inside the kernel, against a copy-only kernel with
// the same reads and writes.
//
// Replaces the Pallas TPU probe bench/pack_probe.py (make_kernel with
// do_pack, over _pack_tile's prefix sum and butterfly shifts; and the
// copy-only make_kernel without it).  The plain torch versions are
// probes/compact.py::probe_compact_plain / probe_copy_plain.
//
// A tile is 1024 consecutive int32 displacements; a lane is live when
// its displacement is not 0.  Each lane carries `m` payload planes, as
// the TPU probe does: the displacement and m - 1 copies of the tile
// shifted left by 1..m-1 lanes (zeros shifted in), folded with xor into
// the one value written.
//
// * probe_copy: out[i] = the lane's folded value, in place; counts[tile]
//   = the tile's first displacement.  No compaction.
// * probe_compact: the live lanes' folded values, in lane order, at the
//   front of the tile's own output range, zeros behind them;
//   counts[tile] = the number of live lanes.  This is what the TPU
//   kernel computes.
// * probe_compact_atomic: the same pack appended to ONE global buffer,
//   a tile taking its range with one atomicAdd on a device counter:
//   what the compacted plan scan's phase A does (plan_scan.cu).  Lanes
//   are ordered inside a tile and tiles are unordered.
//
// What bounds it on an H100: bytes.  4 B read and 4 B written a lane.
// The first port gave a tile one 1,024-thread block of 4-byte loads and
// stores, two block barriers in the pack and one even in the copy (the
// folds read the tile from shared memory): the copy ran at half its
// bound.  This design:
//
// * 16-byte loads and stores: a thread holds 4 consecutive lanes, a
//   tile is 256 threads, one block; persistent blocks (the resident
//   blocks of the card, occupancy API) take tiles grid-stride and load
//   the next tile's word before they work on this one.
// * Folds across lanes in registers: a lane's planes reach at most 7
//   lanes on, into the next two threads' words, which come by shuffles;
//   the last two lanes of a warp read the next warp's words from memory
//   (they are in L1 or L2: that warp loads them too).  No shared memory
//   and no barrier in the copy.
// * The pack's scan: a thread's live count (0..4) is three bits, so
//   three ballots and their popcounts give its exclusive offset inside
//   the warp; the 8 warp totals cross the block through shared memory
//   (two buffers by tile parity) behind ONE barrier.  Live values are
//   stored at their slots straight from registers, the zeros behind
//   them in 16-byte stores.  The atomic pack takes its tile's range
//   with one atomicAdd, which costs a second barrier to share.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_tile.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = wt::kThreads;  // a tile: 4 lanes a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 8;
static_assert(kTile == 4 * kThreads, "a thread's lanes are one int4");
static_assert(3 + kMaxPlanes - 1 < 12, "a lane's planes reach two threads on");

enum Mode { kCopy, kPack, kPackAtomic };

__device__ __forceinline__ int4 shfl_down4(int4 v, int d) {
  return make_int4(__shfl_down_sync(0xffffffffu, v.x, d),
                   __shfl_down_sync(0xffffffffu, v.y, d),
                   __shfl_down_sync(0xffffffffu, v.z, d),
                   __shfl_down_sync(0xffffffffu, v.w, d));
}

// The folded values of thread t's lanes 4t..4t+3 of the tile at `in`
// (x = its own word): each lane xor its m - 1 right neighbours, zeros
// past the tile's end.  Every lane of the warp calls it.
__device__ __forceinline__ int4 fold(int4 x, int m, const int4* in, int t,
                                     int lane) {
  if (m == 1) return x;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4 n1 = shfl_down4(x, 1);  // thread t + 1's lanes
  int4 n2 = m > 5 ? shfl_down4(x, 2) : zero;  // t + 2's: planes past 5
  if (lane == 31) n1 = t + 1 < kThreads ? __ldg(in + t + 1) : zero;
  if (m > 5 && lane >= 30) n2 = t + 2 < kThreads ? __ldg(in + t + 2) : zero;
  const int w[12] = {x.x, x.y, x.z, x.w, n1.x, n1.y, n1.z, n1.w,
                     n2.x, n2.y, n2.z, n2.w};
  int f[4] = {w[0], w[1], w[2], w[3]};
#pragma unroll
  for (int j = 1; j < kMaxPlanes; ++j)
    if (j < m) {
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] ^= w[k + j];
    }
  return make_int4(f[0], f[1], f[2], f[3]);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
probe_compact_kernel(const int* __restrict__ disp, int tiles, int m,
                     int* __restrict__ out, int* __restrict__ counts) {
  __shared__ int warp_tot[2][kWarps];
  __shared__ int tile_base[2];
  const int t = threadIdx.x;
  const int lane = t & 31, wid = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int4* in4 = reinterpret_cast<const int4*>(disp);
  const int grid = static_cast<int>(gridDim.x);
  int4 x = __ldg(in4 + static_cast<long long>(blockIdx.x) * kThreads + t);
  for (int tile = blockIdx.x, k = 0; tile < tiles; tile += grid, k ^= 1) {
    const long long at = static_cast<long long>(tile) * kThreads;
    int4 next = make_int4(0, 0, 0, 0);  // the next tile's word, early
    if (tile + grid < tiles)
      next = __ldg(in4 + at + static_cast<long long>(grid) * kThreads + t);
    const int4 f = fold(x, m, in4 + at, t, lane);
    int4* out4 = reinterpret_cast<int4*>(out) + at;
    if (kMode == kCopy) {
      out4[t] = f;
      if (t == 0) counts[tile] = x.x;
      x = next;
      continue;
    }
    // the thread's live lanes, its exclusive offset in the warp (three
    // ballots of its count's bits) and the warp's total
    const bool l0 = x.x != 0, l1 = x.y != 0, l2 = x.z != 0, l3 = x.w != 0;
    const int c = l0 + l1 + l2 + l3;
    const unsigned b0 = __ballot_sync(0xffffffffu, c & 1);
    const unsigned b1 = __ballot_sync(0xffffffffu, c & 2);
    const unsigned b2 = __ballot_sync(0xffffffffu, c & 4);
    int slot = __popc(b0 & lt) + 2 * __popc(b1 & lt) + 4 * __popc(b2 & lt);
    if (lane == 0)
      warp_tot[k][wid] = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int n = warp_tot[k][v];
      if (v < wid) slot += n;
      total += n;
    }
    int* dst = out + 4 * at;
    if (kMode == kPackAtomic) {
      if (t == 0) tile_base[k] = total ? atomicAdd(counts, total) : 0;
      __syncthreads();
      dst = out + tile_base[k];
    }
    if (l0) dst[slot++] = f.x;
    if (l1) dst[slot++] = f.y;
    if (l2) dst[slot++] = f.z;
    if (l3) dst[slot] = f.w;
    if (kMode == kPack) {  // zeros behind the live values
      const int q = 4 * t;
      if (q >= total) {
        out4[t] = make_int4(0, 0, 0, 0);
      } else if (q + 4 > total) {
        for (int j = total; j < q + 4; ++j) dst[j] = 0;
      }
      if (t == 0) counts[tile] = total;
    }
    x = next;
  }
}

template <int kMode>
int launch(const int* disp, int n, int m, int* out, int* counts,
           void* stream) {
  static int known[wt::kMaxDevices];
  if (n < 0 || n % kTile || m < 1 || m > kMaxPlanes || !out || !counts ||
      reinterpret_cast<uintptr_t>(disp) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int tiles = n / kTile;
  int grid = 0;
  const cudaError_t e = wt::resident_blocks(probe_compact_kernel<kMode>, 0,
                                            known, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_compact_kernel<kMode>
      <<<tiles < grid ? tiles : grid, kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(disp, tiles, m, out, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// disp, out: int32 [n], 16-byte aligned, n a multiple of 1024; counts:
// int32 [n / 1024].
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
