// The plan walk's step chain over the raw step rows, walked by the
// compacted phase-B kernel (planb_scan.cu: the steps after the cut,
// survivors only), and the helpers it shares with the plan kernel
// (plan_scan.cu, which walks pre-decoded steps of its own: segment_room,
// count_shift, kMaxSteps).  Replaces phfpfac_tpu/ops/pallas_plan.py::
// _run_steps; the plain torch version is ops/plan.py::plan_steps_plain.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace plan {

constexpr int kFields = 11;  // ops/plan.py STEP_FIELDS
constexpr int kMaxSteps = 32;
constexpr int kThreads = 256;

enum Field { KIND, DEPTH0, OFF, NB, K0, S_OFF, S_NB, S_K0, S_NIBBLE, MISS,
             COL_BITS };

__device__ __forceinline__ int probe(const int* __restrict__ banks, int off,
                                     int nb, int k0, int idx) {
  const int b = idx >> 7;  // arithmetic: a negative idx misses
  if (b < k0 || b >= k0 + nb) return -1;
  return __ldg(banks + (off + b - k0) * 128 + (idx & 127));
}

// Chars a walker at pos may read before the segment cut.
__device__ __forceinline__ int segment_room(int pos, int seg, int halo) {
  return (pos & ~(seg - 1)) + seg + halo - pos;
}

// Walks `n_steps` rows of `steps` (shared memory) for the walker at
// `pos`, from displacement `disp`; sets the steps' fin bits in `out`.
// A walker stops when its displacement falls to `dead`; one that the
// segment cut stops before a step is set dead, as the plain version
// does, so a caller that hands `disp` on hands on live walkers only.
template <bool kSeg>
__device__ __forceinline__ void walk_steps(
    const int* __restrict__ steps, int n_steps,
    const int* __restrict__ pairs, int pos, int room, int cb, uint32_t dead,
    const int* __restrict__ packed, const int* __restrict__ side,
    uint32_t& disp, uint32_t& out) {
  const uint32_t cbm = (1u << cb) - 1u;
  const uint32_t pair_mask = (1u << (2 * cb)) - 1u;
  const uint32_t pair_fin = 1u << (2 * cb);
  for (int s = 0; s < n_steps && disp != dead; ++s) {
    const int* sp = steps + s * kFields;
    const int o = sp[DEPTH0] - 1;  // char offset of the step's window
    const uint32_t miss = static_cast<uint32_t>(sp[MISS]);
    if (kSeg && !(room > o)) {  // cut: the walk reads no further
      disp = miss;
      break;
    }
    const uint32_t cur = static_cast<uint32_t>(pairs[pos + o]);
    if (sp[KIND] == 0) {  // mono
      const int colb = sp[COL_BITS];
      uint32_t cmask, finm;
      int vsh;
      if (colb) {  // split step: only col_bits symbol bits verify
        cmask = (1u << colb) - 1u;
        finm = 1u << (colb + 1);
        vsh = colb + 2;
      } else {
        cmask = cbm;
        finm = 1u << cb;
        vsh = cb + 1;
      }
      const uint32_t sym = cur & cmask;
      const uint32_t g = static_cast<uint32_t>(
          probe(packed, sp[OFF], sp[NB], sp[K0],
                static_cast<int>(disp + sym)));
      const uint32_t gs = g & ((1u << vsh) - 1u);
      const bool fin = gs == (sym | finm);
      if (fin) out |= 1u << o;
      disp = (fin || gs == sym) ? (g >> vsh) : miss;
    } else {  // pair + side table
      const uint32_t g = static_cast<uint32_t>(
          probe(packed, sp[OFF], sp[NB], sp[K0],
                static_cast<int>(disp + cur)));
      const uint32_t a1 = cur & cbm;
      const uint32_t sidx = disp + a1;
      bool fin_mid;
      if (sp[S_NIBBLE]) {
        const uint32_t w = static_cast<uint32_t>(
            probe(side, sp[S_OFF], sp[S_NB], sp[S_K0],
                  static_cast<int>(sidx >> 3)));
        fin_mid = ((w >> ((sidx & 7u) << 2)) & 15u) == (a1 & 7u) + 1u;
      } else {
        const uint32_t w = static_cast<uint32_t>(
            probe(side, sp[S_OFF], sp[S_NB], sp[S_K0],
                  static_cast<int>(sidx >> 2)));
        fin_mid = ((w >> ((sidx & 3u) << 3)) & 255u) == a1 + 1u;
      }
      const uint32_t gs = g & (pair_mask | pair_fin);
      bool fin_end = gs == (cur | pair_fin);
      bool hit = fin_end || gs == cur;
      if (kSeg && !(room > o + 1)) {
        // cut between the pair's two chars: the mid completion
        // stands, the end match and the chain do not
        fin_end = false;
        hit = false;
      }
      if (fin_mid) out |= 1u << o;
      if (fin_end) out |= 1u << (o + 1);
      disp = hit ? (g >> (2 * cb + 1)) : miss;
    }
  }
}

// Count-mode reduction: adds the block's sum of `c` to *total with one
// atomic per block.  Every thread of the block calls it.
__device__ __forceinline__ void block_add(unsigned int c,
                                          unsigned int* warp_sums,
                                          unsigned long long* total) {
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xffffffffu, c, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    if (s) atomicAdd(total, s);
  }
}

// The shift of a count-mode scan: positions below it do not count.  A
// chained scan reads the previous scan's total on the device.
__device__ __forceinline__ int count_shift(
    int shift, const unsigned long long* __restrict__ prev) {
  if (!prev) return shift;
  return static_cast<int>((*prev + static_cast<unsigned>(shift)) & 1ull);
}

}  // namespace plan
