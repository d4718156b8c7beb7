// Compacted plan scan, phase B (K6): the steps after the compaction cut,
// for the walkers that survived to it, merged into phase A's outputs.
//
// Replaces the Pallas TPU kernel phfpfac_tpu/ops/pallas_plan.py::
// _make_planb_kernel together with the XLA glue and merge around it
// (_phase_b, and the scatter-adds of _plan_scan_bitmap_compact /
// _plan_scan_count_compact).  The plain torch version is
// ops/plan.py::plan_scan_compact_plain.
//
// Phase A (plan_scan.cu, plan_scan_compact_a) leaves (pos, disp) of the
// live walkers in cap-sized buffers and their true number in a device
// counter.  One thread per survivor slot i < min(count, cap): it reads
// its walker, recomputes the segment room from pos, walks the deep
// steps with plan_step.cuh's step body over the raw step rows, reading
// its windows at pairs[pos + o] itself, and then
//   bitmap mode: bits[pos] |= deep, cnt[pos] += popc(deep)  (a position
//     holds one walker, and deep and shallow bits are disjoint, so no
//     atomics are needed);
//   count mode: adds popc(deep) for pos >= shift to the 64-bit total,
//     one atomic per block.
// The grid is sized by cap and the count is read on the device, so the
// host never waits between the phases.  With count > cap the buffers
// hold only cap walkers: the result is then incomplete by design and
// the caller must rescan (ops/plan.py verify / check_overflow).
//
// What it needs on an H100: per survivor 8 B of (pos, disp), one int32
// for each window it reads, the dependent table gathers of the deep
// steps (L2-resident tables), and in bitmap mode a read and a write of
// one word of bits and of cnt.  Survivors are scattered, so the card
// moves up to a 32 B sector for each of those words.  Survivors are a
// few percent of the positions, so the kernel is small beside phase A;
// what the compaction buys is full warps in the deep steps.

#include "plan_step.cuh"

namespace {

using namespace plan;

template <bool kBitmap, bool kSeg>
__global__ void __launch_bounds__(kThreads)
planb_scan_kernel(const int* __restrict__ pairs,
                  const int* __restrict__ packed,
                  const int* __restrict__ side,
                  const int* __restrict__ steps_g, int n_steps, int cb,
                  int p0_miss, int seg, int halo, int cap,
                  const int* __restrict__ surv_pos,
                  const int* __restrict__ surv_disp,
                  const int* __restrict__ surv_count, int* __restrict__ cnt,
                  int* __restrict__ bits, int shift,
                  const unsigned long long* __restrict__ prev,
                  unsigned long long* __restrict__ total) {
  __shared__ int steps[kMaxSteps * kFields];
  __shared__ unsigned int warp_sums[kThreads / 32];
  for (int i = threadIdx.x; i < n_steps * kFields; i += blockDim.x)
    steps[i] = steps_g[i];
  __syncthreads();

  const int n = min(*surv_count, cap);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t deep = 0;
  int pos = 0;
  if (i < n) {
    pos = surv_pos[i];
    uint32_t disp = static_cast<uint32_t>(surv_disp[i]);
    const int room = kSeg ? segment_room(pos, seg, halo) : 0;
    walk_steps<kSeg>(steps, n_steps, pairs, pos, room, cb,
                     static_cast<uint32_t>(p0_miss), packed, side, disp,
                     deep);
    if (kBitmap && deep) {
      bits[pos] |= static_cast<int>(deep);
      cnt[pos] += __popc(deep);
    }
  }
  if (!kBitmap) {
    const int sh = count_shift(shift, prev);
    block_add((i < n && pos >= sh) ? __popc(deep) : 0u, warp_sums, total);
  }
}

}  // namespace

// `steps` points at the first row after the cut and `n_steps` counts
// the rows from there.  Bitmap mode updates cnt/bits in place; count
// mode adds to *total (which already holds phase A's sum).
extern "C" int planb_scan(const int* pairs, const int* packed,
                          const int* side, const int* steps, int n_steps,
                          int cb, int p0_miss, int seg, int halo, int cap,
                          const int* surv_pos, const int* surv_disp,
                          const int* surv_count, int emit_bitmap, int* cnt,
                          int* bits, int shift, const long long* prev,
                          long long* total, void* stream) {
  if (n_steps > kMaxSteps || cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_steps <= 0) return 0;
  const dim3 grid((cap + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* up = reinterpret_cast<const unsigned long long*>(prev);
  auto* ut = reinterpret_cast<unsigned long long*>(total);
#define PLANB_LAUNCH(B, S)                                                  \
  planb_scan_kernel<B, S><<<grid, kThreads, 0, st>>>(                       \
      pairs, packed, side, steps, n_steps, cb, p0_miss, seg, halo, cap,     \
      surv_pos, surv_disp, surv_count, cnt, bits, shift, up, ut)
  const bool s = seg > 0;
  if (emit_bitmap) {
    if (s) PLANB_LAUNCH(true, true); else PLANB_LAUNCH(true, false);
  } else {
    if (s) PLANB_LAUNCH(false, true); else PLANB_LAUNCH(false, false);
  }
#undef PLANB_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
