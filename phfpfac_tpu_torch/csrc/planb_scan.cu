// Compacted plan scan, phase B (K6): the steps after the compaction cut,
// for the walkers that survived to it, merged into phase A's outputs.
//
// Replaces the Pallas TPU kernel phfpfac_tpu/ops/pallas_plan.py::
// _make_planb_kernel together with the XLA glue and merge around it
// (_phase_b, and the scatter-adds of _plan_scan_bitmap_compact /
// _plan_scan_count_compact).  The plain torch version is
// ops/plan.py::planb_scan_plain.
//
// Phase A (plan_scan.cu, plan_scan_compact_a) leaves (pos, disp) of the
// live walkers in cap-sized buffers, 32 to an atomic from one warp tile,
// and their true number in a device counter.  Phase B walks steps
// [cut:] for the first min(count, cap) entries, reading each window at
// pairs[pos + o] with the segment room recomputed from pos, and then
//   bitmap mode: bits[pos] |= deep, cnt[pos] += popc(deep)  (a position
//     holds one walker, and deep and shallow bits are disjoint, so no
//     atomics are needed);
//   count mode: adds popc(deep) for pos >= shift to the 64-bit total.
// With count > cap the buffers hold only cap walkers: the result is
// then incomplete by design and the caller must rescan (ops/plan.py
// verify / check_overflow).
//
// What bounds it on an H100: latency, not bytes.  Per survivor it moves
// 8 B of (pos, disp), a 32 B sector of the stream for its windows and,
// where it has deep bits, a word of bits and of cnt: a few MB a launch,
// a few microseconds at the memory rate.  Survivors are a few percent
// of the positions, so what a launch costs is its fixed part and its
// longest dependent chain: the survivor count, the entry, the window,
// then one step after another, up to 31 for a real match: with one step
// after the cut a launch takes a quarter of the full walk's time, and
// neither step operands in shared memory or in lane registers nor the
// next window loaded a step early shortened a step.  The first
// port sized its grid by cap (4,096 blocks of one walker a thread on
// clamav5k, of which some 1,230 had a walker), copied the raw step rows
// into every block's shared memory behind a barrier and decoded each
// step inside the walk.  This design:
//
// * A persistent grid: the resident blocks of the card (occupancy API,
//   current device), whatever cap is.  Warp w takes the groups of 32
//   consecutive buffer entries w, w + W, ... (W warps in the grid), so
//   a group is one row that phase A wrote, neighbouring positions with
//   neighbouring windows.  The count is read on the device, and each
//   warp's first entries are loaded beside it, before it is known, so
//   the two loads overlap; with no survivors a launch reads one word a
//   thread and ends.
// * Pre-decoded steps: the descriptors of steps [cut:] (ops/plan.py::
//   step_descriptors, built once a cut and kept on PlanKernelTables)
//   travel by value as a __grid_constant__ parameter; no copy into
//   shared memory, no barrier.  The step body is K1's (plan_step.cuh).
// * A deep list per warp: a group walks kNear steps; the walkers still
//   live then (real matches) go to the warp's list in shared memory and
//   the warp takes its next group.  The list is walked a lane a walker,
//   from step kNear on, whenever it holds a row of 32, and at the end,
//   so one deep walk does not hold a warp of otherwise dead lanes for
//   every group it takes.  (A list per block of 512 threads, walked
//   after a barrier, measured slower: the barrier waits for the block's
//   slowest group.)
// * Count mode sums in registers: one block reduction and one atomic a
//   block, after its last walk.

#include <cstring>

#include "plan_step.cuh"
#include "warp_tile.cuh"

namespace {

using plan::Codes;
using plan::count_shift;
using plan::kMaxSteps;
using plan::segment_room;
using plan::Step;
using plan::Steps;

constexpr int kThreads = wt::kThreads;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kNear = 3;        // steps a group walks before it defers
constexpr int kDeepCap = 64;    // < 32 waiting + <= 32 added
constexpr int kMaxWindow = 32;  // a window's char offset: depth0 - 1 < 32

// A warp's walkers still live at step kNear: position, displacement and
// the fin bits they have so far.
struct Deep {
  int pos[kDeepCap];
  unsigned disp[kDeepCap];
  unsigned out[kDeepCap];
};

// What every walk of a launch reads.
struct Walk {
  const int* pairs;
  const int* packed;
  const int* side;
  int n_steps, seg, halo;
  unsigned dead;
};

// Walks a walker at `pos` from step `s` to `end` while it lives, windows
// from device memory, fin bits into `out`.  Every lane of the warp calls
// it; `live` is false for a lane with no walker.
template <bool kSeg>
__device__ __forceinline__ void walk_from(const Walk& w, const Steps& steps,
                                          const Codes& c, int s, int end,
                                          int pos, unsigned& disp,
                                          unsigned& out, bool& live) {
  const int room = kSeg ? segment_room(pos, w.seg, w.halo) : 0;
  const int* win = w.pairs + pos;  // pos + o < n_pos + 32: in the stream
  for (; s < end && __any_sync(0xffffffffu, live); ++s) {
    if (!live) continue;
    const Step& d = steps.s[s];
    if (kSeg && !(room > d.o)) {  // the cut: it reads no further
      live = false;
      continue;
    }
    bool hit;
    out |= plan::step_bits<kSeg>(d, static_cast<unsigned>(__ldg(win + d.o)),
                                 room, c, w.packed, w.side, disp, hit);
    live = hit && disp != w.dead;
  }
}

// A finished walker's deep bits into phase A's outputs.
template <bool kBitmap>
__device__ __forceinline__ void merge(int pos, unsigned out, int sh,
                                      int* __restrict__ cnt,
                                      int* __restrict__ bits,
                                      unsigned long long& sum) {
  if (kBitmap) {
    if (out) {
      bits[pos] |= static_cast<int>(out);
      cnt[pos] += __popc(out);
    }
  } else if (pos >= sh) {
    sum += __popc(out);
  }
}

// The first k <= 32 entries of the warp's deep list, a lane an entry,
// walked from step kNear to the end and merged.
template <bool kBitmap, bool kSeg>
__device__ __forceinline__ void walk_deep(const Walk& w, const Steps& steps,
                                          const Codes& c, const Deep& dl,
                                          int k, int lane, int sh,
                                          int* __restrict__ cnt,
                                          int* __restrict__ bits,
                                          unsigned long long& sum) {
  bool live = lane < k;
  int pos = 0;
  unsigned disp = w.dead, out = 0;
  if (live) {
    pos = dl.pos[lane];
    disp = dl.disp[lane];
    out = dl.out[lane];
  }
  walk_from<kSeg>(w, steps, c, kNear, w.n_steps, pos, disp, out, live);
  if (lane < k) merge<kBitmap>(pos, out, sh, cnt, bits, sum);
}

template <bool kBitmap, bool kSeg>
__global__ void __launch_bounds__(kThreads)
planb_scan_kernel(const Walk w, const __grid_constant__ Steps steps, int cb,
                  int cap, const int* __restrict__ surv_pos,
                  const int* __restrict__ surv_disp,
                  const int* __restrict__ surv_count, int* __restrict__ cnt,
                  int* __restrict__ bits, int shift,
                  const unsigned long long* __restrict__ prev,
                  unsigned long long* __restrict__ total) {
  __shared__ Deep deep[kWarps];
  __shared__ unsigned long long warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  Deep& dl = deep[wid];
  const Codes c(cb);
  const int near = w.n_steps < kNear ? w.n_steps : kNear;
  const int stride = gridDim.x * kWarps * 32;
  const int first = (blockIdx.x * kWarps + wid) * 32;
  // this warp's first entries, loaded beside the count (an entry at or
  // past the count is never used)
  int pos = 0;
  unsigned disp = 0;
  if (first + lane < cap) {
    pos = __ldg(surv_pos + first + lane);
    disp = static_cast<unsigned>(__ldg(surv_disp + first + lane));
  }
  const int n = min(*surv_count, cap);
  const int sh = kBitmap ? 0 : count_shift(shift, prev);
  unsigned long long sum = 0;
  int nd = 0;  // walkers in the warp's deep list
  for (int g = first; g < n; g += stride) {  // a group of 32 entries
    const int i = g + lane;
    bool live = i < n;
    if (g != first && live) {
      pos = __ldg(surv_pos + i);
      disp = static_cast<unsigned>(__ldg(surv_disp + i));
    }
    unsigned out = 0;
    walk_from<kSeg>(w, steps, c, 0, near, pos, disp, out, live);
    bool done = i < n;
    if (near < w.n_steps) {  // the walkers still live go to the list
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int j = nd + __popc(m & lt);
        dl.pos[j] = pos;
        dl.disp[j] = disp;
        dl.out[j] = out;
        done = false;
      }
      nd += __popc(m);
    }
    if (done) merge<kBitmap>(pos, out, sh, cnt, bits, sum);
    if (nd >= 32) {  // a row of deep walkers: walk it, keep the rest
      __syncwarp();
      walk_deep<kBitmap, kSeg>(w, steps, c, dl, 32, lane, sh, cnt, bits, sum);
      nd -= 32;
      __syncwarp();
      if (lane < nd) {
        dl.pos[lane] = dl.pos[32 + lane];
        dl.disp[lane] = dl.disp[32 + lane];
        dl.out[lane] = dl.out[32 + lane];
      }
      __syncwarp();
    }
  }
  if (nd) {
    __syncwarp();
    walk_deep<kBitmap, kSeg>(w, steps, c, dl, nd, lane, sh, cnt, bits, sum);
  }
  if (!kBitmap) wt::block_total(sum, warp_sums, total);
}

template <bool B, bool S>
int launch_one(const Walk& w, const Steps& steps, int cb, int cap,
               const int* surv_pos, const int* surv_disp,
               const int* surv_count, int* cnt, int* bits, int shift,
               const unsigned long long* prev, unsigned long long* total,
               cudaStream_t st) {
  static int known[wt::kMaxDevices];
  int grid = 0;
  const cudaError_t e = wt::resident_blocks(planb_scan_kernel<B, S>, 0,
                                            known, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  planb_scan_kernel<B, S><<<grid, kThreads, 0, st>>>(
      w, steps, cb, cap, surv_pos, surv_disp, surv_count, cnt, bits, shift,
      prev, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `desc`: host memory, n_steps rows of the 17 words of ops/plan.py
// step_descriptors for the steps after the cut.  Bitmap mode updates
// cnt/bits in place; count mode adds to *total (which already holds
// phase A's sum).  `pairs` holds kMaxWindow readable words past the
// last position.
extern "C" int planb_scan(const int* pairs, const int* packed,
                          const int* side, const unsigned* desc, int n_steps,
                          int cb, int p0_miss, int seg, int halo, int cap,
                          const int* surv_pos, const int* surv_disp,
                          const int* surv_count, int emit_bitmap, int* cnt,
                          int* bits, int shift, const long long* prev,
                          long long* total, void* stream) {
  if (n_steps > kMaxSteps || cap <= 0 || !surv_pos || !surv_disp ||
      !surv_count || (emit_bitmap ? !cnt || !bits : !total))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_steps <= 0) return 0;
  Steps steps;
  std::memset(&steps, 0, sizeof(steps));
  std::memcpy(steps.s, desc, sizeof(Step) * n_steps);
  for (int i = 0; i < n_steps; ++i)
    if (steps.s[i].o < 0 || steps.s[i].o >= kMaxWindow)
      return static_cast<int>(cudaErrorInvalidValue);
  const Walk w{pairs, packed, side, n_steps, seg, halo,
               static_cast<unsigned>(p0_miss)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* up = reinterpret_cast<const unsigned long long*>(prev);
  auto* ut = reinterpret_cast<unsigned long long*>(total);
#define PLANB_LAUNCH(B, S)                                              \
  return launch_one<B, S>(w, steps, cb, cap, surv_pos, surv_disp,       \
                          surv_count, cnt, bits, shift, up, ut, st)
  if (emit_bitmap) {
    if (seg > 0) PLANB_LAUNCH(true, true);
    PLANB_LAUNCH(true, false);
  }
  if (seg > 0) PLANB_LAUNCH(false, true);
  PLANB_LAUNCH(false, false);
#undef PLANB_LAUNCH
}
