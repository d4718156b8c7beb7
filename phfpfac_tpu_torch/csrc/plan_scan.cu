// Plan scan (K1): the hybrid-stride PFAC walk over compile.plan's tables.
//
// Replaces the Pallas TPU kernel phfpfac_tpu/ops/pallas_plan.py::
// _make_plan_kernel (step body _run_steps), reached there through
// _plan_scan_bitmap, _plan_scan_count and _plan_scan_count_chain.  The
// plain torch version of the same walk is ops/plan.py::plan_scan_plain.
//
// One thread per byte offset (the reference CUDA kernel's mapping,
// master_kernel.cu:37-74).  A thread reads the staged pair symbol at
// pos, probes the prologue table p0, then walks the plan's static step
// chain: a "mono" step probes one byte, a "pair" step two bytes plus a
// side-table word for the odd depth.  Every probe is ONE indexed load:
//     banks[(off + (idx >> 7) - k0) * 128 + (idx & 127)]
// when k0 <= idx >> 7 < k0 + nb, else the -1 miss.  A walker whose
// displacement falls to the dead sentinel stops (the dead-zone scheme
// of compile/plan.py makes death absorbing, so the remaining steps
// could only reproduce a miss).
//
// What bounds it on an H100: the dependent table gathers.  Each step's
// probe address depends on the previous probe's value, so a walker is
// a chain of L2/device-memory latencies; the tables (a few MB) stay in
// the 50 MB L2.  The compulsory traffic is 4 B read per position (the
// staged stream) plus 8 B written per position in bitmap mode (cnt and
// bits), or nothing per position in count mode.  This simple design
// relies on many resident warps (256-thread blocks, one walker per
// thread, few registers) to hide the gather latency, and on the early
// exit: most walkers die within a few steps, so most threads issue
// only the prologue and one or two probes.  The step specs sit in
// shared memory; neighbouring threads read neighbouring stream words,
// so the window loads coalesce.
//
// K1' (plan_scan_compact_a): the same kernel over the steps before a
// compaction cut, which also hands on every walker that is still live
// at the cut.  Replaces _make_plan_kernel with emit_surv, reached
// through _plan_scan_bitmap_compact and _plan_scan_count_compact.  The
// TPU kernel writes a displacement per position and leaves the
// compaction to a nonzero + gather between the kernels; here a block
// counts its live walkers (ballot per warp, prefix over the warps),
// takes its slots with ONE atomicAdd on a device counter and writes
// (pos, disp) into cap-sized buffers.  The counter keeps counting past
// cap, so it is the true survivor total; entries past cap are dropped
// and the caller rescans on count > cap.  Slots are ascending inside a
// block and unordered across blocks; no output depends on the order.
// Extra traffic: 8 B written per survivor instead of 4 B per position.

#include "plan_step.cuh"

namespace {

using namespace plan;

template <bool kBitmap, bool kSeg, bool kSurv>
__global__ void __launch_bounds__(kThreads)
plan_scan_kernel(const int* __restrict__ pairs, int n_pos,
                 const int* __restrict__ p0, int nb_p0,
                 const int* __restrict__ packed,
                 const int* __restrict__ side,
                 const int* __restrict__ steps_g, int n_steps, int cb,
                 int p0_mode, int p0_miss, int seg, int halo,
                 int* __restrict__ cnt, int* __restrict__ bits, int shift,
                 const unsigned long long* __restrict__ prev,
                 unsigned long long* __restrict__ total, int cap,
                 int* __restrict__ surv_pos, int* __restrict__ surv_disp,
                 int* __restrict__ surv_count) {
  __shared__ int steps[kMaxSteps * kFields];
  __shared__ unsigned int warp_sums[kThreads / 32];
  for (int i = threadIdx.x; i < n_steps * kFields; i += blockDim.x)
    steps[i] = steps_g[i];
  __syncthreads();

  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t dead = static_cast<uint32_t>(p0_miss);
  uint32_t out = 0;
  uint32_t disp = dead;
  if (pos < n_pos) {
    const uint32_t cbm = (1u << cb) - 1u;
    const int room = kSeg ? segment_room(pos, seg, halo) : 0;

    // ---- prologue at offset 0 ----
    const uint32_t c0 = static_cast<uint32_t>(pairs[pos]);
    int idx;
    if (p0_mode == 0) {  // dense depths-1+2 table, indexed by the pair
      idx = static_cast<int>(c0);
    } else if (p0_mode == 2) {  // s0x: (code1, high bits of code2)
      const int sb = cb - 6;
      idx = static_cast<int>(((c0 & cbm) << sb) |
                             ((c0 >> (cb + 6)) & ((1u << sb) - 1u)));
    } else {  // s0: depth-1 code
      idx = static_cast<int>(c0 & cbm);
    }
    const int v = probe(p0, 0, nb_p0, 0, idx);
    if (v >= 0) {
      const uint32_t uv = static_cast<uint32_t>(v);
      out = uv & 1u;
      if (p0_mode == 0) {
        if ((uv & 2u) && (!kSeg || room > 1)) out |= 2u;
        disp = uv >> 2;
      } else {
        disp = uv >> 1;
      }
    }

    walk_steps<kSeg>(steps, n_steps, pairs, pos, room, cb, dead, packed,
                     side, disp, out);
    if (kBitmap) {
      cnt[pos] = __popc(out);
      bits[pos] = static_cast<int>(out);
    }
  }

  if (!kBitmap) {
    const int sh = count_shift(shift, prev);
    block_add((pos < n_pos && pos >= sh) ? __popc(out) : 0u, warp_sums,
              total);
  }

  if (kSurv) {
    // append the walkers still live at the cut; one atomic per block
    __shared__ int warp_base[kThreads / 32];
    __shared__ int block_base;
    const bool live = disp != dead;  // pos >= n_pos stays dead
    const unsigned int m = __ballot_sync(0xffffffffu, live);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) warp_base[wid] = __popc(m);
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        const int c = warp_base[w];
        warp_base[w] = n;
        n += c;
      }
      block_base = n ? atomicAdd(surv_count, n) : 0;
    }
    __syncthreads();
    if (live) {
      const int slot =
          block_base + warp_base[wid] + __popc(m & ((1u << lane) - 1u));
      if (slot < cap) {
        surv_pos[slot] = pos;
        surv_disp[slot] = static_cast<int>(disp);
      }
    }
  }
}

int launch(const int* pairs, int n_pos, const int* p0, int nb_p0,
           const int* packed, const int* side, const int* steps,
           int n_steps, int cb, int p0_mode, int p0_miss, int seg, int halo,
           int emit_bitmap, int* cnt, int* bits, int shift,
           const long long* prev, long long* total, int cap, int* surv_pos,
           int* surv_disp, int* surv_count, void* stream) {
  if (n_steps > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos <= 0) return 0;
  const dim3 grid((n_pos + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* up = reinterpret_cast<const unsigned long long*>(prev);
  auto* ut = reinterpret_cast<unsigned long long*>(total);
#define PLAN_LAUNCH(B, S, V)                                                \
  plan_scan_kernel<B, S, V><<<grid, kThreads, 0, st>>>(                     \
      pairs, n_pos, p0, nb_p0, packed, side, steps, n_steps, cb, p0_mode,   \
      p0_miss, seg, halo, cnt, bits, shift, up, ut, cap, surv_pos,          \
      surv_disp, surv_count)
#define PLAN_LAUNCH_V(B, S)                                                 \
  if (surv_count) PLAN_LAUNCH(B, S, true); else PLAN_LAUNCH(B, S, false)
  const bool s = seg > 0;
  if (emit_bitmap) {
    if (s) { PLAN_LAUNCH_V(true, true); } else { PLAN_LAUNCH_V(true, false); }
  } else {
    if (s) { PLAN_LAUNCH_V(false, true); } else { PLAN_LAUNCH_V(false, false); }
  }
#undef PLAN_LAUNCH_V
#undef PLAN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int plan_scan(const int* pairs, int n_pos, const int* p0,
                         int nb_p0, const int* packed, const int* side,
                         const int* steps, int n_steps, int cb, int p0_mode,
                         int p0_miss, int seg, int halo, int emit_bitmap,
                         int* cnt, int* bits, int shift,
                         const long long* prev, long long* total,
                         void* stream) {
  return launch(pairs, n_pos, p0, nb_p0, packed, side, steps, n_steps, cb,
                p0_mode, p0_miss, seg, halo, emit_bitmap, cnt, bits, shift,
                prev, total, 0, nullptr, nullptr, nullptr, stream);
}

// K1': the first `n_steps` steps only; appends (pos, disp) of every
// walker live after them to surv_pos/surv_disp[cap] and adds their
// number to *surv_count (zeroed by the caller).
extern "C" int plan_scan_compact_a(
    const int* pairs, int n_pos, const int* p0, int nb_p0, const int* packed,
    const int* side, const int* steps, int n_steps, int cb, int p0_mode,
    int p0_miss, int seg, int halo, int emit_bitmap, int* cnt, int* bits,
    int shift, const long long* prev, long long* total, int cap,
    int* surv_pos, int* surv_disp, int* surv_count, void* stream) {
  if (!surv_pos || !surv_disp || !surv_count || cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(pairs, n_pos, p0, nb_p0, packed, side, steps, n_steps, cb,
                p0_mode, p0_miss, seg, halo, emit_bitmap, cnt, bits, shift,
                prev, total, cap, surv_pos, surv_disp, surv_count, stream);
}
