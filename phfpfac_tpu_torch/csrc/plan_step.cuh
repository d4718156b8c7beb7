// The plan walk's step, shared by the plan kernel (plan_scan.cu, K1 and
// K1', which reads a step's window from its tile's staged words in
// shared memory) and the compacted phase-B kernel (planb_scan.cu, K6,
// which reads it from device memory at the survivor's position): the
// pre-decoded step (ops/plan.py::step_descriptors), its probe and its
// body, and the helpers both kernels take.  Replaces phfpfac_tpu/ops/
// pallas_plan.py::_run_steps; the plain torch version is ops/plan.py::
// plan_steps_plain.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace plan {

constexpr int kMaxSteps = 32;

// One step's ready operands (ops/plan.py STEP_DESC_FIELDS, in order).
struct Step {
  int o;     // char offset of the step's window (depth0 - 1)
  int pair;  // 0: mono, 1: pair + side table
  unsigned base, lo, span;  // main table: off * 128, k0 * 128, nb * 128
  unsigned cmask, finm, vmask, vsh;  // mono: symbol, fin flag, kept bits
  unsigned s_base, s_lo, s_span;     // side table, as the main one
  // side word of sidx: banks[sidx >> wsh], field
  // (w >> ((sidx & smask) << fsh)) & fmask against (a1 & amask) + 1
  unsigned wsh, smask, fsh, fmask, amask;
};
constexpr int kStepWords = 17;
static_assert(sizeof(Step) == kStepWords * 4, "Step is 17 packed words");

// A launch's steps, by value: a __grid_constant__ kernel parameter,
// read through the constant cache.
struct Steps {
  Step s[kMaxSteps];
};

// The code width's masks, the same for every step of a walk.
struct Codes {
  unsigned cbm, pair_fin, pair_keep;
  int pair_vsh;
  __device__ explicit Codes(int cb)
      : cbm((1u << cb) - 1u),
        pair_fin(1u << (2 * cb)),
        pair_keep(((1u << (2 * cb)) - 1u) | (1u << (2 * cb))),
        pair_vsh(2 * cb + 1) {}
};

// banks[(off + (idx >> 7) - k0) * 128 + (idx & 127)] inside k0 <= idx >> 7
// < k0 + nb, else ~0u (-1): one subtract, one unsigned compare, one load.
__device__ __forceinline__ unsigned probe(const int* __restrict__ banks,
                                          unsigned base, unsigned lo,
                                          unsigned span, unsigned idx) {
  const unsigned u = idx - lo;
  return u < span ? static_cast<unsigned>(__ldg(banks + base + u)) : ~0u;
}

// Chars a walker at pos may read before the segment cut.
__device__ __forceinline__ int segment_room(int pos, int seg, int halo) {
  return (pos & ~(seg - 1)) + seg + halo - pos;
}

// The body of step `d` for a walker whose window word at the step's
// offset is `cur` (the caller has checked the segment cut before the
// window): -> the step's fin bits; `disp` becomes the probe's next
// displacement and `hit` says whether the walk chains on.
template <bool kSeg>
__device__ __forceinline__ unsigned step_bits(const Step& d, unsigned cur,
                                              int room, const Codes& c,
                                              const int* __restrict__ packed,
                                              const int* __restrict__ side,
                                              unsigned& disp, bool& hit) {
  if (!d.pair) {
    const unsigned sym = cur & d.cmask;
    const unsigned g = probe(packed, d.base, d.lo, d.span, disp + sym);
    const unsigned gs = g & d.vmask;
    const bool fin = gs == (sym | d.finm);
    hit = fin || gs == sym;
    disp = g >> d.vsh;
    return fin ? 1u << d.o : 0u;
  }
  const unsigned g = probe(packed, d.base, d.lo, d.span, disp + cur);
  const unsigned a1 = cur & c.cbm;
  const unsigned sidx = disp + a1;
  const unsigned w = probe(side, d.s_base, d.s_lo, d.s_span, sidx >> d.wsh);
  const bool fin_mid = ((w >> ((sidx & d.smask) << d.fsh)) & d.fmask) ==
                       (a1 & d.amask) + 1u;
  const unsigned gs = g & c.pair_keep;
  bool fin_end = gs == (cur | c.pair_fin);
  hit = fin_end || gs == cur;
  if (kSeg && !(room > d.o + 1)) {
    // cut between the pair's two chars: the mid completion stands, the
    // end match and the chain do not
    fin_end = false;
    hit = false;
  }
  disp = g >> c.pair_vsh;
  return (fin_mid ? 1u << d.o : 0u) | (fin_end ? 2u << d.o : 0u);
}

// The shift of a count-mode scan: positions below it do not count.  A
// chained scan reads the previous scan's total on the device.
__device__ __forceinline__ int count_shift(
    int shift, const unsigned long long* __restrict__ prev) {
  if (!prev) return shift;
  return static_cast<int>((*prev + static_cast<unsigned>(shift)) & 1ull);
}

}  // namespace plan
