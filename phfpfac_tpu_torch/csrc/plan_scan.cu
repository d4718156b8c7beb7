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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

template <bool kBitmap, bool kSeg>
__global__ void __launch_bounds__(kThreads)
plan_scan_kernel(const int* __restrict__ pairs, int n_pos,
                 const int* __restrict__ p0, int nb_p0,
                 const int* __restrict__ packed,
                 const int* __restrict__ side,
                 const int* __restrict__ steps_g, int n_steps, int cb,
                 int p0_mode, int p0_miss, int seg, int halo,
                 int* __restrict__ cnt, int* __restrict__ bits, int shift,
                 const unsigned long long* __restrict__ prev,
                 unsigned long long* __restrict__ total) {
  __shared__ int steps[kMaxSteps * kFields];
  __shared__ unsigned int warp_sums[kThreads / 32];
  for (int i = threadIdx.x; i < n_steps * kFields; i += blockDim.x)
    steps[i] = steps_g[i];
  __syncthreads();

  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t out = 0;
  if (pos < n_pos) {
    const uint32_t cbm = (1u << cb) - 1u;
    // chars a walker may read before the segment cut
    const int room = kSeg ? (pos & ~(seg - 1)) + seg + halo - pos : 0;

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
    uint32_t disp = static_cast<uint32_t>(p0_miss);
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

    // ---- the step chain ----
    const uint32_t dead = static_cast<uint32_t>(p0_miss);
    const uint32_t pair_mask = (1u << (2 * cb)) - 1u;
    const uint32_t pair_fin = 1u << (2 * cb);
    for (int s = 0; s < n_steps && disp != dead; ++s) {
      const int* sp = steps + s * kFields;
      const int o = sp[DEPTH0] - 1;  // char offset of the step's window
      if (kSeg && !(room > o)) break;  // cut: the walk reads no further
      const uint32_t cur = static_cast<uint32_t>(pairs[pos + o]);
      const uint32_t miss = static_cast<uint32_t>(sp[MISS]);
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
    if (kBitmap) {
      cnt[pos] = __popc(out);
      bits[pos] = static_cast<int>(out);
    }
  }

  if (!kBitmap) {
    int sh = shift;
    if (prev) sh = static_cast<int>((*prev + static_cast<unsigned>(shift)) & 1ull);
    unsigned int c = (pos < n_pos && pos >= sh) ? __popc(out) : 0u;
    for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xffffffffu, c, d);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long s = 0;
      for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
      if (s) atomicAdd(total, s);
    }
  }
}

}  // namespace

extern "C" int plan_scan(const int* pairs, int n_pos, const int* p0,
                         int nb_p0, const int* packed, const int* side,
                         const int* steps, int n_steps, int cb, int p0_mode,
                         int p0_miss, int seg, int halo, int emit_bitmap,
                         int* cnt, int* bits, int shift,
                         const long long* prev, long long* total,
                         void* stream) {
  if (n_steps > kMaxSteps) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos <= 0) return 0;
  const dim3 grid((n_pos + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* up = reinterpret_cast<const unsigned long long*>(prev);
  auto* ut = reinterpret_cast<unsigned long long*>(total);
#define PLAN_LAUNCH(B, S)                                                   \
  plan_scan_kernel<B, S><<<grid, kThreads, 0, st>>>(                        \
      pairs, n_pos, p0, nb_p0, packed, side, steps, n_steps, cb, p0_mode,   \
      p0_miss, seg, halo, cnt, bits, shift, up, ut)
  const bool s = seg > 0;
  if (emit_bitmap) {
    if (s) PLAN_LAUNCH(true, true); else PLAN_LAUNCH(true, false);
  } else {
    if (s) PLAN_LAUNCH(false, true); else PLAN_LAUNCH(false, false);
  }
#undef PLAN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
