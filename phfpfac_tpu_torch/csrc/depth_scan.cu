// Depth scan (K2): the stride-1 PFAC walk over compile.depth's tables.
//
// Replaces the Pallas TPU kernel phfpfac_tpu/ops/pallas_depth.py::
// _make_depth_kernel, reached there through _depth_scan_bitmap and
// _depth_scan_count.  The plain torch version of the same walk is
// ops/depth.py::depth_scan_plain.
//
// One thread per byte offset.  Step 0 probes the s0 table with the
// byte at pos (PAD_CHAR 256 lies past its 2 banks and misses); step t
// probes only the depth-t table T_t at disp + byte[pos + t], verifies
// (g & 255) == c, takes the fin bit 8 and chains disp = g >> 9.  A miss
// carries DISP_MISS; when the host has checked that DISP_MISS + c lies
// past every table (dead_exit), such a walker stops.  Segment mode
// lets step t read only while pos + t < min(input_size, seg_end + halo)
// for any positive segment size.
//
// What bounds it on an H100: the dependent table gathers, one per step,
// each addressed by the previous one's value; the tables stay in the
// 50 MB L2.  Compulsory traffic is 4 B read per position (the staged
// stream) plus 8 B written per position in bitmap mode (cnt and bits).
// The simple design hides gather latency with many resident warps (one
// walker per thread, 256-thread blocks) and lets dead walkers exit
// early, so most threads issue one or two probes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSteps = 32;
constexpr int kThreads = 256;
constexpr uint32_t kDispMiss = (1u << 22) - 1u;  // compile/depth.py DISP_MISS

__device__ __forceinline__ int probe(const int* __restrict__ banks, int off,
                                     int nb, int k0, int idx) {
  const int b = idx >> 7;
  if (b < k0 || b >= k0 + nb) return -1;
  return __ldg(banks + (off + b - k0) * 128 + (idx & 127));
}

template <bool kBitmap, bool kSeg>
__global__ void __launch_bounds__(kThreads)
depth_scan_kernel(const int* __restrict__ data, int n_pos, int input_size,
                  const int* __restrict__ s0, int nb_s0,
                  const int* __restrict__ packed,
                  const int* __restrict__ steps_g, int n_steps,
                  int dead_exit, int seg, int halo, int* __restrict__ cnt,
                  int* __restrict__ bits, int shift,
                  const unsigned long long* __restrict__ prev,
                  unsigned long long* __restrict__ total) {
  __shared__ int steps[kMaxSteps * 3];
  __shared__ unsigned int warp_sums[kThreads / 32];
  for (int i = threadIdx.x; i < (n_steps - 1) * 3; i += blockDim.x)
    steps[i] = steps_g[i];
  __syncthreads();

  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t out = 0;
  if (pos < n_pos) {
    int lim = 0;  // step t reads only while t < lim
    if (kSeg) {
      const long long end =
          (static_cast<long long>(pos) / seg + 1) * seg + halo;
      lim = static_cast<int>(
          (end < input_size ? end : static_cast<long long>(input_size)) -
          pos);
    }
    const int v = probe(s0, 0, nb_s0, 0, data[pos]);
    uint32_t disp = kDispMiss;
    if (v >= 0) {
      out = static_cast<uint32_t>(v) & 1u;
      disp = static_cast<uint32_t>(v) >> 1;
    }
    for (int t = 1; t < n_steps; ++t) {
      if (dead_exit && disp == kDispMiss) break;
      if (kSeg && !(t < lim)) {
        if (dead_exit) break;
        disp = kDispMiss;
      }
      const int* sp = steps + (t - 1) * 3;
      const int c = data[pos + t];
      const int g = probe(packed, sp[0], sp[1], sp[2],
                          static_cast<int>(disp) + c);
      const bool hit = g >= 0 && (g & 255) == c;
      if (hit && (g & 256)) out |= 1u << t;
      disp = hit ? (static_cast<uint32_t>(g) >> 9) : kDispMiss;
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

extern "C" int depth_scan(const int* data, int n_pos, int input_size,
                          const int* s0, int nb_s0, const int* packed,
                          const int* steps, int n_steps, int dead_exit,
                          int seg, int halo, int emit_bitmap, int* cnt,
                          int* bits, int shift, const long long* prev,
                          long long* total, void* stream) {
  if (n_steps > kMaxSteps + 1 || n_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos <= 0) return 0;
  const dim3 grid((n_pos + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* up = reinterpret_cast<const unsigned long long*>(prev);
  auto* ut = reinterpret_cast<unsigned long long*>(total);
#define DEPTH_LAUNCH(B, S)                                                  \
  depth_scan_kernel<B, S><<<grid, kThreads, 0, st>>>(                       \
      data, n_pos, input_size, s0, nb_s0, packed, steps, n_steps,           \
      dead_exit, seg, halo, cnt, bits, shift, up, ut)
  const bool s = seg > 0;
  if (emit_bitmap) {
    if (s) DEPTH_LAUNCH(true, true); else DEPTH_LAUNCH(true, false);
  } else {
    if (s) DEPTH_LAUNCH(false, true); else DEPTH_LAUNCH(false, false);
  }
#undef DEPTH_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
