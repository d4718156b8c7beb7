// Pair scan (K3): the stride-2 PFAC walk over compile.pair's tables.
//
// Replaces the Pallas TPU kernel phfpfac_tpu/ops/pallas_pair.py::
// _make_pair_kernel, reached there through _pair_scan_bitmap and
// _pair_scan_count.  The plain torch version of the same walk is
// ops/pair.py::pair_scan_plain.
//
// One thread per byte offset over the staged pair-symbol stream
// (ops.staging.stage_pairs: (code[i+1] << cb) | code[i], the miss code
// past input_size).  Pair step 0 probes the dense depths-1+2 table p0
// with the symbol at pos: v >= 0 is alive, bit 0 of v is the depth-1
// match, bit 1 the depth-2 match, v >> 2 the next displacement.  Pair
// step k >= 1 reads the symbol at pos + 2k and makes two probes from the
// same displacement:
//   side:  sidx = disp + first code; one byte (or nibble) of the side
//          word holds first code + 1 (or its low 3 bits + 1) iff a
//          pattern of length 2k+1 ends here             -> bit 2k
//   pair:  g = P_k[disp + symbol]; a hit verifies the stored symbol,
//          its fin bit is the match of length 2k+2       -> bit 2k+1
//          and g >> (2cb+1) is the next displacement.
// A miss carries disp_miss.  When the host has checked that disp_miss
// plus any symbol lies past every later pair and side table (dead_exit),
// such a walker stops; else every step runs.  There is no segment cut:
// a stride-2 walk cannot reproduce a cut between a pair's two chars.
//
// What bounds it on an H100: the dependent table gathers, two per pair
// step, the pair probe addressed by the previous one's value; the tables
// stay in the 50 MB L2.  Compulsory traffic is 4 B read per position
// (the staged stream) plus 8 B written per position in bitmap mode.
// Half the steps of a stride-1 walk, many resident warps (one walker per
// thread, 256-thread blocks) and the early exit hide the gather latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFields = 7;  // ops/pair.py STEP_FIELDS
constexpr int kMaxSteps = 16;  // pair steps of a 32-deep bitmap
constexpr int kThreads = 256;

enum Field { P_OFF, P_NB, P_K0, S_OFF, S_NB, S_K0, S_NIBBLE };

__device__ __forceinline__ int probe(const int* __restrict__ banks, int off,
                                     int nb, int k0, int idx) {
  const int b = idx >> 7;  // arithmetic: a negative idx misses
  if (b < k0 || b >= k0 + nb) return -1;
  return __ldg(banks + (off + b - k0) * 128 + (idx & 127));
}

template <bool kBitmap>
__global__ void __launch_bounds__(kThreads)
pair_scan_kernel(const int* __restrict__ pairs, int n_pos,
                 const int* __restrict__ p0, int nb_p0,
                 const int* __restrict__ packed,
                 const int* __restrict__ side,
                 const int* __restrict__ steps_g, int n_pair_steps, int cb,
                 int disp_miss, int dead_exit, int* __restrict__ cnt,
                 int* __restrict__ bits, int shift,
                 unsigned long long* __restrict__ total) {
  __shared__ int steps[kMaxSteps * kFields];
  __shared__ unsigned int warp_sums[kThreads / 32];
  for (int i = threadIdx.x; i < (n_pair_steps - 1) * kFields;
       i += blockDim.x)
    steps[i] = steps_g[i];
  __syncthreads();

  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t out = 0;
  if (pos < n_pos) {
    const uint32_t cbm = (1u << cb) - 1u;
    const uint32_t pair_mask = (1u << (2 * cb)) - 1u;
    const uint32_t fin_bit = 1u << (2 * cb);
    const uint32_t miss = static_cast<uint32_t>(disp_miss);

    // pair step 0: dense depths-1+2 probe
    const int v = probe(p0, 0, nb_p0, 0, pairs[pos]);
    uint32_t disp = miss;
    if (v >= 0) {
      out = static_cast<uint32_t>(v) & 3u;
      disp = static_cast<uint32_t>(v) >> 2;
    }

    for (int k = 1; k < n_pair_steps; ++k) {
      if (dead_exit && disp == miss) break;
      const int* sp = steps + (k - 1) * kFields;
      const uint32_t cur = static_cast<uint32_t>(pairs[pos + 2 * k]);
      // side probe: the match at depth 2k+1
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
      // pair probe: the match at depth 2k+2 and the next displacement
      const int g = probe(packed, sp[P_OFF], sp[P_NB], sp[P_K0],
                          static_cast<int>(disp + cur));
      const uint32_t ug = static_cast<uint32_t>(g);
      const bool hit = g >= 0 && (ug & pair_mask) == cur;
      if (fin_mid) out |= 1u << (2 * k);
      if (hit && (ug & fin_bit)) out |= 1u << (2 * k + 1);
      disp = hit ? (ug >> (2 * cb + 1)) : miss;
    }
    if (kBitmap) {
      cnt[pos] = __popc(out);
      bits[pos] = static_cast<int>(out);
    }
  }

  if (!kBitmap) {
    unsigned int c = (pos < n_pos && pos >= shift) ? __popc(out) : 0u;
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

extern "C" int pair_scan(const int* pairs, int n_pos, const int* p0,
                         int nb_p0, const int* packed, const int* side,
                         const int* steps, int n_pair_steps, int cb,
                         int disp_miss, int dead_exit, int emit_bitmap,
                         int* cnt, int* bits, int shift, long long* total,
                         void* stream) {
  if (n_pair_steps < 1 || n_pair_steps > kMaxSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos <= 0) return 0;
  const dim3 grid((n_pos + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ut = reinterpret_cast<unsigned long long*>(total);
  if (emit_bitmap)
    pair_scan_kernel<true><<<grid, kThreads, 0, st>>>(
        pairs, n_pos, p0, nb_p0, packed, side, steps, n_pair_steps, cb,
        disp_miss, dead_exit, cnt, bits, shift, ut);
  else
    pair_scan_kernel<false><<<grid, kThreads, 0, st>>>(
        pairs, n_pos, p0, nb_p0, packed, side, steps, n_pair_steps, cb,
        disp_miss, dead_exit, cnt, bits, shift, ut);
  return static_cast<int>(cudaGetLastError());
}
