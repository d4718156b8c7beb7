// Banked-PHF scan (K4 one shard, K5 every shard in one launch): the PFAC
// walk over the FFDM perfect-hash tables, the counterpart of the
// reference's TraceTable_kernel (master_kernel.cu:92-180).
//
// Replaces the Pallas TPU kernels phfpfac_tpu/ops/pallas_scan.py::
// _make_kernel (reached through _pallas_scan) and ::_make_multi_kernel
// (through _pallas_scan_multi).  The plain torch versions of the same
// walks are ops/scan.py::phf_scan_plain and ::phf_scan_multi_plain.
//
// One thread per byte offset, reading the raw uint8 corpus.  Step 0 is
// state = s0[byte] (DEAD at or past input_size); step t first kills the
// walker unless pos + t < lim, then probes
//     key = (state << 8) + byte[pos + t];  row = key >> width_bit;
//     idx = r[row] + (key & (width - 1));  g = packed[idx];
// hits iff (g & row_mask) == row and chains state = g >> row_bits, else
// DEAD.  A state below num_final sets bit t.  Tables are [nb, 128] banks
// read flat; an index outside a table yields -1, which is how the DEAD
// state's sentinel rows of r (-2^30) and empty rows miss.  When the host
// has checked that every key of DEAD reads a sentinel row (dead_exit), a
// dead walker stops.  The multi kernel runs the same walk once per shard
// over concatenated tables, with the shard specs in shared memory; cnt is
// summed over shards and each shard writes its own bitmap row.
//
// What bounds it on an H100: two dependent gathers per step (r, then
// packed), each addressed by the previous step's value; the tables stay
// in the 50 MB L2.  Compulsory traffic is 1 B read per position plus
// 4 B of counts and 4 B of bitmap per shard written per position.  The
// simple design hides the gather latency with many resident warps (one
// walker per thread, 256-thread blocks) and the early exit: most walkers
// die within a step or two.  Neighbouring threads read neighbouring
// bytes, so the corpus loads coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 10;  // ops/scan.py SPEC_FIELDS
constexpr int kMaxShards = 64;
constexpr int kMaxSteps = 128;

enum Field { S0_OFF, NB_S0, R_OFF, NB_R, P_OFF, NB_P, WIDTH_BIT, ROW_BITS,
             DEAD, NUM_FINAL };

// banks[off:off+nb] read flat at idx; -1 outside [0, nb * 128)
__device__ __forceinline__ int lut(const int* __restrict__ banks, int off,
                                   int nb, int idx) {
  const int b = idx >> 7;  // arithmetic: a negative idx misses
  if (b < 0 || b >= nb) return -1;
  return __ldg(banks + off * 128 + idx);
}

// One shard's walk from pos; returns the bitmap, adds matches to cnt.
template <bool kBitmap>
__device__ __forceinline__ uint32_t walk(
    const uint8_t* __restrict__ data, int pos, int input_size, int lim,
    int max_steps, const int* __restrict__ s0, const int* __restrict__ r,
    const int* __restrict__ packed, const int* __restrict__ sp,
    bool dead_exit, int& cnt) {
  const int wb = sp[WIDTH_BIT], rb = sp[ROW_BITS];
  const int dead = sp[DEAD], nf = sp[NUM_FINAL];
  const uint32_t wm1 = (1u << wb) - 1u, row_mask = (1u << rb) - 1u;
  int state = pos < input_size
                  ? lut(s0, sp[S0_OFF], sp[NB_S0], data[pos]) : dead;
  uint32_t bits = 0;
  if (state < nf) {
    ++cnt;
    bits = 1u;
  }
  for (int t = 1; t < max_steps; ++t) {
    if (!(pos + t < lim)) state = dead;
    if (dead_exit && state == dead) break;
    const uint32_t key = (static_cast<uint32_t>(state) << 8) + data[pos + t];
    const uint32_t row = key >> wb;
    const int idx = lut(r, sp[R_OFF], sp[NB_R], static_cast<int>(row)) +
                    static_cast<int>(key & wm1);
    const uint32_t g =
        static_cast<uint32_t>(lut(packed, sp[P_OFF], sp[NB_P], idx));
    state = (g & row_mask) == row ? static_cast<int>(g >> rb) : dead;
    if (state < nf) {
      ++cnt;
      if (kBitmap) bits |= 1u << (t < 31 ? t : 31);
    }
  }
  return bits;
}

__device__ __forceinline__ int walk_limit(int pos, int input_size,
                                          int max_steps, int seg, int halo) {
  long long end = seg > 0
      ? (static_cast<long long>(pos) / seg + 1) * seg + halo
      : static_cast<long long>(pos) + max_steps;
  return static_cast<int>(end < input_size ? end : input_size);
}

// Sum c over the block's threads into *total: warp shuffles, then one
// 64-bit atomic per block.
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

template <bool kBitmap>
__global__ void __launch_bounds__(kThreads)
phf_scan_kernel(const uint8_t* __restrict__ data, int n_pos, int input_size,
                int max_steps, const int* __restrict__ s0,
                const int* __restrict__ r, const int* __restrict__ packed,
                const int* __restrict__ specs_g, int dead_exit, int seg,
                int halo, int* __restrict__ cnt, int* __restrict__ bits,
                int shift, unsigned long long* __restrict__ total) {
  __shared__ int spec[kFields];
  __shared__ unsigned int warp_sums[kThreads / 32];
  if (threadIdx.x < kFields) spec[threadIdx.x] = specs_g[threadIdx.x];
  __syncthreads();

  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  int c = 0;
  if (pos < n_pos) {
    const int lim = walk_limit(pos, input_size, max_steps, seg, halo);
    const uint32_t b = walk<kBitmap>(data, pos, input_size, lim, max_steps,
                                     s0, r, packed, spec, dead_exit != 0, c);
    if (kBitmap) {
      cnt[pos] = c;
      bits[pos] = static_cast<int>(b);
    }
  }
  if (!kBitmap)
    block_add(pos < n_pos && pos >= shift ? c : 0, warp_sums, total);
}

template <bool kBitmap>
__global__ void __launch_bounds__(kThreads)
phf_scan_multi_kernel(const uint8_t* __restrict__ data, int n_pos,
                      int input_size, int max_steps,
                      const int* __restrict__ s0, const int* __restrict__ r,
                      const int* __restrict__ packed,
                      const int* __restrict__ specs_g, int n_shards,
                      int dead_exit, int seg, int halo,
                      int* __restrict__ cnt, int* __restrict__ bits,
                      int shift, unsigned long long* __restrict__ total) {
  __shared__ int specs[kMaxShards * kFields];
  __shared__ unsigned int warp_sums[kThreads / 32];
  for (int i = threadIdx.x; i < n_shards * kFields; i += blockDim.x)
    specs[i] = specs_g[i];
  __syncthreads();

  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  int c = 0;
  if (pos < n_pos) {
    const int lim = walk_limit(pos, input_size, max_steps, seg, halo);
    for (int s = 0; s < n_shards; ++s) {
      const uint32_t b =
          walk<kBitmap>(data, pos, input_size, lim, max_steps, s0, r, packed,
                        specs + s * kFields, dead_exit != 0, c);
      if (kBitmap)
        bits[static_cast<size_t>(s) * n_pos + pos] = static_cast<int>(b);
    }
    if (kBitmap) cnt[pos] = c;
  }
  if (!kBitmap)
    block_add(pos < n_pos && pos >= shift ? c : 0, warp_sums, total);
}

}  // namespace

extern "C" int phf_scan(const uint8_t* data, int n_pos, int input_size,
                        int max_steps, const int* s0, const int* r,
                        const int* packed, const int* specs, int dead_exit,
                        int seg, int halo, int emit_bitmap, int* cnt,
                        int* bits, int shift, long long* total,
                        void* stream) {
  if (max_steps < 1 || max_steps > kMaxSteps || (emit_bitmap && max_steps > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos <= 0) return 0;
  const dim3 grid((n_pos + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ut = reinterpret_cast<unsigned long long*>(total);
  if (emit_bitmap)
    phf_scan_kernel<true><<<grid, kThreads, 0, st>>>(
        data, n_pos, input_size, max_steps, s0, r, packed, specs, dead_exit,
        seg, halo, cnt, bits, shift, ut);
  else
    phf_scan_kernel<false><<<grid, kThreads, 0, st>>>(
        data, n_pos, input_size, max_steps, s0, r, packed, specs, dead_exit,
        seg, halo, cnt, bits, shift, ut);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int phf_scan_multi(const uint8_t* data, int n_pos, int input_size,
                              int max_steps, const int* s0, const int* r,
                              const int* packed, const int* specs,
                              int n_shards, int dead_exit, int seg, int halo,
                              int emit_bitmap, int* cnt, int* bits, int shift,
                              long long* total, void* stream) {
  if (max_steps < 1 || max_steps > kMaxSteps ||
      (emit_bitmap && max_steps > 32) || n_shards < 1 ||
      n_shards > kMaxShards)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos <= 0) return 0;
  const dim3 grid((n_pos + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ut = reinterpret_cast<unsigned long long*>(total);
  if (emit_bitmap)
    phf_scan_multi_kernel<true><<<grid, kThreads, 0, st>>>(
        data, n_pos, input_size, max_steps, s0, r, packed, specs, n_shards,
        dead_exit, seg, halo, cnt, bits, shift, ut);
  else
    phf_scan_multi_kernel<false><<<grid, kThreads, 0, st>>>(
        data, n_pos, input_size, max_steps, s0, r, packed, specs, n_shards,
        dead_exit, seg, halo, cnt, bits, shift, ut);
  return static_cast<int>(cudaGetLastError());
}
