// Dependent-gather probe (P1): how fast this card runs the scan
// kernels' inner operation, a chain of table loads each of whose
// address is the previous load's value.
//
// Replaces the Pallas TPU probes
//   bench/lane_probe.py::probe_fn (_probe_kernel; arms i32 / i16 / i8 /
//     packed) and ::alu_fn (the same chain with no load),
//   bench/ilp_probe.py::make_fn (how many independent chains run
//     interleaved),
//   bench/micro_tpu.py::bench_pallas_gather, ::bench_vpu_ilp (a gather
//     inside a kernel; dependent ALU chains; the probe loop),
//   bench/lane_iso.py::pcall (which int16 / int8 operations the
//     compiler takes: here, that the narrow instantiations below build
//     and agree with the plain version is the answer).
// The plain torch version is probes/gather.py::probe_gather_plain.
//
// Every thread carries K independent walkers; every walker takes `reps`
// dependent steps
//     idx = (idx + table[idx & mask] + (r + 1)) * mul        (mod 2^32)
// which is lane_probe's recurrence for mul = 1; an odd `mul` spreads a
// narrow element type's chain over the whole table (an int8 entry alone
// moves the index by at most 127).  The table holds T entries (a power
// of two) of int32, int16, int8 (sign-extended), or two unsigned 16-bit
// entries per int32 word ("packed": word idx >> 1, half idx & 1).  The
// "alu" arm loads nothing: a = v + (r + 1); b = a ^ v; v = b > 0 ? a : b.
//
// What bounds it on an H100: latency.  The bytes that must move are the
// walkers' 4 B in and 4 B out and the table once; the time goes to
// `reps` round trips to L1, L2 or device memory per walker, hidden only
// by the other resident warps and by the K walkers a thread interleaves.
// That measured rate, by table size and element type, is the yardstick
// for the scan kernels, whose walks are the same chains.  Walker j of
// thread t is walker t + j * n_threads, so a warp's loads of `in` and
// stores of `out` coalesce.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct I32 {
  static __device__ __forceinline__ uint32_t load(const void* t, uint32_t v) {
    return static_cast<uint32_t>(__ldg(static_cast<const int*>(t) + v));
  }
};
struct I16 {
  static __device__ __forceinline__ uint32_t load(const void* t, uint32_t v) {
    return static_cast<uint32_t>(
        static_cast<int32_t>(__ldg(static_cast<const short*>(t) + v)));
  }
};
struct I8 {
  static __device__ __forceinline__ uint32_t load(const void* t, uint32_t v) {
    return static_cast<uint32_t>(
        static_cast<int32_t>(__ldg(static_cast<const signed char*>(t) + v)));
  }
};
struct Packed {
  static __device__ __forceinline__ uint32_t load(const void* t, uint32_t v) {
    const uint32_t w = __ldg(static_cast<const uint32_t*>(t) + (v >> 1));
    return (w >> ((v & 1u) << 4)) & 0xFFFFu;
  }
};
struct Alu {};

template <typename Arm, int K>
__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const void* __restrict__ table, uint32_t mask,
                    const int* __restrict__ in, int* __restrict__ out,
                    int n_threads, int reps, uint32_t mul) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  uint32_t idx[K];
#pragma unroll
  for (int j = 0; j < K; ++j)
    idx[j] = static_cast<uint32_t>(in[t + j * n_threads]);
  for (int r = 0; r < reps; ++r) {
    const uint32_t step = static_cast<uint32_t>(r + 1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if constexpr (std::is_same<Arm, Alu>::value) {
        const uint32_t a = idx[j] + step;
        const uint32_t b = a ^ idx[j];
        idx[j] = static_cast<int32_t>(b) > 0 ? a : b;
      } else {
        idx[j] = (idx[j] + Arm::load(table, idx[j] & mask) + step) * mul;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    out[t + j * n_threads] = static_cast<int>(idx[j]);
}

template <typename Arm>
int launch_k(int k, const void* table, uint32_t mask, const int* in, int* out,
             int n_walkers, int reps, uint32_t mul, cudaStream_t st) {
  const int n_threads = n_walkers / k;
  const dim3 grid((n_threads + kThreads - 1) / kThreads);
#define PROBE_LAUNCH(KK)                                                 \
  probe_gather_kernel<Arm, KK><<<grid, kThreads, 0, st>>>(               \
      table, mask, in, out, n_threads, reps, mul)
  switch (k) {
    case 1: PROBE_LAUNCH(1); break;
    case 2: PROBE_LAUNCH(2); break;
    case 4: PROBE_LAUNCH(4); break;
    case 8: PROBE_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROBE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// arm: 0 int32, 1 int16, 2 int8, 3 packed (two 16-bit entries per int32
// word), 4 alu (no table).  `entries` (a power of two) is the table's
// length in entries; `n_walkers` a multiple of `k`, k in {1, 2, 4, 8}.
extern "C" int probe_gather(const void* table, long long entries, int arm,
                            int k, const int* in, int* out, int n_walkers,
                            int reps, unsigned int mul, void* stream) {
  if (n_walkers <= 0) return 0;
  if (k <= 0 || n_walkers % k || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (arm != 4 && (!table || entries <= 0 || (entries & (entries - 1)) ||
                   entries > (1ll << 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t mask = static_cast<uint32_t>(entries - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case 0: return launch_k<I32>(k, table, mask, in, out, n_walkers, reps, mul, st);
    case 1: return launch_k<I16>(k, table, mask, in, out, n_walkers, reps, mul, st);
    case 2: return launch_k<I8>(k, table, mask, in, out, n_walkers, reps, mul, st);
    case 3: return launch_k<Packed>(k, table, mask, in, out, n_walkers, reps, mul, st);
    case 4: return launch_k<Alu>(k, table, mask, in, out, n_walkers, reps, mul, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
