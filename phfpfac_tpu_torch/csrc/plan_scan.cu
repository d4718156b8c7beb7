// Plan scan (K1): the hybrid-stride PFAC walk over compile.plan's tables.
//
// Replaces the Pallas TPU kernel phfpfac_tpu/ops/pallas_plan.py::
// _make_plan_kernel (step body _run_steps), reached there through
// _plan_scan_bitmap, _plan_scan_count and _plan_scan_count_chain.  The
// plain torch version of the same walk is ops/plan.py::plan_scan_plain.
//
// Per byte offset pos a walker reads the staged pair symbol at pos,
// probes the prologue table p0, then walks the plan's static step
// chain: a "mono" step probes one byte, a "pair" step two bytes plus a
// side-table word for the odd depth.  A walker whose displacement falls
// to the dead sentinel stops (the dead-zone scheme of compile/plan.py
// makes death absorbing, so the remaining steps could only reproduce a
// miss).
//
// What bounds it on an H100: bytes.  4 B of staged stream read and 8 B
// of cnt and bits written per position (nothing per position in count
// mode).  The tables a live walker reads are under 64 KiB, in L1, on
// the four-shard deployments of a few thousand patterns a shard; one
// shard of a word dictionary holds more (0.95 MB of plan tables for
// 156,000 titles, 2.3 MB for 466,543), read through the 50 MB L2, and
// the walk still takes 0.23-0.25 ms a 16 MiB chunk, about 4x its
// bytes bound (one H100 80GB HBM3 at 700 W; PERF.md §6).  Offsets into
// the banks are 32-bit unsigned words: 16 GiB of tables before they
// wrap.  One walker per thread (the first port's mapping) left 83-84% of
// the lanes idle in the step loop, because a warp ran until its longest
// walker died, and the walk's dependent gathers, not the stream, took
// half its time.  This design:
//
// * Warp tiles, no block barrier: a warp walks kWarpTile positions at a
//   time (kPer a lane) with shared memory of its own; a block's kWarps
//   warp tiles make a block tile of kTile positions, and persistent
//   blocks (SMs x resident blocks, occupancy API, current device) take
//   block tiles grid-stride.  A deep walker stalls its warp only, and
//   the other warps of the SM go on streaming.  Count mode sums in
//   registers across tiles: one block reduction and one atomic per
//   block per launch.
// * The stream tile in shared memory: a warp tile's kWarpTile + kHalo
//   staged words (kHalo = 32 covers the deepest window, depth0 - 1 <=
//   31) are copied into the warp's two-stage ring with 16-byte cp.async
//   while the previous tile walks, so every window read pairs[pos + o]
//   is a shared-memory read.  The staged tensor carries one spare TILE
//   (1,024 positions) past n_pos, so the look-ahead needs no bounds
//   check.
// * Packed live walkers: the prologue runs for every position of the
//   tile and leaves the tile's fin bits in the warp's out[kWarpTile];
//   the walkers it leaves live go to the warp's list (a ballot per row
//   of 32).  The steps then run over the list, one step a round,
//   compacting it in place, so every lane of a row holds a live walker;
//   all walkers of a round are at the same step, so a step's operands
//   are warp-uniform.  When a row or less is left, each lane walks its
//   entry on to the end.  A list entry owns its position: fin bits go
//   into out[] without atomics.  At the end of the tile cnt = popc(out)
//   and bits = out leave in 16-byte stores.
// * Pre-decoded steps: the host turns each step row into ready operands
//   (ops/plan.py::step_descriptors), so a probe is one subtract, one
//   unsigned compare and one load,
//       u = idx - lo;  u < span ? banks[base + u] : -1,
//   the value of banks[(off + (idx >> 7) - k0) * 128 + (idx & 127)]
//   inside k0 <= idx >> 7 < k0 + nb.  The descriptors travel by value as
//   a kernel parameter and are read through the constant cache.
//
// K1' (plan_scan_compact_a): the same kernel over the steps before a
// compaction cut; replaces _make_plan_kernel with emit_surv, reached
// through _plan_scan_bitmap_compact and _plan_scan_count_compact.  At
// the cut the packed list IS the survivor set.  It goes to the cap-sized
// (pos, disp) buffers 32 entries to an atomicAdd on a device counter: a
// list of more than a row at once, a last row through a per-warp buffer
// that leaves when it holds 32.  The counter keeps counting past cap, so
// it is the true survivor total; entries past cap are dropped and the
// caller rescans on count > cap.  Slots are unordered; no output depends
// on their order.

#include <algorithm>
#include <cstring>

#include "plan_step.cuh"

namespace {

using plan::Codes;
using plan::count_shift;
using plan::kMaxSteps;
using plan::probe;
using plan::segment_room;
using plan::Step;
using plan::Steps;

constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;        // positions per lane of a warp's tile
constexpr int kWarpTile = 32 * kPer;       // positions per warp tile
constexpr int kTile = kWarps * kWarpTile;  // per block tile (PLAN_TILE)
constexpr int kHalo = 32;      // staged words a tile's windows read past it
constexpr int kMinBlocks = 5;  // resident blocks per SM (shared memory)

static_assert(kWarpTile % 4 == 0 && (kWarpTile + kHalo) % 4 == 0,
              "a warp tile is whole 16-byte copies and stores");
static_assert(kWarpTile <= 65536, "a list entry keeps its offset in 16 bits");

// A warp's own shared memory: nothing in it is read by another warp.
struct WarpSmem {
  int stream[2][kWarpTile + kHalo];  // this tile's staged words, the next's
  unsigned out[kWarpTile];           // fin bits per position of the tile
  unsigned disp[kWarpTile];          // live walkers: displacement ...
  unsigned short pos[kWarpTile];     // ... and offset in the tile
};

// K1' survivors wait in a warp's buffer and leave 32 to an atomic.
constexpr int kSurvBuf = 64;  // < 32 waiting + <= 32 added

template <bool kSurv>
struct Smem {
  WarpSmem w[kWarps];
  int2 surv[kSurv ? kWarps : 1][kSurv ? kSurvBuf : 1];
  unsigned long long warp_sums[kWarps];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of the staged words of the warp tile at `start` (and
// kHalo past them); every lane of the warp calls it.
__device__ __forceinline__ void load_tile(int* dst,
                                          const int* __restrict__ pairs,
                                          long long start, int lane) {
  constexpr int kQuads = (kWarpTile + kHalo) / 4;
  const int4* src = reinterpret_cast<const int4*>(pairs + start);
  int4* d = reinterpret_cast<int4*>(dst);
  for (int i = lane; i < kQuads; i += 32) cp_async16(d + i, src + i);
}

// One step for one walker at tile offset p; sets its fin bits in out[p].
// -> whether it is still live (its new displacement in `disp`).
template <bool kSeg>
__device__ __forceinline__ bool walk_step(
    const Step& d, const int* ts, unsigned* out, int p, int room,
    const Codes& c, const int* __restrict__ packed,
    const int* __restrict__ side, unsigned dead, unsigned& disp) {
  if (kSeg && !(room > d.o)) return false;  // the cut: it reads no further
  bool hit;
  const unsigned fin_bits = plan::step_bits<kSeg>(
      d, static_cast<unsigned>(ts[p + d.o]), room, c, packed, side, disp,
      hit);
  if (fin_bits) out[p] |= fin_bits;
  return hit && disp != dead;
}

// Writes k <= 32 survivors (lane i < k holds entry e) to the cap-sized
// buffers with one atomic on the counter, which counts past cap.
__device__ __forceinline__ void put_survivors(int k, int2 e, int lane,
                                              int cap,
                                              int* __restrict__ surv_pos,
                                              int* __restrict__ surv_disp,
                                              int* __restrict__ surv_count) {
  int slot = 0;
  if (lane == 0) slot = atomicAdd(surv_count, k);
  slot = __shfl_sync(0xffffffffu, slot, 0) + lane;
  if (lane < k && slot < cap) {
    surv_pos[slot] = e.x;
    surv_disp[slot] = e.y;
  }
}

// K1': the warp's walkers live at the cut.  A full list (more than a
// row) leaves at once, a row at a time; the live lanes of the last row
// join the warp's buffer `buf` (`nbuf` entries), which leaves when it
// holds 32.  Every lane calls it.
__device__ __forceinline__ void emit_survivors(
    int n, const unsigned short* lp, const unsigned* ld, bool from_list,
    bool live, int p, unsigned disp, long long start, int lane, int2* buf,
    int& nbuf, int cap, int* __restrict__ surv_pos,
    int* __restrict__ surv_disp, int* __restrict__ surv_count) {
  if (from_list) {
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      int2 e = make_int2(0, 0);
      if (i < n) e = make_int2(static_cast<int>(start + lp[i]),
                               static_cast<int>(ld[i]));
      put_survivors(min(32, n - i0), e, lane, cap, surv_pos, surv_disp,
                    surv_count);
    }
    return;
  }
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (!m) return;
  if (live)
    buf[nbuf + __popc(m & ((1u << lane) - 1u))] =
        make_int2(static_cast<int>(start + p), static_cast<int>(disp));
  nbuf += __popc(m);
  if (nbuf < 32) return;
  __syncwarp();
  put_survivors(32, buf[lane], lane, cap, surv_pos, surv_disp, surv_count);
  nbuf -= 32;
  __syncwarp();
  if (lane < nbuf) buf[lane] = buf[32 + lane];
  __syncwarp();
}

template <bool kBitmap, bool kSeg, bool kSurv>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
plan_scan_kernel(const int* __restrict__ pairs, int n_pos,
                 const int* __restrict__ p0, unsigned p0_span,
                 const int* __restrict__ packed,
                 const int* __restrict__ side,
                 const __grid_constant__ Steps steps, int n_steps, int cb,
                 int p0_mode, unsigned dead, int seg, int halo,
                 int* __restrict__ cnt, int* __restrict__ bits, int shift,
                 const unsigned long long* __restrict__ prev,
                 unsigned long long* __restrict__ total, int cap,
                 int* __restrict__ surv_pos, int* __restrict__ surv_disp,
                 int* __restrict__ surv_count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<kSurv>& sm = *reinterpret_cast<Smem<kSurv>*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  WarpSmem& ws = sm.w[wid];
  const Codes c(cb);
  const unsigned cbm = c.cbm;
  const int sh = kBitmap ? 0 : count_shift(shift, prev);
  unsigned long long sum = 0;
  int nbuf = 0;  // K1' survivors waiting in sm.surv[wid]

  // warp wid walks part wid of the block's tiles, grid-stride
  const long long stride = static_cast<long long>(gridDim.x) * kTile;
  long long start = static_cast<long long>(blockIdx.x) * kTile +
                    wid * kWarpTile;
  if (start < n_pos) load_tile(ws.stream[0], pairs, start, lane);
  cp_async_commit();
  for (int k = 0; start < n_pos; ++k, start += stride) {
    if (start + stride < n_pos)
      load_tile(ws.stream[(k + 1) & 1], pairs, start + stride, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int* ts = ws.stream[k & 1];
    const int seg_base = static_cast<int>(start);

    // ---- prologue at offset 0, for every position of the tile ----
    unsigned dp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = j * 32 + lane;
      const unsigned c0 = static_cast<unsigned>(ts[p]);
      unsigned idx;
      if (p0_mode == 0) {  // dense depths-1+2 table, indexed by the pair
        idx = c0;
      } else if (p0_mode == 2) {  // s0x: (code1, high bits of code2)
        const int sb = cb - 6;
        idx = ((c0 & cbm) << sb) | ((c0 >> (cb + 6)) & ((1u << sb) - 1u));
      } else {  // s0: depth-1 code
        idx = c0 & cbm;
      }
      const unsigned v = probe(p0, 0, 0, p0_span, idx);
      unsigned out = 0;
      dp[j] = dead;
      if (static_cast<int>(v) >= 0) {
        out = v & 1u;
        if (p0_mode == 0) {
          if ((v & 2u) &&
              (!kSeg || segment_room(seg_base + p, seg, halo) > 1))
            out |= 2u;
          dp[j] = v >> 2;
        } else {
          dp[j] = v >> 1;
        }
      }
      ws.out[p] = out;
    }
    // the live walkers to the warp's list: a ballot per row of 32
    int n = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool live = dp[j] != dead;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int i = n + __popc(m & lt);
        ws.pos[i] = static_cast<unsigned short>(j * 32 + lane);
        ws.disp[i] = dp[j];
      }
      n += __popc(m);
    }
    __syncwarp();

    // ---- the steps over the packed list, one step a round, while the
    // list fills more than one warp row; compacted in place ----
    int s = 0;
    for (; n > 32 && s < n_steps; ++s) {
      const Step& d = steps.s[s];
      int kept = 0;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        int p = 0;
        unsigned x = dead;
        if (i < n) {
          p = ws.pos[i];
          x = ws.disp[i];
        }
        __syncwarp();  // this row read before any lane overwrites it
        bool live = false;
        if (i < n)
          live = walk_step<kSeg>(
              d, ts, ws.out, p,
              kSeg ? segment_room(seg_base + p, seg, halo) : 0, c,
              packed, side, dead, x);
        const unsigned m = __ballot_sync(0xffffffffu, live);
        if (live) {
          const int j = kept + __popc(m & lt);  // j <= i: in place
          ws.pos[j] = static_cast<unsigned short>(p);
          ws.disp[j] = x;
        }
        kept += __popc(m);
      }
      __syncwarp();
      n = kept;
    }

    // ---- at most one row left: each lane walks its entry on ----
    const bool in_list = n > 32;  // only when the steps ran out first
    int p = 0;
    unsigned x = dead;
    bool live = !in_list && lane < n;
    if (live) {
      p = ws.pos[lane];
      x = ws.disp[lane];
    }
    const int room = kSeg ? segment_room(seg_base + p, seg, halo) : 0;
    for (; s < n_steps && __any_sync(0xffffffffu, live); ++s)
      if (live)
        live = walk_step<kSeg>(steps.s[s], ts, ws.out, p, room, c, packed,
                               side, dead, x);
    if (kSurv)  // the walkers live at the cut
      emit_survivors(n, ws.pos, ws.disp, in_list, live, p, x, start, lane,
                     sm.surv[wid], nbuf, cap, surv_pos, surv_disp,
                     surv_count);
    __syncwarp();

    // ---- the tile's outputs, 16 bytes a store ----
    const uint4* out4 = reinterpret_cast<const uint4*>(ws.out);
#pragma unroll
    for (int q = lane; q < kWarpTile / 4; q += 32) {
      const uint4 o = out4[q];
      if (kBitmap) {
        reinterpret_cast<int4*>(cnt + start)[q] =
            make_int4(__popc(o.x), __popc(o.y), __popc(o.z), __popc(o.w));
        reinterpret_cast<uint4*>(bits + start)[q] = o;
      } else {
        const long long p4 = start + 4 * q;
        sum += (p4 >= sh ? __popc(o.x) : 0) + (p4 + 1 >= sh ? __popc(o.y) : 0) +
               (p4 + 2 >= sh ? __popc(o.z) : 0) +
               (p4 + 3 >= sh ? __popc(o.w) : 0);
      }
    }
    __syncwarp();  // out, the list and this stream slot are reused
  }
  cp_async_wait<0>();
  if (kSurv && nbuf) {
    __syncwarp();
    put_survivors(nbuf, sm.surv[wid][lane], lane, cap, surv_pos, surv_disp,
                  surv_count);
  }

  if (!kBitmap) {
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, d);
    if (lane == 0) sm.warp_sums[wid] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long t = 0;
      for (int w = 0; w < kWarps; ++w) t += sm.warp_sums[w];
      if (t) atomicAdd(total, t);
    }
  }
}

struct Launch {
  const int* pairs;
  int n_pos;
  const int* p0;
  unsigned p0_span;
  const int* packed;
  const int* side;
  int n_steps, cb, p0_mode;
  unsigned dead;
  int seg, halo;
  int* cnt;
  int* bits;
  int shift;
  const unsigned long long* prev;
  unsigned long long* total;
  int cap;
  int* surv_pos;
  int* surv_disp;
  int* surv_count;
};

// Resident blocks per SM of one instantiation, on the current device.
template <bool B, bool S, bool V>
cudaError_t occupancy(int* per_sm) {
  auto kern = plan_scan_kernel<B, S, V>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem<V>)));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads,
                                                       sizeof(Smem<V>));
}

constexpr int kMaxDevices = 64;

// Resident blocks on the whole current device, asked once per device.
template <bool B, bool S, bool V>
cudaError_t resident_blocks(int* blocks) {
  static int known[kMaxDevices];  // 0: not asked yet
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && known[dev]) {
    *blocks = known[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = occupancy<B, S, V>(&per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) known[dev] = *blocks;
  return cudaSuccess;
}

template <bool B, bool S, bool V>
int launch_one(const Launch& a, const Steps& steps, cudaStream_t st) {
  int resident = 0;
  const cudaError_t e = resident_blocks<B, S, V>(&resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (a.n_pos + kTile - 1) / kTile;
  const int grid = std::min(tiles, resident);
  plan_scan_kernel<B, S, V><<<grid, kThreads, sizeof(Smem<V>), st>>>(
      a.pairs, a.n_pos, a.p0, a.p0_span, a.packed, a.side, steps,
      a.n_steps, a.cb, a.p0_mode, a.dead, a.seg, a.halo, a.cnt, a.bits,
      a.shift, a.prev, a.total, a.cap, a.surv_pos, a.surv_disp,
      a.surv_count);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Launch& a, const unsigned* desc, int emit_bitmap,
           void* stream) {
  if (a.n_steps < 0 || a.n_steps > kMaxSteps || a.n_pos % kWarpTile ||
      reinterpret_cast<uintptr_t>(a.pairs) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_pos <= 0) return 0;
  Steps steps;
  std::memset(&steps, 0, sizeof(steps));
  if (a.n_steps) std::memcpy(steps.s, desc, sizeof(Step) * a.n_steps);
  for (int i = 0; i < a.n_steps; ++i)  // every window inside the tile's copy
    if (steps.s[i].o < 0 || steps.s[i].o >= kHalo)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool s = a.seg > 0, v = a.surv_count != nullptr;
#define PLAN_LAUNCH(B, S, V) return launch_one<B, S, V>(a, steps, st)
  if (emit_bitmap) {
    if (s) { if (v) PLAN_LAUNCH(true, true, true); PLAN_LAUNCH(true, true, false); }
    if (v) PLAN_LAUNCH(true, false, true);
    PLAN_LAUNCH(true, false, false);
  }
  if (s) { if (v) PLAN_LAUNCH(false, true, true); PLAN_LAUNCH(false, true, false); }
  if (v) PLAN_LAUNCH(false, false, true);
  PLAN_LAUNCH(false, false, false);
#undef PLAN_LAUNCH
}

Launch args(const int* pairs, int n_pos, const int* p0,
            int nb_p0, const int* packed, const int* side, int n_steps,
            int cb, int p0_mode, int p0_miss, int seg, int halo, int* cnt,
            int* bits, int shift, const long long* prev, long long* total) {
  Launch a{};
  a.pairs = pairs;
  a.n_pos = n_pos;
  a.p0 = p0;
  a.p0_span = static_cast<unsigned>(nb_p0) * 128u;
  a.packed = packed;
  a.side = side;
  a.n_steps = n_steps;
  a.cb = cb;
  a.p0_mode = p0_mode;
  a.dead = static_cast<unsigned>(p0_miss);
  a.seg = seg;
  a.halo = halo;
  a.cnt = cnt;
  a.bits = bits;
  a.shift = shift;
  a.prev = reinterpret_cast<const unsigned long long*>(prev);
  a.total = reinterpret_cast<unsigned long long*>(total);
  return a;
}

}  // namespace

// `desc`: host memory, n_steps rows of the 17 words of ops/plan.py
// step_descriptors; n_pos a multiple of kWarpTile; `pairs` 16-byte
// aligned, with kHalo words readable past n_pos.
extern "C" int plan_scan(const int* pairs, int n_pos,
                         const int* p0, int nb_p0, const int* packed,
                         const int* side, const unsigned* desc, int n_steps,
                         int cb, int p0_mode, int p0_miss, int seg, int halo,
                         int emit_bitmap, int* cnt, int* bits, int shift,
                         const long long* prev, long long* total,
                         void* stream) {
  const Launch a = args(pairs, n_pos, p0, nb_p0, packed, side,
                        n_steps, cb, p0_mode, p0_miss, seg, halo, cnt, bits,
                        shift, prev, total);
  return launch(a, desc, emit_bitmap, stream);
}

// K1': the first `n_steps` steps only (the descriptors before the cut);
// appends (pos, disp) of every walker live after them to
// surv_pos/surv_disp[cap] and adds their number to *surv_count (zeroed
// by the caller).
extern "C" int plan_scan_compact_a(
    const int* pairs, int n_pos, const int* p0, int nb_p0,
    const int* packed, const int* side, const unsigned* desc, int n_steps,
    int cb, int p0_mode, int p0_miss, int seg, int halo, int emit_bitmap,
    int* cnt, int* bits, int shift, const long long* prev, long long* total,
    int cap, int* surv_pos, int* surv_disp, int* surv_count, void* stream) {
  if (!surv_pos || !surv_disp || !surv_count || cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a = args(pairs, n_pos, p0, nb_p0, packed, side, n_steps,
                  cb, p0_mode, p0_miss, seg, halo, cnt, bits, shift, prev,
                  total);
  a.cap = cap;
  a.surv_pos = surv_pos;
  a.surv_disp = surv_disp;
  a.surv_count = surv_count;
  return launch(a, desc, emit_bitmap, stream);
}

// The kernel's geometry, for the records: positions per tile, threads
// and dynamic shared memory per block, and resident blocks per SM of
// the bitmap instantiation under the segment cut on the current device.
extern "C" int plan_scan_geometry(int* tile, int* threads, int* smem_bytes,
                                  int* blocks_per_sm) {
  *tile = kTile;
  *threads = kThreads;
  *smem_bytes = static_cast<int>(sizeof(Smem<false>));
  return static_cast<int>(occupancy<true, true, false>(blocks_per_sm));
}
