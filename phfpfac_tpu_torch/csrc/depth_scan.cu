// Depth scan (K2): the stride-1 PFAC walk over compile.depth's tables.
//
// Replaces the Pallas TPU kernel phfpfac_tpu/ops/pallas_depth.py::
// _make_depth_kernel, reached there through _depth_scan_bitmap and
// _depth_scan_count.  The plain torch version of the same walk is
// ops/depth.py::depth_scan_plain.
//
// Per byte offset pos a walker probes the s0 table with the byte at pos
// (PAD_CHAR 256 lies past its 2 banks and misses); step t >= 1 probes
// only the depth-t table T_t at disp + byte[pos + t], verifies
// (g & 255) == c, takes the fin bit 8 and chains disp = g >> 9.  A miss
// carries DISP_MISS; when the host has checked that DISP_MISS + c lies
// past every table (dead_exit), such a walker is dead, else it walks on
// with DISP_MISS.  Segment mode lets step t read only while
// t < min(input_size, seg_end + halo) - pos, for any positive segment.
//
// What bounds it on an H100: bytes.  4 B of staged stream read and 8 B of
// cnt and bits written per position (nothing per position in count
// mode); the tables a live walker reads sit in L1 and L2.  One walker
// per thread (the first port's mapping) left most lanes idle: a warp ran
// until its deepest walker died, and a planted 32-byte match held its
// warp for 31 dependent gathers, each re-reading the stream from device
// memory.  This design (warp_tile.cuh, as K1's in plan_scan.cu):
//
// * Warp tiles, no block barrier: a warp walks kWarpTile = 256 positions
//   at a time with shared memory of its own; persistent blocks take
//   block tiles grid-stride.  A deep walker stalls its warp only.
// * The stream tile in shared memory: the tile's words and kHalo = 32
//   past them (step t <= 31 reads pos + t) arrive by 16-byte cp.async in
//   a two-stage ring while the previous tile walks.  The staged tensor
//   carries one spare TILE (1,024 positions) past n_pos, so the last
//   tile's look-ahead needs no bounds check.
// * Prologue over every position: s0 and step 1 (s0 rarely misses, so
//   step 1 is a full step) run for the tile's positions in registers,
//   8 a lane, and leave the fin bits in out[]; the walkers still live go
//   to the warp's list as (disp << 8) | offset, a ballot per row of 32.
// * The segment cut: a halo of 31 B or more leaves every position 32
//   chars of room, so a tile whose positions also have 32 chars before
//   input_size walks as in exact mode (the depth path's 6,144 + 512 B
//   cut, nearly every tile).  Elsewhere each position's room (at most
//   32) is worked out once, from its offset in its segment (one
//   division a tile, then one conditional subtract a row for a segment
//   of 256 B or more), into a byte per position.
// * Packed rounds: the steps then run one a round over the list,
//   compacted in place, while it fills more than a row of 32; every
//   walker of a round is at the same step, so its operands are
//   warp-uniform.  With a row or less left, each lane walks its entry on
//   to the end.
// * Without dead_exit a miss is not dead, and the list would be the
//   whole tile at every step: each lane then walks its 8 positions
//   through every step in registers, 8 independent chains a lane.
// * Pre-decoded steps: each (off, nb, k0) row comes as base = off * 128,
//   lo = k0 * 128, span = nb * 128 (ops/depth.py::depth_descriptors), by
//   value as a kernel parameter; a probe is one subtract, one unsigned
//   compare and one load.
// * Count mode: per-thread sums in registers across tiles, one block
//   reduction and one atomic per block per launch; a chained scan's
//   shift is read from the previous total on the device.

#include <cstring>

#include "warp_tile.cuh"

namespace {

using wt::kHalo;
using wt::kPer;
using wt::kRing;
using wt::kThreads;
using wt::kTile;
using wt::kWarps;
using wt::kWarpTile;

constexpr int kMaxSteps = 32;  // compile/depth.py MAX_DEPTH_STEPS, s0 included
constexpr unsigned kDispMiss = (1u << 22) - 1u;  // compile/depth.py DISP_MISS

static_assert(kHalo >= kMaxSteps - 1, "step t <= 31 reads inside the copy");
static_assert((kDispMiss << 8) >> 8 == kDispMiss,
              "a list entry holds a displacement and an 8-bit offset");

// One step's table: ready operands (ops/depth.py DEPTH_DESC_FIELDS).
struct Step {
  unsigned base, lo, span;
};
constexpr int kStepWords = 3;
static_assert(sizeof(Step) == kStepWords * 4, "Step is 3 packed words");

struct Steps {
  Step s[kMaxSteps - 1];  // steps 1 .. n_steps - 1
};

// A warp's own shared memory: nothing in it is read by another warp.
template <bool kSeg>
struct __align__(16) WarpSmem {
  int stream[2][kRing];           // this tile's staged words, the next's
  unsigned out[kWarpTile];        // fin bits per position of the tile
  unsigned list[kWarpTile];       // live walkers: (disp << 8) | offset
  unsigned char lim[kSeg ? kWarpTile : 1];  // room before the cut
};

template <bool kSeg>
struct Smem {
  WarpSmem<kSeg> w[kWarps];
  unsigned long long warp_sums[kWarps];
};

// Step t (1 <= t < n_steps) for the walker at tile offset p with `lim`
// chars of room; its fin bit goes into `o`.  -> whether it walks on
// (its new displacement in `disp`).
template <bool kSeg, bool kDead>
__device__ __forceinline__ bool step(const Step& d, int t, const int* ts,
                                     int p, int lim,
                                     const int* __restrict__ packed,
                                     unsigned& disp, unsigned& o) {
  if (kSeg && !(t < lim)) {  // the cut: it reads no further
    if (kDead) return false;
    disp = kDispMiss;
  }
  const unsigned c = static_cast<unsigned>(ts[p + t]);
  const unsigned g = wt::probe(packed, d.base, d.lo, d.span, disp + c);
  const bool hit = static_cast<int>(g) >= 0 && (g & 255u) == c;
  if (hit && (g & 256u)) o |= 1u << t;
  disp = hit ? g >> 9 : kDispMiss;
  return !kDead || disp != kDispMiss;
}

// What every tile of a launch reads.
struct Walk {
  const int* __restrict__ s0;
  unsigned s0_span;
  const int* __restrict__ packed;
  int n_steps, input_size, seg, halo;
  int* __restrict__ cnt;
  int* __restrict__ bits;
  int sh;  // count mode: positions below it do not count
};

// One warp tile at `start`, its staged words in `ts`; kCut: the segment
// cut may stop a walk inside this tile (`lim` holds each position's
// room).  Bitmap mode writes the tile's cnt and bits, count mode adds
// its popcounts to `sum`.  Every lane of the warp calls it.
template <bool kBitmap, bool kCut, bool kDead>
__device__ __forceinline__ void walk_tile(
    const Walk& w, const Steps& steps, const int* ts, unsigned* out,
    unsigned* list, unsigned char* lim, long long start, int lane,
    unsigned long long& sum) {
  if (kCut) {
    // each position's room before min(input_size, seg_end + halo), at
    // most kMaxSteps, from its offset in its segment: one division a
    // tile, then 32 positions a row (a segment of a warp tile or more
    // holds at most one boundary in a row's step)
    const unsigned useg = static_cast<unsigned>(w.seg);
    const unsigned r0 = (static_cast<unsigned>(start) + lane) % useg;
    const bool wide = w.seg >= kWarpTile;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      unsigned r = r0 + 32u * j;
      r = wide ? (r >= useg ? r - useg : r) : r % useg;
      long long room = static_cast<long long>(w.seg) + w.halo - r;
      const long long left = w.input_size - (start + j * 32 + lane);
      if (left < room) room = left;
      lim[j * 32 + lane] = static_cast<unsigned char>(
          room < 0 ? 0 : (room > kMaxSteps ? kMaxSteps : room));
    }
  }

  // ---- prologue: s0 for every position of the tile, in registers ----
  unsigned o[kPer], disp[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned v = wt::probe(w.s0, 0, 0, w.s0_span,
                                 static_cast<unsigned>(ts[j * 32 + lane]));
    o[j] = 0;
    disp[j] = kDispMiss;
    if (static_cast<int>(v) >= 0) {
      o[j] = v & 1u;
      disp[j] = v >> 1;
    }
  }

  if (!kDead) {
    // a miss is not dead: the list would be the whole tile at every
    // step, so each lane walks its kPer positions through every step,
    // kPer independent chains a lane
    for (int t = 1; t < w.n_steps; ++t) {
      const Step& d = steps.s[t - 1];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        step<kCut, false>(d, t, ts, j * 32 + lane,
                          kCut ? lim[j * 32 + lane] : 0, w.packed, disp[j],
                          o[j]);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[j * 32 + lane] = o[j];
    __syncwarp();
    wt::tile_outputs<kBitmap>(out, start, lane, w.sh, w.cnt, w.bits, sum);
    return;
  }

  // ---- step 1 for every position; the walkers still live to the warp's
  // list as (disp << 8) | offset, a ballot per row of 32 ----
  int n = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = j * 32 + lane;
    bool live = disp[j] != kDispMiss;
    if (live && w.n_steps > 1)
      live = step<kCut, true>(steps.s[0], 1, ts, p, kCut ? lim[p] : 0,
                              w.packed, disp[j], o[j]);
    out[p] = o[j];
    live = live && w.n_steps > 2;  // a walker with a step left
    const int i = wt::ballot_slot(live, n);
    if (live) list[i] = (disp[j] << 8) | static_cast<unsigned>(p);
  }
  __syncwarp();

  // ---- the steps over the packed list, one step a round, while the list
  // fills more than one warp row; compacted in place ----
  int t = 2;
  for (; n > 32 && t < w.n_steps; ++t) {
    const Step& d = steps.s[t - 1];
    int kept = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const unsigned e = i < n ? list[i] : 0u;
      __syncwarp();  // this row read before any lane overwrites it
      const int p = static_cast<int>(e & 255u);
      unsigned x = e >> 8;
      bool live = false;
      if (i < n) {
        unsigned fin = 0;
        live = step<kCut, true>(d, t, ts, p, kCut ? lim[p] : 0, w.packed, x,
                                fin);
        if (fin) out[p] |= fin;
      }
      const int slot = wt::ballot_slot(live, kept);  // slot <= i
      if (live) list[slot] = (x << 8) | static_cast<unsigned>(p);
    }
    __syncwarp();
    n = kept;
  }

  // ---- at most one row left: each lane walks its entry on ----
  bool live = n <= 32 && lane < n;  // n > 32 only when the steps ran out
  int p = 0;
  unsigned x = 0, fin = 0;
  if (live) {
    const unsigned e = list[lane];
    p = static_cast<int>(e & 255u);
    x = e >> 8;
  }
  const int room = kCut && live ? lim[p] : 0;
  for (; t < w.n_steps && __any_sync(0xffffffffu, live); ++t)
    if (live)
      live = step<kCut, true>(steps.s[t - 1], t, ts, p, room, w.packed, x,
                              fin);
  if (fin) out[p] |= fin;
  __syncwarp();
  wt::tile_outputs<kBitmap>(out, start, lane, w.sh, w.cnt, w.bits, sum);
}

template <bool kBitmap, bool kSeg, bool kDead>
__global__ void __launch_bounds__(kThreads, wt::kMinBlocks)
depth_scan_kernel(const int* __restrict__ data, int n_pos, Walk w,
                  const __grid_constant__ Steps steps, int shift,
                  const unsigned long long* __restrict__ prev,
                  unsigned long long* __restrict__ total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<kSeg>& sm = *reinterpret_cast<Smem<kSeg>*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  WarpSmem<kSeg>& ws = sm.w[wid];
  w.sh = kBitmap ? 0 : wt::count_shift(shift, prev);
  // the segment cut stops no walk where every position has kMaxSteps - 1
  // chars of room: a halo of that many or more leaves it to input_size
  const bool halo_room = w.halo >= kMaxSteps - 1;
  unsigned long long sum = 0;

  // warp wid walks part wid of the block's tiles, grid-stride
  const long long stride = static_cast<long long>(gridDim.x) * kTile;
  long long start = static_cast<long long>(blockIdx.x) * kTile +
                    wid * kWarpTile;
  if (start < n_pos) wt::load_tile(ws.stream[0], data, start, lane);
  wt::cp_async_commit();
  for (int k = 0; start < n_pos; ++k, start += stride) {
    if (start + stride < n_pos)
      wt::load_tile(ws.stream[(k + 1) & 1], data, start + stride, lane);
    wt::cp_async_commit();
    wt::cp_async_wait<1>();
    __syncwarp();
    const int* ts = ws.stream[k & 1];
    if (kSeg && !(halo_room &&
                  start + kWarpTile + kMaxSteps - 1 <= w.input_size))
      walk_tile<kBitmap, kSeg, kDead>(w, steps, ts, ws.out, ws.list, ws.lim,
                                      start, lane, sum);
    else
      walk_tile<kBitmap, false, kDead>(w, steps, ts, ws.out, ws.list,
                                       ws.lim, start, lane, sum);
    __syncwarp();  // out, the list and this stream slot are reused
  }
  wt::cp_async_wait<0>();

  if (!kBitmap) wt::block_total(sum, sm.warp_sums, total);
}

template <bool B, bool S, bool D>
int launch_one(const int* data, int n_pos, const Walk& w, const Steps& steps,
               int shift, const unsigned long long* prev,
               unsigned long long* total, cudaStream_t st) {
  static int known[wt::kMaxDevices];  // resident blocks, per device
  auto kern = depth_scan_kernel<B, S, D>;
  const int smem = static_cast<int>(sizeof(Smem<S>));
  int grid = 0;
  const cudaError_t e = wt::persistent_grid(kern, smem, n_pos, known, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, smem, st>>>(data, n_pos, w, steps, shift, prev,
                                     total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `desc`: host memory, n_steps - 1 rows of the 3 words of ops/depth.py
// depth_descriptors; n_pos a multiple of kWarpTile; `data` 16-byte
// aligned, with kHalo words readable past n_pos.
extern "C" int depth_scan(const int* data, int n_pos, int input_size,
                          const int* s0, int nb_s0, const int* packed,
                          const unsigned* desc, int n_steps, int dead_exit,
                          int seg, int halo, int emit_bitmap, int* cnt,
                          int* bits, int shift, const long long* prev,
                          long long* total, void* stream) {
  if (n_steps < 1 || n_steps > kMaxSteps || n_pos < 0 ||
      n_pos % kWarpTile || seg < 0 ||
      reinterpret_cast<uintptr_t>(data) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos == 0) return 0;
  Steps steps;
  std::memset(&steps, 0, sizeof(steps));
  if (n_steps > 1) std::memcpy(steps.s, desc, sizeof(Step) * (n_steps - 1));
  Walk w{};
  w.s0 = s0;
  w.s0_span = static_cast<unsigned>(nb_s0) * 128u;
  w.packed = packed;
  w.n_steps = n_steps;
  w.input_size = input_size;
  w.seg = seg;
  w.halo = halo;
  w.cnt = cnt;
  w.bits = bits;
  auto* up = reinterpret_cast<const unsigned long long*>(prev);
  auto* ut = reinterpret_cast<unsigned long long*>(total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool s = seg > 0, d = dead_exit != 0;
#define DEPTH_LAUNCH(B, S, D) \
  return launch_one<B, S, D>(data, n_pos, w, steps, shift, up, ut, st)
  if (emit_bitmap) {
    if (s) { if (d) DEPTH_LAUNCH(true, true, true); DEPTH_LAUNCH(true, true, false); }
    if (d) DEPTH_LAUNCH(true, false, true);
    DEPTH_LAUNCH(true, false, false);
  }
  if (s) { if (d) DEPTH_LAUNCH(false, true, true); DEPTH_LAUNCH(false, true, false); }
  if (d) DEPTH_LAUNCH(false, false, true);
  DEPTH_LAUNCH(false, false, false);
#undef DEPTH_LAUNCH
}
