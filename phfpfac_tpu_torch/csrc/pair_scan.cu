// Pair scan (K3): the stride-2 PFAC walk over compile.pair's tables.
//
// Replaces the Pallas TPU kernel phfpfac_tpu/ops/pallas_pair.py::
// _make_pair_kernel, reached there through _pair_scan_bitmap and
// _pair_scan_count.  The plain torch version of the same walk is
// ops/pair.py::pair_scan_plain.
//
// Per byte offset pos a walker reads the staged pair-symbol stream
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
// such a walker is dead; else it walks every step.  There is no segment
// cut: a stride-2 walk cannot reproduce a cut between a pair's two chars.
//
// What bounds it on an H100: bytes.  4 B of staged stream read and 8 B of
// cnt and bits written per position (nothing per position in count
// mode); the tables a live walker reads sit in L1 and L2.  One walker
// per thread (the first port's mapping) ran each warp until its deepest
// walker died, re-reading the stream from device memory at every step.
// This design is K2's (depth_scan.cu; the skeleton in warp_tile.cuh):
//
// * Warp tiles of kWarpTile = 256 positions with shared memory of their
//   own and no block barrier; persistent blocks take block tiles
//   grid-stride.
// * The stream tile and kHalo = 32 words past it (pair step k <= 15
//   reads pos + 2k <= pos + 30) arrive by 16-byte cp.async in a
//   two-stage ring; the staged spare TILE covers the last tile's halo.
// * Prologue over every position: p0 and pair step 1 in registers, 8
//   positions a lane, the fin bits into out[]; the walkers still live go
//   to the warp's list (displacement, offset), a ballot per row of 32.
// * Packed rounds: one pair step a round over the list, compacted in
//   place, while it fills more than a row; then each lane walks its
//   entry on.
// * Without dead_exit a miss is not dead, and the list would be the
//   whole tile at every step: each lane then walks its 8 positions
//   through every step in registers, 8 independent chains a lane.
// * Pre-decoded steps: the 7-field step rows (ops/pair.py STEP_FIELDS)
//   come as ready operands for the pair table and the side table, whose
//   word index, field shift and field mask are set by its byte or
//   nibble layout (ops/pair.py::pair_descriptors), by value as a kernel
//   parameter.
// * Count mode: per-thread sums in registers, one block reduction and
//   one atomic per block per launch.

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

constexpr int kMaxSteps = 16;  // pair steps of a 32-deep bitmap, p0 included

static_assert(kHalo >= 2 * (kMaxSteps - 1),
              "pair step k <= 15 reads inside the copy");

// One pair step's ready operands (ops/pair.py PAIR_DESC_FIELDS, in
// order): the pair table as base, lo, span; the side table likewise; the
// side word of sidx is banks[sidx >> wsh], its field
// (w >> ((sidx & smask) << fsh)) & fmask against (a1 & amask) + 1.
struct Step {
  unsigned base, lo, span;
  unsigned s_base, s_lo, s_span;
  unsigned wsh, smask, fsh, fmask, amask;
};
constexpr int kStepWords = 11;
static_assert(sizeof(Step) == kStepWords * 4, "Step is 11 packed words");

struct Steps {
  Step s[kMaxSteps - 1];  // pair steps 1 .. n_pair_steps - 1
};

// A warp's own shared memory: nothing in it is read by another warp.
struct __align__(16) WarpSmem {
  int stream[2][kRing];           // this tile's staged words, the next's
  unsigned out[kWarpTile];        // fin bits per position of the tile
  unsigned disp[kWarpTile];       // live walkers: displacement ...
  unsigned char pos[kWarpTile];   // ... and offset in the tile
};

struct Smem {
  WarpSmem w[kWarps];
  unsigned long long warp_sums[kWarps];
};

// What every step reads of the code width.
struct Coding {
  unsigned cbm;        // a code: (1 << cb) - 1
  unsigned pair_mask;  // a pair symbol: (1 << 2cb) - 1
  unsigned fin_bit;    // a pair entry's fin flag: 1 << 2cb
  int vsh;             // its displacement: g >> (2cb + 1)
  unsigned miss;       // disp_miss
};

// Pair step k (1 <= k < n_pair_steps) for the walker at tile offset p;
// its fin bits 2k and 2k+1 go into `o`.  -> whether it walks on (its new
// displacement in `disp`).
template <bool kDead>
__device__ __forceinline__ bool step(const Step& d, int k, const int* ts,
                                     int p, const Coding& c,
                                     const int* __restrict__ packed,
                                     const int* __restrict__ side,
                                     unsigned& disp, unsigned& o) {
  const unsigned cur = static_cast<unsigned>(ts[p + 2 * k]);
  // side probe: the match at depth 2k+1 (a miss reads as all ones, never
  // a code + 1)
  const unsigned a1 = cur & c.cbm;
  const unsigned sidx = disp + a1;
  const unsigned w =
      wt::probe(side, d.s_base, d.s_lo, d.s_span, sidx >> d.wsh);
  const bool fin_mid =
      ((w >> ((sidx & d.smask) << d.fsh)) & d.fmask) == (a1 & d.amask) + 1u;
  // pair probe: the match at depth 2k+2 and the next displacement
  const unsigned g = wt::probe(packed, d.base, d.lo, d.span, disp + cur);
  const bool hit = static_cast<int>(g) >= 0 && (g & c.pair_mask) == cur;
  if (fin_mid) o |= 1u << (2 * k);
  if (hit && (g & c.fin_bit)) o |= 2u << (2 * k);
  disp = hit ? g >> c.vsh : c.miss;
  return !kDead || disp != c.miss;
}

template <bool kBitmap, bool kDead>
__global__ void __launch_bounds__(kThreads, wt::kMinBlocks)
pair_scan_kernel(const int* __restrict__ pairs, int n_pos,
                 const int* __restrict__ p0, unsigned p0_span,
                 const int* __restrict__ packed,
                 const int* __restrict__ side,
                 const __grid_constant__ Steps steps, int n_pair_steps,
                 int cb, unsigned disp_miss, int* __restrict__ cnt,
                 int* __restrict__ bits, int shift,
                 unsigned long long* __restrict__ total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  WarpSmem& ws = sm.w[wid];
  Coding c;
  c.cbm = (1u << cb) - 1u;
  c.pair_mask = (1u << (2 * cb)) - 1u;
  c.fin_bit = 1u << (2 * cb);
  c.vsh = 2 * cb + 1;
  c.miss = disp_miss;
  unsigned long long sum = 0;

  // warp wid walks part wid of the block's tiles, grid-stride
  const long long stride = static_cast<long long>(gridDim.x) * kTile;
  long long start = static_cast<long long>(blockIdx.x) * kTile +
                    wid * kWarpTile;
  if (start < n_pos) wt::load_tile(ws.stream[0], pairs, start, lane);
  wt::cp_async_commit();
  for (int k = 0; start < n_pos; ++k, start += stride) {
    if (start + stride < n_pos)
      wt::load_tile(ws.stream[(k + 1) & 1], pairs, start + stride, lane);
    wt::cp_async_commit();
    wt::cp_async_wait<1>();
    __syncwarp();
    const int* ts = ws.stream[k & 1];

    // ---- prologue: p0 for every position of the tile, in registers ----
    unsigned o[kPer], disp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned v = wt::probe(p0, 0, 0, p0_span,
                                   static_cast<unsigned>(ts[j * 32 + lane]));
      o[j] = 0;
      disp[j] = c.miss;
      if (static_cast<int>(v) >= 0) {
        o[j] = v & 3u;
        disp[j] = v >> 2;
      }
    }

    if (!kDead) {
      // a miss is not dead: the list would be the whole tile at every
      // step, so each lane walks its kPer positions through every step,
      // kPer independent chains a lane
      for (int s = 1; s < n_pair_steps; ++s) {
        const Step& d = steps.s[s - 1];
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          step<false>(d, s, ts, j * 32 + lane, c, packed, side, disp[j],
                      o[j]);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) ws.out[j * 32 + lane] = o[j];
      __syncwarp();
      wt::tile_outputs<kBitmap>(ws.out, start, lane, shift, cnt, bits, sum);
      __syncwarp();  // out and this stream slot are reused
      continue;
    }

    // ---- pair step 1 for every position; the walkers still live to
    // the warp's list, a ballot per row of 32 ----
    int n = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = j * 32 + lane;
      bool live = disp[j] != c.miss;
      if (live && n_pair_steps > 1)
        live = step<true>(steps.s[0], 1, ts, p, c, packed, side, disp[j],
                          o[j]);
      ws.out[p] = o[j];
      live = live && n_pair_steps > 2;  // a walker with a step left
      const int i = wt::ballot_slot(live, n);
      if (live) {
        ws.pos[i] = static_cast<unsigned char>(p);
        ws.disp[i] = disp[j];
      }
    }
    __syncwarp();

    // ---- the pair steps over the packed list, one a round, while the
    // list fills more than one warp row; compacted in place ----
    int s = 2;
    for (; n > 32 && s < n_pair_steps; ++s) {
      const Step& d = steps.s[s - 1];
      int kept = 0;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        int p = 0;
        unsigned x = 0;
        if (i < n) {
          p = ws.pos[i];
          x = ws.disp[i];
        }
        __syncwarp();  // this row read before any lane overwrites it
        bool live = false;
        if (i < n) {
          unsigned fin = 0;
          live = step<true>(d, s, ts, p, c, packed, side, x, fin);
          if (fin) ws.out[p] |= fin;
        }
        const int slot = wt::ballot_slot(live, kept);  // slot <= i
        if (live) {
          ws.pos[slot] = static_cast<unsigned char>(p);
          ws.disp[slot] = x;
        }
      }
      __syncwarp();
      n = kept;
    }

    // ---- at most one row left: each lane walks its entry on ----
    bool live = n <= 32 && lane < n;  // n > 32 only when the steps ran out
    int p = 0;
    unsigned x = 0, fin = 0;
    if (live) {
      p = ws.pos[lane];
      x = ws.disp[lane];
    }
    for (; s < n_pair_steps && __any_sync(0xffffffffu, live); ++s)
      if (live)
        live = step<true>(steps.s[s - 1], s, ts, p, c, packed, side, x, fin);
    if (fin) ws.out[p] |= fin;
    __syncwarp();

    wt::tile_outputs<kBitmap>(ws.out, start, lane, shift, cnt, bits, sum);
    __syncwarp();  // out, the list and this stream slot are reused
  }
  wt::cp_async_wait<0>();

  if (!kBitmap) wt::block_total(sum, sm.warp_sums, total);
}

struct Launch {
  const int* pairs;
  int n_pos;
  const int* p0;
  unsigned p0_span;
  const int* packed;
  const int* side;
  int n_pair_steps, cb;
  unsigned disp_miss;
  int* cnt;
  int* bits;
  int shift;
  unsigned long long* total;
};

template <bool B, bool D>
int launch_one(const Launch& a, const Steps& steps, cudaStream_t st) {
  static int known[wt::kMaxDevices];  // resident blocks, per device
  auto kern = pair_scan_kernel<B, D>;
  const int smem = static_cast<int>(sizeof(Smem));
  int grid = 0;
  const cudaError_t e = wt::persistent_grid(kern, smem, a.n_pos, known, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, smem, st>>>(
      a.pairs, a.n_pos, a.p0, a.p0_span, a.packed, a.side, steps,
      a.n_pair_steps, a.cb, a.disp_miss, a.cnt, a.bits, a.shift, a.total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `desc`: host memory, n_pair_steps - 1 rows of the 11 words of
// ops/pair.py pair_descriptors; n_pos a multiple of kWarpTile; `pairs`
// 16-byte aligned, with kHalo words readable past n_pos.
extern "C" int pair_scan(const int* pairs, int n_pos, const int* p0,
                         int nb_p0, const int* packed, const int* side,
                         const unsigned* desc, int n_pair_steps, int cb,
                         int disp_miss, int dead_exit, int emit_bitmap,
                         int* cnt, int* bits, int shift, long long* total,
                         void* stream) {
  if (n_pair_steps < 1 || n_pair_steps > kMaxSteps || n_pos < 0 ||
      n_pos % kWarpTile || cb < 1 || 2 * cb + 1 > 31 ||
      reinterpret_cast<uintptr_t>(pairs) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos == 0) return 0;
  Steps steps;
  std::memset(&steps, 0, sizeof(steps));
  if (n_pair_steps > 1)
    std::memcpy(steps.s, desc, sizeof(Step) * (n_pair_steps - 1));
  Launch a{};
  a.pairs = pairs;
  a.n_pos = n_pos;
  a.p0 = p0;
  a.p0_span = static_cast<unsigned>(nb_p0) * 128u;
  a.packed = packed;
  a.side = side;
  a.n_pair_steps = n_pair_steps;
  a.cb = cb;
  a.disp_miss = static_cast<unsigned>(disp_miss);
  a.cnt = cnt;
  a.bits = bits;
  a.shift = shift;
  a.total = reinterpret_cast<unsigned long long*>(total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d = dead_exit != 0;
  if (emit_bitmap) {
    if (d) return launch_one<true, true>(a, steps, st);
    return launch_one<true, false>(a, steps, st);
  }
  if (d) return launch_one<false, true>(a, steps, st);
  return launch_one<false, false>(a, steps, st);
}
