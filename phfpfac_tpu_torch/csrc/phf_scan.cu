// Banked-PHF scan (K4 one shard, K5 every shard in one launch): the PFAC
// walk over the FFDM perfect-hash tables, the counterpart of the
// reference's TraceTable_kernel (master_kernel.cu:92-180).
//
// Replaces the Pallas TPU kernels phfpfac_tpu/ops/pallas_scan.py::
// _make_kernel (reached through _pallas_scan) and ::_make_multi_kernel
// (through _pallas_scan_multi).  The plain torch versions of the same
// walks are ops/scan.py::phf_scan_plain and ::phf_scan_multi_plain; K4 is
// this kernel with one shard.
//
// Per byte offset pos and shard, step 0 is state = s0[byte] (DEAD at or
// past input_size); step t first kills the walker unless pos + t < lim,
// then probes
//     key = (state << 8) + byte[pos + t];  row = key >> width_bit;
//     idx = r[row] + (key & (width - 1));  g = packed[idx];
// hits iff (g & row_mask) == row and chains state = g >> row_bits, else
// DEAD.  A state below num_final sets bit t (bitmap mode, at most 32
// steps) or counts once (count mode, at most 128 steps).  Tables are
// [nb, 128] banks read flat; an index outside a table yields -1, which is
// how the DEAD state's sentinel rows of r (-2^30) and empty rows miss.
// When the host has checked that every key of DEAD reads a sentinel row
// (dead_exit), a dead walker stops.  lim = min(input_size, seg_end + halo)
// for any positive segment, else input_size.
//
// What bounds it on an H100: bytes, then the gathers of the first step.
// 1 B of corpus is read per position, and per position 4 B of cnt plus 4 B
// of bitmap per shard are written (K5 with 4 shards 21 B, K4 9 B a launch;
// nothing per position in count mode).  The walks are short: on clamav5k
// each shard's s0 is live for about a quarter of the bytes (the shards
// split the first bytes), 2% of the positions outlive step 1 and 0.04%
// step 2.  So the per-position skeleton (the byte read, the s0 probe, the
// stores) sets most of the time, then step 1's gathers into the packed
// table (170 KB a shard: they hit L1 only as far as shared memory leaves
// it room), then the deep walks of real matches.  The first port ran one
// walker a thread in blocks of 256 positions, each block copying the shard
// specs to shared memory behind a barrier, K5 walking the shards one after
// another in one thread with a re-read of the corpus a step and a 4-byte
// store a shard.  This design (the skeleton of warp_tile.cuh, as K2's in
// depth_scan.cu):
//
// * Warp tiles over the raw bytes: a warp walks kWarpTile = 256 positions
//   at a time with shared memory of its own; persistent blocks own block
//   tiles grid-stride, and the block's warps take its warp tiles from a
//   counter in shared memory, so that a warp held by a deep walk takes
//   fewer tiles (one barrier at the start, none after it).
// * The tile's bytes are staged once and walked for every shard: the
//   tile's 256 B and a halo past them (kShortHalo = 32 B up to 32 steps,
//   kHalo = 128 B up to 128) arrive in 16-byte cp.async copies, in a
//   two-stage ring while the previous tile walks.  The corpus has no spare
//   tile and a window may start at any byte (a view of a staged corpus),
//   so the copy starts at the 16-byte boundary at or below the tile
//   (kLead bytes of room before it), a chunk that crosses the tensor's end
//   copies only the bytes inside it (cp.async's src-size, the rest zero),
//   and the one chunk that starts before the tensor is read byte by byte.
//   No byte outside the tensor is read.
// * Shards inside the tile: for each shard, a prologue runs s0 for every
//   position in registers, 8 a lane; the walkers it leaves live go to the
//   warp's list (step 1 is not run in the prologue, as K2 runs it: with
//   s0 live for a quarter of the positions, three lanes of four would
//   idle); the steps run one a round over the list, compacted in place,
//   while it fills more than a row of 32 (every walker of a round has the
//   same shard and step, so the table operands are warp-uniform); then
//   each lane walks its entry on, to step kNear = 3.  The shard's fin bits
//   leave as 16-byte stores to bits[s * n_pos + start]; cnt sums their
//   popcounts in registers (two 16-bit counts a word, each lane the
//   positions it stores) and is stored once after the last shard.
// * Deep walks apart from the tile: a walker still live at step kNear (a
//   real match, 0.04% of the positions) would hold its warp for up to 31
//   dependent steps while its other tiles wait.  It goes to the warp's
//   deep list instead (where the list has room, else it walks on), and
//   the list is walked a lane a walker, reading the bytes from the tensor,
//   once it holds more than half a row after a tile, and at the end.  Its
//   later matches merge into the outputs the tile has stored: atomicOr
//   into the shard's bits row and atomicAdd to cnt (count mode: the sum).
// * Shared memory is kept small (3,232 B a warp in bitmap mode with
//   one-word entries, no cnt array), so that 5 blocks fit the SM's 132 KB
//   shared-memory carveout and leave up to 124 KB of L1 to the tables: on
//   clamav5k that took step 1 from 0.12 to 0.05 ms a chunk.
// * List entries: (state << 8) | offset in one word where the host has
//   proved that every state a walker of any shard can hold fits in 24
//   bits (ops/scan.py PhfKernelTables.one_word), else the state and a
//   byte of offset.
// * Without dead_exit a dead walker walks on, and the list would be the
//   whole tile at every step: each lane then walks its 8 positions through
//   every step in registers, 8 independent chains a lane.
// * The segment cut: a tile whose positions all have max_steps bytes of
//   room before the cut and input_size (under a halo of max_steps - 1 or
//   more, nearly every tile) walks as exact mode.  Elsewhere each
//   position's room is worked out once a tile, from its offset in its
//   segment (one division a tile, then one conditional subtract a row for
//   a segment of 256 B or more), into a byte per position.
// * Pre-decoded shards: each shard's tables come as base = off * 128 and
//   span = nb * 128 for s0, r and packed, with width_bit, row_bits, the
//   two masks, DEAD and num_final (ops/scan.py::phf_descriptors, built
//   once with the tables), by value as a kernel parameter; a probe is one
//   unsigned compare and one load.
// * Count mode: per-thread sums in registers across tiles and shards, one
//   block reduction and one atomic per block per launch.

#include <cstring>

#include "warp_tile.cuh"

namespace {

using wt::kPer;
using wt::kThreads;
using wt::kTile;
using wt::kWarps;
using wt::kWarpTile;

constexpr int kMaxShards = 64;       // ops/scan.py MAX_SHARDS
constexpr int kMaxBitmapSteps = 32;  // ops/scan.py MAX_BITMAP_STEPS
constexpr int kMaxSteps = 128;       // ops/scan.py MAX_COUNT_STEPS
constexpr int kHalo = 128;           // bytes read past a tile, <= 128 steps
constexpr int kShortHalo = 32;       // the same, <= 32 steps
constexpr int kLead = 16;            // room before the tile: the copy's
                                     // 16-byte boundary at or below it
// bytes of one stage: count mode (up to 128 steps), bitmap mode (up to 32)
constexpr int kStage = kLead + kWarpTile + kHalo;
constexpr int kShortStage = kLead + kWarpTile + kShortHalo;
constexpr int kDescWords = 12;       // ops/scan.py PHF_DESC_FIELDS
constexpr int kNear = 3;   // steps a tile walks its walkers to, at least
constexpr int kDeep = 32;  // walkers a warp defers past kNear (a row)

static_assert(kMaxShards * kMaxBitmapSteps < 65536,
              "a position's cnt over the shards fits 16 bits");

static_assert(kHalo >= kMaxSteps - 1 && kShortHalo >= kMaxBitmapSteps - 1,
              "step t reads pos + t inside the tile's copy");
static_assert(kStage % 16 == 0 && kShortStage % 16 == 0,
              "a stage is whole 16-byte copies");
static_assert((kWarpTile + kHalo) / 16 + 1 <= 32,
              "one copy a lane covers a stage");

// One shard's ready operands (ops/scan.py PHF_DESC_FIELDS).
struct Desc {
  unsigned s0_base, s0_span, r_base, r_span, p_base, p_span;
  unsigned wb, rb, wm1, row_mask, dead;
  int num_final;
};
static_assert(sizeof(Desc) == kDescWords * 4, "Desc is 12 packed words");

struct Descs {
  Desc d[kMaxShards];
};

// Two-word list entries keep the offset apart; one-word entries need no
// room for it.
template <bool kWide>
struct Offsets {
  unsigned char off[kWarpTile];
};
template <>
struct Offsets<false> {};

// A warp's own shared memory: nothing in it is read by another warp.
template <bool kBitmap, bool kWide>
struct __align__(16) WarpSmem : Offsets<kWide> {
  // this tile's bytes, the next's
  unsigned char stream[2][kBitmap ? kShortStage : kStage];
  unsigned out[kBitmap ? kWarpTile : 1];  // a shard's fin bits (bitmap)
  unsigned list[kWarpTile];         // live walkers (see put / get)
  // walkers deferred at step kNear (walk_deep): state, position in the
  // window, shard | room before the cut << 8 (255: no cut)
  unsigned deep_st[kDeep];
  unsigned deep_pos[kDeep];
  unsigned short deep_sr[kDeep];
  unsigned char lim[kWarpTile];     // room before the cut
};

template <bool kBitmap, bool kWide>
struct Smem {
  WarpSmem<kBitmap, kWide> w[kWarps];
  unsigned long long warp_sums[kWarps];
  int next;  // the block's next untaken warp tile
};

static_assert(wt::kMinBlocks * (sizeof(Smem<true, false>) + 1024) <=
                  132 * 1024,
              "bitmap mode's blocks fit a 132 KB carveout (1 KB a block "
              "reserved) with one-word list entries");

// What every tile of a launch reads.
struct Walk {
  const unsigned char* __restrict__ data;
  const int* __restrict__ s0;
  const int* __restrict__ r;
  const int* __restrict__ packed;
  int n_pos, input_size, max_steps, n_shards, seg, halo;
  int mis;    // data's byte offset from its 16-byte boundary
  int* __restrict__ cnt;
  int* __restrict__ bits;
  int sh;     // count mode: positions below it do not count
};

__device__ __forceinline__ void cp_async16_zfill(void* smem,
                                                 const void* gmem,
                                                 int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// Starts the copy of data[start - mis, start - mis + 16 * chunks) into
// dst, one 16-byte chunk a lane, reading no byte outside [0, n_bytes).
// Every lane of the warp calls it.
__device__ __forceinline__ void load_bytes(unsigned char* dst,
                                           const unsigned char* data,
                                           long long start, int mis,
                                           int chunks, long long n_bytes,
                                           int lane) {
  if (lane >= chunks) return;
  const long long g = start - mis + 16 * lane;  // a 16-byte boundary
  unsigned char* d = dst + 16 * lane;
  if (g >= 0) {
    const long long left = n_bytes - g;
    if (left >= 16)
      wt::cp_async16(d, data + g);
    else if (left > 0)
      cp_async16_zfill(d, data + g, static_cast<int>(left));
  } else {  // the tensor's first chunk, which starts before it
    for (long long j = -g; j < 16 && g + j < n_bytes; ++j) d[j] = data[g + j];
  }
}

// Step t of a walker, `c` its byte pos + t, with `room` bytes before the
// cut.
// -> whether it walks on; `fin` whether its new state is a match.
template <bool kCut, bool kDead>
__device__ __forceinline__ bool step(const Walk& w, const Desc& d, int t,
                                     unsigned c, int room, unsigned& st,
                                     bool& fin) {
  if (kCut && !(t < room)) {  // the cut: it reads no further
    if (kDead) {
      fin = false;
      return false;
    }
    st = d.dead;
  }
  const unsigned key = (st << 8) + c;
  const unsigned row = key >> d.wb;
  const unsigned rv = wt::probe(w.r, d.r_base, 0, d.r_span, row);
  const unsigned g =
      wt::probe(w.packed, d.p_base, 0, d.p_span, rv + (key & d.wm1));
  st = (g & d.row_mask) == row ? g >> d.rb : d.dead;
  fin = static_cast<int>(st) < d.num_final;
  return !kDead || st != d.dead;
}

template <bool kWide, typename Ws>
__device__ __forceinline__ void put(Ws& ws, int i, unsigned st,
                                    int p) {
  if constexpr (kWide) {
    ws.list[i] = st;
    ws.off[i] = static_cast<unsigned char>(p);
  } else {
    ws.list[i] = (st << 8) | static_cast<unsigned>(p);
  }
}

template <bool kWide, typename Ws>
__device__ __forceinline__ void get(const Ws& ws, int i, unsigned& st,
                                    int& p) {
  const unsigned e = ws.list[i];
  if constexpr (kWide) {
    st = e;
    p = ws.off[i];
  } else {
    st = e >> 8;
    p = static_cast<int>(e & 255u);
  }
}

// One shard's walk over the warp tile at `start`, its bytes at ts[0, ...):
// bitmap mode leaves each position's fin bits in ws.out, count mode adds
// the matches of positions >= w.sh to `sum`.  Every lane calls it.
template <bool kBitmap, bool kCut, bool kDead, bool kWide>
__device__ __forceinline__ void walk_shard(const Walk& w, const Desc& d,
                                           int s, const unsigned char* ts,
                                           WarpSmem<kBitmap, kWide>& ws,
                                           long long start, int lane,
                                           int& nd,
                                           unsigned long long& sum) {
  // ---- prologue: s0 for every position of the tile, in registers ----
  unsigned o[kPer], st[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = j * 32 + lane;
    st[j] = d.dead;
    if (!kCut || ws.lim[p] > 0)  // room > 0: pos < input_size
      st[j] = wt::probe(w.s0, d.s0_base, 0, d.s0_span, ts[p]);
    const bool fin = static_cast<int>(st[j]) < d.num_final;
    o[j] = fin ? 1u : 0u;
    if (!kBitmap && fin) sum += start + p >= w.sh;
  }

  if (!kDead) {
    // a dead walker walks on: the list would be the whole tile at every
    // step, so each lane walks its kPer positions through every step
    for (int t = 1; t < w.max_steps; ++t) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int p = j * 32 + lane;
        bool fin;
        step<kCut, false>(w, d, t, ts[p + t], kCut ? ws.lim[p] : 0, st[j],
                          fin);
        if (fin) {
          if (kBitmap)
            o[j] |= 1u << t;
          else
            sum += start + p >= w.sh;
        }
      }
    }
    if (kBitmap) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) ws.out[j * 32 + lane] = o[j];
    }
    return;
  }

  // ---- the walkers s0 left live to the warp's list, a ballot per row of
  // 32 (s0 is live for about a quarter of the positions of each of
  // clamav5k's shards: step 1 over the list keeps the lanes full) ----
  int n = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = j * 32 + lane;
    if (kBitmap) ws.out[p] = o[j];
    const bool live = st[j] != d.dead && w.max_steps > 1;
    const int i = wt::ballot_slot(live, n);
    if (live) put<kWide>(ws, i, st[j], p);
  }
  __syncwarp();

  // ---- the steps over the packed list, one step a round, while the list
  // fills more than one warp row; compacted in place ----
  int t = 1;
  for (; n > 32 && t < w.max_steps; ++t) {
    int kept = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      unsigned x = 0;
      int p = 0;
      if (i < n) get<kWide>(ws, i, x, p);
      __syncwarp();  // this row read before any lane overwrites it
      bool live = false;
      if (i < n) {
        bool fin;
        live = step<kCut, true>(w, d, t, ts[p + t], kCut ? ws.lim[p] : 0,
                                x, fin);
        if (fin) {
          if (kBitmap)
            ws.out[p] |= 1u << t;
          else
            sum += start + p >= w.sh;
        }
      }
      const int slot = wt::ballot_slot(live, kept);  // slot <= i
      if (live) put<kWide>(ws, slot, x, p);
    }
    __syncwarp();
    n = kept;
  }

  // ---- at most one row left: each lane walks its entry on, to step
  // kNear; the walkers still live there go to the warp's deep list
  // (walk_deep walks them a row at a time, after the tile) where it has
  // room, else on here ----
  bool live = n <= 32 && lane < n;  // n > 32 only when the steps ran out
  int p = 0;
  unsigned x = 0, bits = 0;
  if (live) get<kWide>(ws, lane, x, p);
  const int room = kCut && live ? ws.lim[p] : 0;
  const bool counted = start + p >= w.sh;
  auto walk_to = [&](int end) {
    for (; t < end && __any_sync(0xffffffffu, live); ++t) {
      if (live) {
        bool fin;
        live = step<kCut, true>(w, d, t, ts[p + t], room, x, fin);
        if (fin) {
          if (kBitmap)
            bits |= 1u << t;
          else
            sum += counted;
        }
      }
    }
  };
  walk_to(w.max_steps < kNear ? w.max_steps : kNear);
  if (t == kNear && t < w.max_steps) {
    const unsigned dm = __ballot_sync(0xffffffffu, live);
    if (dm && nd + __popc(dm) <= kDeep) {
      if (live) {
        const int i = nd + __popc(dm & ((1u << lane) - 1u));
        ws.deep_st[i] = x;
        ws.deep_pos[i] = static_cast<unsigned>(start + p);
        ws.deep_sr[i] = static_cast<unsigned short>(s | (kCut ? room : 255)
                                                             << 8);
      }
      nd += __popc(dm);
      live = false;
    }
  }
  walk_to(w.max_steps);
  if (kBitmap && bits) ws.out[p] |= bits;
}

// The warp's deferred walkers, ws.deep_*[0, nd), one a lane, walked on
// from step kNear to the end: the bytes from the tensor, each match merged
// into the outputs their tiles have stored (atomicOr into the shard's bits
// row and atomicAdd to cnt; count mode: the sum).  Empties the list.
// Every lane calls it.
template <bool kBitmap, bool kWide>
__device__ __forceinline__ void walk_deep(const Walk& w, const Descs& descs,
                                          WarpSmem<kBitmap, kWide>& ws,
                                          int& nd, int lane,
                                          unsigned long long& sum) {
  bool live = lane < nd;
  unsigned x = 0, pos = 0, sr = 0;
  if (live) {
    x = ws.deep_st[lane];
    pos = ws.deep_pos[lane];
    sr = ws.deep_sr[lane];
  }
  __syncwarp();
  nd = 0;
  const int s = static_cast<int>(sr & 255u), room = static_cast<int>(sr >> 8);
  const Desc& d = descs.d[s];
  const bool counted = static_cast<long long>(pos) >= w.sh;
  for (int t = kNear; t < w.max_steps && __any_sync(0xffffffffu, live);
       ++t) {
    if (live) {
      bool fin;
      live = step<true, true>(w, d, t, __ldg(w.data + pos + t), room, x,
                              fin);
      if (fin) {
        if (kBitmap) {
          atomicOr(w.bits + static_cast<size_t>(s) * w.n_pos + pos,
                   static_cast<int>(1u << t));
          atomicAdd(w.cnt + pos, 1);
        } else {
          sum += counted;
        }
      }
    }
  }
}

// Every shard's walk over one warp tile at `start`, its bytes at ts[0,
// ...); kCut: the segment cut or input_size may stop a walk inside this
// tile.  Bitmap mode writes each shard's bits row and the tile's cnt,
// count mode adds to `sum`.  Every lane of the warp calls it.
template <bool kBitmap, bool kCut, bool kDead, bool kWide>
__device__ __forceinline__ void walk_tile(const Walk& w, const Descs& descs,
                                          const unsigned char* ts,
                                          WarpSmem<kBitmap, kWide>& ws,
                                          long long start, int lane, int& nd,
                                          unsigned long long& sum) {
  if (kCut) {
    // each position's room before min(input_size, seg_end + halo) (or
    // input_size alone in exact mode), at most max_steps, from its offset
    // in its segment: one division a tile, then 32 positions a row (a
    // segment of a warp tile or more holds at most one boundary in a
    // row's step)
    const unsigned useg = static_cast<unsigned>(w.seg > 0 ? w.seg : 1);
    const unsigned r0 = (static_cast<unsigned>(start) + lane) % useg;
    const bool wide = w.seg >= kWarpTile;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      long long room = w.max_steps;
      if (w.seg > 0) {
        unsigned r = r0 + 32u * j;
        r = wide ? (r >= useg ? r - useg : r) : r % useg;
        room = static_cast<long long>(w.seg) + w.halo - r;
      }
      const long long left = w.input_size - (start + j * 32 + lane);
      if (left < room) room = left;
      ws.lim[j * 32 + lane] = static_cast<unsigned char>(
          room < 0 ? 0 : (room > w.max_steps ? w.max_steps : room));
    }
    __syncwarp();
  }

  // per lane: cnt of positions 4q .. 4q + 3, q = lane + 32 i (the 16-byte
  // store mapping of out[]), summed over the shards as two 16-bit counts
  // a word
  constexpr int kQuads = kWarpTile / 4 / 32;
  unsigned c2[2 * kQuads];
#pragma unroll
  for (int i = 0; i < 2 * kQuads; ++i) c2[i] = 0;

  for (int s = 0; s < w.n_shards; ++s) {
    walk_shard<kBitmap, kCut, kDead, kWide>(w, descs.d[s], s, ts, ws,
                                            start, lane, nd, sum);
    if (kBitmap) {
      // this shard's bits row in 16-byte stores
      __syncwarp();
      const uint4* out4 = reinterpret_cast<const uint4*>(ws.out);
      uint4* row = reinterpret_cast<uint4*>(
          w.bits + static_cast<size_t>(s) * w.n_pos + start);
#pragma unroll
      for (int i = 0; i < kQuads; ++i) {
        const uint4 o = out4[lane + 32 * i];
        row[lane + 32 * i] = o;
        c2[2 * i] += __popc(o.x) | __popc(o.y) << 16;
        c2[2 * i + 1] += __popc(o.z) | __popc(o.w) << 16;
      }
    }
    __syncwarp();  // out[] and the list are the next shard's
  }
  if (kBitmap) {
    uint4* cnt4 = reinterpret_cast<uint4*>(w.cnt + start);
#pragma unroll
    for (int i = 0; i < kQuads; ++i)
      cnt4[lane + 32 * i] =
          make_uint4(c2[2 * i] & 0xffffu, c2[2 * i] >> 16,
                     c2[2 * i + 1] & 0xffffu, c2[2 * i + 1] >> 16);
  }
}

template <bool kBitmap, bool kDead, bool kWide>
__global__ void __launch_bounds__(kThreads, wt::kMinBlocks)
phf_scan_kernel(Walk w, const __grid_constant__ Descs descs,
                unsigned long long* __restrict__ total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<kBitmap, kWide>& sm =
      *reinterpret_cast<Smem<kBitmap, kWide>*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  WarpSmem<kBitmap, kWide>& ws = sm.w[wid];
  const int halo_b = w.max_steps > kMaxBitmapSteps ? kHalo : kShortHalo;
  const int chunks = (kWarpTile + halo_b) / 16 + 1;  // kLead covers mis
  const long long n_bytes = static_cast<long long>(w.n_pos) + w.max_steps;
  // the cut stops no walk of a tile whose positions all have max_steps
  // bytes before input_size, where a halo of max_steps - 1 or more leaves
  // every position that much room in its segment
  const bool halo_room = w.seg == 0 || w.halo >= w.max_steps - 1;
  unsigned long long sum = 0;
  int nd = 0;  // walkers in the warp's deep list

  // the block's warp tiles: the k-th is warp tile k % kWarps of the
  // block's (k / kWarps)-th block tile, grid-stride.  Warp wid walks tile
  // wid first, then takes the next untaken one: a warp held by a deep
  // walker takes fewer tiles.
  if (threadIdx.x == 0) sm.next = kWarps;
  __syncthreads();
  auto tile_start = [&](int k) {
    return (static_cast<long long>(k / kWarps) * gridDim.x + blockIdx.x) *
               kTile +
           static_cast<long long>(k % kWarps) * kWarpTile;
  };
  auto take = [&]() {
    int k = 0;
    if (lane == 0) k = atomicAdd(&sm.next, 1);
    return __shfl_sync(0xffffffffu, k, 0);
  };
  long long start = tile_start(wid);
  if (start < w.n_pos)
    load_bytes(ws.stream[0], w.data, start, w.mis, chunks, n_bytes, lane);
  wt::cp_async_commit();
  for (int k = 0; start < w.n_pos; ++k) {
    const long long next = tile_start(take());
    if (next < w.n_pos)
      load_bytes(ws.stream[(k + 1) & 1], w.data, next, w.mis, chunks,
                 n_bytes, lane);
    wt::cp_async_commit();
    wt::cp_async_wait<1>();
    __syncwarp();
    const unsigned char* ts = ws.stream[k & 1] + w.mis;
    if (halo_room && start + kWarpTile + w.max_steps - 1 <= w.input_size)
      walk_tile<kBitmap, false, kDead, kWide>(w, descs, ts, ws, start, lane,
                                              nd, sum);
    else
      walk_tile<kBitmap, true, kDead, kWide>(w, descs, ts, ws, start, lane,
                                             nd, sum);
    __syncwarp();  // this stream slot is reused; the tile's outputs stored
    if (nd > kDeep / 2) walk_deep(w, descs, ws, nd, lane, sum);
    start = next;
  }
  wt::cp_async_wait<0>();
  if (nd) walk_deep(w, descs, ws, nd, lane, sum);

  if (!kBitmap) wt::block_total(sum, sm.warp_sums, total);
}

template <bool B, bool D, bool W>
int launch_one(const Walk& w, const Descs& descs, unsigned long long* total,
               cudaStream_t st) {
  static int known[wt::kMaxDevices];  // resident blocks, per device
  auto kern = phf_scan_kernel<B, D, W>;
  const int smem = static_cast<int>(sizeof(Smem<B, W>));
  int grid = 0;
  const cudaError_t e = wt::persistent_grid(kern, smem, w.n_pos, known,
                                            &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, kThreads, smem, st>>>(w, descs, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `desc`: host memory, n_shards rows of the 12 words of ops/scan.py
// phf_descriptors; `data`: n_pos + max_steps bytes at any alignment;
// n_pos a multiple of kWarpTile.  `one_word`: every state fits in 24 bits
// (PhfKernelTables.one_word).  Bitmap mode writes cnt [n_pos] and bits
// [n_shards, n_pos]; count mode adds the total over positions >= shift to
// *total.
extern "C" int phf_scan(const uint8_t* data, int n_pos, int input_size,
                        int max_steps, const int* s0, const int* r,
                        const int* packed, const unsigned* desc,
                        int n_shards, int dead_exit, int one_word, int seg,
                        int halo, int emit_bitmap, int* cnt, int* bits,
                        int shift, long long* total, void* stream) {
  if (max_steps < 1 || max_steps > kMaxSteps ||
      (emit_bitmap && max_steps > kMaxBitmapSteps) || n_shards < 1 ||
      n_shards > kMaxShards || n_pos < 0 || n_pos % kWarpTile || seg < 0 ||
      halo < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pos == 0) return 0;
  Descs descs;
  std::memset(&descs, 0, sizeof(descs));
  std::memcpy(descs.d, desc, sizeof(Desc) * n_shards);
  Walk w{};
  w.data = data;
  w.s0 = s0;
  w.r = r;
  w.packed = packed;
  w.n_pos = n_pos;
  w.input_size = input_size;
  w.max_steps = max_steps;
  w.n_shards = n_shards;
  w.seg = seg;
  w.halo = halo;
  w.mis = static_cast<int>(reinterpret_cast<uintptr_t>(data) % 16);
  w.cnt = cnt;
  w.bits = bits;
  w.sh = emit_bitmap ? 0 : shift;
  auto* ut = reinterpret_cast<unsigned long long*>(total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d = dead_exit != 0, wide = one_word == 0;
#define PHF_LAUNCH(B, D, W) return launch_one<B, D, W>(w, descs, ut, st)
  if (emit_bitmap) {
    if (!d) PHF_LAUNCH(true, false, false);
    if (wide) PHF_LAUNCH(true, true, true);
    PHF_LAUNCH(true, true, false);
  }
  if (!d) PHF_LAUNCH(false, false, false);
  if (wide) PHF_LAUNCH(false, true, true);
  PHF_LAUNCH(false, true, false);
#undef PHF_LAUNCH
}
