"""Banked-PHF scan: the PFAC walk over the FFDM perfect-hash tables.

Replaces the Pallas TPU kernels ``phfpfac_tpu/ops/pallas_scan.py::
_make_kernel`` (one shard, ``phf_scan``) and ``::_make_multi_kernel``
(every shard in one launch, ``phf_scan_multi``) — the direct
counterpart of the reference's ``TraceTable_kernel``
(master_kernel.cu:92-180).  One walker per byte offset over the raw
uint8 corpus:

* step 0: ``state = s0[byte]`` for positions below ``input_size``, else
  the DEAD sentinel;
* step t: ``state = DEAD`` unless ``pos + t < lim``; then
  ``key = (state << 8) + byte[pos + t]``, ``row = key >> width_bit``,
  ``idx = r[row] + (key & (width - 1))``, ``g = packed[idx]``; the probe
  hits iff ``(g & row_mask) == row`` and chains ``state = g >> row_bits``,
  else DEAD;
* a state below ``num_final`` is a match: bit t of the position's bitmap;
* ``lim = min(input_size, seg_end + halo)`` under the segment cut, else
  ``input_size``.

Tables are stored as [nb, 128] banks and read flat: an index outside a
table's banks yields -1, so the DEAD state's sentinel rows of ``r``
(-2^30) and empty rows miss on their own and DEAD is absorbing.

Output contract as ops.plan: (cnt, bits) int32 per position, or in
count mode the int64 total over positions ``>= shift``.  The multi scan
sums ``cnt`` over shards and returns one bitmap row per shard.

``phf_scan`` / ``phf_scan_multi`` are the kernel wrappers: a CUDA
tensor launches ``csrc/phf_scan.cu`` (warp tiles over the raw bytes; K4
is its one-shard instance), a CPU tensor runs the plain versions, the
same walk in int32 torch ops.  The kernel reads each shard's tables as
pre-decoded descriptors (``phf_descriptors``), built once with the
tables.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from phfpfac_tpu_torch.compile.tables import ShardTables
from phfpfac_tpu_torch.ops.plan import CountScan, ShardScanner, check_operand
from phfpfac_tpu_torch.ops.staging import LANE, TILE, to_device_bytes
from phfpfac_tpu_torch.ops.turbo import TurboTables, build_turbo_tables

MAX_BITMAP_STEPS = 32
MAX_COUNT_STEPS = LANE  # the count scanners' step limit
MAX_SHARDS = 64  # shard descriptors one launch takes by value
SENTINEL_R = -(2**30)
# one shard's geometry, as the plain versions read it
SPEC_FIELDS = ("s0_off", "nb_s0", "r_off", "nb_r", "p_off", "nb_p",
               "width_bit", "row_bits", "dead", "num_final")
# one shard's ready operands, as the tile kernel reads them (struct Desc
# in csrc/phf_scan.cu)
PHF_DESC_FIELDS = ("s0_base", "s0_span", "r_base", "r_span", "p_base",
                   "p_span", "wb", "rb", "wm1", "row_mask", "dead",
                   "num_final")

launches = 0  # phf_scan CUDA launches (the CPU plain path never counts)
launches_multi = 0  # phf_scan_multi CUDA launches


class PhfUnsupported(ValueError):
    """The banked-PHF kernels refuse this shard or step count; callers
    route it to the next engine."""


def _to_banks(arr: np.ndarray, fill: int) -> np.ndarray:
    nb = max(1, -(-len(arr) // LANE))
    out = np.full((nb, LANE), fill, dtype=np.int32)
    out.ravel()[: len(arr)] = arr
    return out


class PallasTables:
    """Bank-layout tables for the banked-PHF kernels (one shard).

    Unlike the turbo engine's tables, the banked lookup needs no guard
    bands: an index outside [0, nb*128) selects no bank and yields the
    -1 miss sentinel, so sentinel/negative displacements miss naturally
    and every bank is real table payload.
    """

    def __init__(self, shard: ShardTables, tt: TurboTables | None = None):
        tt = tt or build_turbo_tables(shard)
        if not tt.is_packed:
            raise PhfUnsupported("pallas kernel requires packed tables")
        self.s0 = _to_banks(tt.s0, tt.dead)
        # unbiased r with sentinel rows for the DEAD state; sentinel and
        # empty-row displacements produce out-of-range probe indices,
        # which the banked lookup resolves to a miss
        n_sent = len(tt.r) - len(shard.r)
        r_raw = np.concatenate(
            [shard.r, np.full(n_sent, SENTINEL_R, dtype=np.int32)]
        )
        self.r = _to_banks(r_raw, SENTINEL_R)
        packed_raw = np.where(
            shard.ht >= 0,
            (shard.val.astype(np.int64) << tt.row_bits)
            | shard.ht.astype(np.int64),
            -1,
        ).astype(np.int32)
        self.packed = _to_banks(packed_raw, -1)
        self.width_bit = tt.width_bit
        self.row_bits = tt.row_bits
        self.dead = int(tt.dead)
        self.num_final = tt.num_final
        self.max_pat_len = tt.max_pat_len

    @property
    def n_banks(self) -> int:
        return self.packed.shape[0]


def recommended_shards(num_patterns: int, target_states: int = 900) -> int:
    """Shard count keeping each automaton's bank budget small.

    Interior states ~= patterns * (avg unique suffix), conservatively
    ~2.2x patterns for english-like dictionaries.
    """
    est_states = max(int(num_patterns * 2.2), 1)
    return max(1, math.ceil(est_states / target_states))


@dataclass
class PhfKernelTables:
    """One or more shards' banked tables, concatenated, as tensors on
    the scan device."""

    s0: torch.Tensor  # int32 [sum nb_s0, 128]
    r: torch.Tensor  # int32 [sum nb_r, 128]
    packed: torch.Tensor  # int32 [sum nb_p, 128]
    spec_rows: tuple  # per shard, the SPEC_FIELDS row (host)
    desc: np.ndarray  # host uint32 [n_shards, 12]: phf_descriptors
    # the DEAD state's 256 keys all read sentinel rows of r in every
    # shard, so a dead walker may stop: checked here, never assumed
    dead_exit: bool
    # every state a walker of any shard can hold fits in 24 bits, so a
    # live walker is one word (state << 8) | offset: checked here too
    one_word: bool

    @property
    def n_shards(self) -> int:
        return len(self.spec_rows)

    @classmethod
    def from_tables(cls, pts: list, device) -> "PhfKernelTables":
        rows, offs, dead_exit = [], [0, 0, 0], True
        for pt in pts:
            nbs = (pt.s0.shape[0], pt.r.shape[0], pt.packed.shape[0])
            rows.append((offs[0], nbs[0], offs[1], nbs[1], offs[2], nbs[2],
                         pt.width_bit, pt.row_bits, pt.dead, pt.num_final))
            offs = [o + n for o, n in zip(offs, nbs)]
            keys = (pt.dead << 8) + np.arange(256, dtype=np.int64)
            dead_rows = keys >> pt.width_bit
            r_flat = pt.r.ravel()
            # a sentinel row sends the probe of packed outside its banks
            # (-1), which a row equal to row_mask would take for a hit;
            # and a stopped walker must not be a match
            dead_exit &= bool(
                dead_rows.max() < len(r_flat)
                and (r_flat[dead_rows] == SENTINEL_R).all()
                and (pt.dead << 8) + 255 < 2**31
                and dead_rows.max() < (1 << pt.row_bits) - 1
                and pt.dead >= pt.num_final
            )

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        return cls(
            s0=dev(np.concatenate([pt.s0 for pt in pts])),
            r=dev(np.concatenate([pt.r for pt in pts])),
            packed=dev(np.concatenate([pt.packed for pt in pts])),
            spec_rows=tuple(rows), desc=phf_descriptors(rows),
            dead_exit=dead_exit,
            one_word=all(states_fit_24(pt) for pt in pts),
        )


def phf_descriptors(rows) -> np.ndarray:
    """The shards' SPEC_FIELDS rows as the tile kernel's ready operands:
    uint32 [len(rows), len(PHF_DESC_FIELDS)].

    A probe of a table at ``idx`` becomes ``idx < span ? banks[base +
    idx] : -1`` in unsigned arithmetic, with ``base = off * 128`` and
    ``span = nb * 128``: the value of ``_lut(banks, idx, off, nb)``.
    ``wm1`` and ``row_mask`` are ``(1 << width_bit) - 1`` and
    ``(1 << row_bits) - 1``."""
    out = [(s0_off * LANE, nb_s0 * LANE, r_off * LANE, nb_r * LANE,
            p_off * LANE, nb_p * LANE, wb, rb, (1 << wb) - 1, (1 << rb) - 1,
            dead, nf)
           for s0_off, nb_s0, r_off, nb_r, p_off, nb_p, wb, rb, dead, nf
           in rows]
    arr = np.asarray(out, np.int64).reshape(-1, len(PHF_DESC_FIELDS))
    arr = np.ascontiguousarray((arr & 0xFFFFFFFF).astype(np.uint32))
    arr.setflags(write=False)  # shared by every launch over these tables
    return arr


def states_fit_24(pt: "PallasTables") -> bool:
    """Whether every state a walker over ``pt`` can hold is below 2^24:
    an s0 entry (a byte past s0's banks reads -1), DEAD, or ``g >>
    row_bits`` of a packed entry or of the -1 a probe outside the banks
    reads."""
    u32 = np.uint32
    states = [pt.dead, 0xFFFFFFFF >> pt.row_bits,
              int(pt.packed.view(u32).max()) >> pt.row_bits,
              int(pt.s0.view(u32).max())]
    if pt.s0.size < 256:
        states.append(0xFFFFFFFF)
    return max(states) < 1 << 24


# ---- plain torch versions ----------------------------------------------------

def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 values (torch's ``>>`` is arithmetic)."""
    return (x >> n) & ((1 << (32 - n)) - 1) if n else x


def _lut(banks: torch.Tensor, idx: torch.Tensor, off: int,
         nb: int) -> torch.Tensor:
    """banks[off:off+nb].ravel()[idx], or -1 where idx lies outside
    [0, nb*128).  int32 in and out."""
    bank = idx >> 7  # arithmetic: negative indices miss
    ok = (bank >= 0) & (bank < nb)
    j = torch.where(ok, off * LANE + idx, 0)
    return torch.where(ok, torch.index_select(banks.reshape(-1), 0, j), -1)


def _limits(n_pos, input_size, max_steps, seg_bytes, halo_bytes, device):
    pos = torch.arange(n_pos, dtype=torch.int32, device=device)
    if seg_bytes > 0:
        lim = torch.clamp((pos // seg_bytes + 1) * seg_bytes + halo_bytes,
                          max=input_size)
    else:
        lim = torch.clamp(pos + max_steps, max=input_size)
    return pos, lim


def _walk(chars, pos, lim, input_size, t: PhfKernelTables, spec, max_steps,
          bitmap):
    (s0_off, nb_s0, r_off, nb_r, p_off, nb_p, wb, rb, dead, nf) = spec
    n_pos = pos.shape[0]
    state = torch.where(pos < input_size,
                        _lut(t.s0, chars[:n_pos], s0_off, nb_s0), dead)
    fin = state < nf
    cnt = fin.to(torch.int32)
    bits = fin.to(torch.int32)  # bit 0
    for s in range(1, max_steps):
        state = torch.where(pos + s < lim, state, dead)
        key = (state << 8) + chars[s:s + n_pos]
        row = _srl(key, wb)
        idx = _lut(t.r, row, r_off, nb_r) + (key & ((1 << wb) - 1))
        g = _lut(t.packed, idx, p_off, nb_p)
        hit = (g & ((1 << rb) - 1)) == row
        state = torch.where(hit, _srl(g, rb), dead)
        fin = state < nf
        cnt = cnt + fin
        if bitmap:
            bits = bits | (fin.to(torch.int32) << min(s, 31))
    return cnt, bits


def _total(cnt: torch.Tensor, shift) -> torch.Tensor:
    pos = torch.arange(cnt.shape[0], dtype=torch.int64, device=cnt.device)
    return torch.where(pos >= int(shift), cnt.to(torch.int64), 0).sum(
        ).reshape(1)


def phf_scan_multi_plain(data: torch.Tensor, t: PhfKernelTables, *,
                         input_size: int, max_steps: int,
                         emit: str = "bitmap", seg_bytes: int = 0,
                         halo_bytes: int = 0, shift=0):
    """Every shard's walk, every step for every position, no early
    exit.  Bitmap mode: (cnt summed over shards [n_pos], bits
    [n_shards, n_pos])."""
    n_pos = data.shape[0] - max_steps
    chars = data.to(torch.int32)
    pos, lim = _limits(n_pos, input_size, max_steps, seg_bytes, halo_bytes,
                       data.device)
    bitmap = emit == "bitmap"
    cnt = torch.zeros(n_pos, dtype=torch.int32, device=data.device)
    rows = []
    for spec in t.spec_rows:
        c, b = _walk(chars, pos, lim, input_size, t, spec, max_steps, bitmap)
        cnt += c
        rows.append(b)
    if not bitmap:
        return _total(cnt, shift)
    return cnt, torch.stack(rows)


def phf_scan_plain(data: torch.Tensor, t: PhfKernelTables, *,
                   input_size: int, max_steps: int, emit: str = "bitmap",
                   seg_bytes: int = 0, halo_bytes: int = 0, shift=0):
    """One shard's walk, every step for every position, no early exit."""
    out = phf_scan_multi_plain(
        data, t, input_size=input_size, max_steps=max_steps, emit=emit,
        seg_bytes=seg_bytes, halo_bytes=halo_bytes, shift=shift)
    if emit != "bitmap":
        return out
    return out[0], out[1][0]


# ---- CUDA kernels ------------------------------------------------------------

def _lib():
    from phfpfac_tpu_torch import _build

    lib = _build.load("phf_scan")
    if lib.phf_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # data, n_pos, input_size, max_steps, s0, r, packed, desc,
        # n_shards, dead_exit, one_word, seg, halo, emit_bitmap, cnt, bits,
        # shift, total, stream
        lib.phf_scan.argtypes = [p, i, i, i, p, p, p, p, i, i, i, i, i, i,
                                 p, p, i, p, p]
        lib.phf_scan.restype = i
    return lib


def _check(data, t, input_size, max_steps, emit, multi):
    if emit not in ("bitmap", "count"):
        raise ValueError(f"emit must be 'bitmap' or 'count', got {emit!r}")
    limit = MAX_BITMAP_STEPS if emit == "bitmap" else MAX_COUNT_STEPS
    if not 1 <= max_steps <= limit:
        raise ValueError(
            f"the banked-PHF {emit} scan supports 1..{limit} steps, got "
            f"{max_steps}")
    if data.dtype != torch.uint8 or data.dim() != 1 or \
            not data.is_contiguous():
        raise ValueError("data: need a contiguous 1-D uint8 tensor")
    n_pos = data.shape[0] - max_steps
    if n_pos <= 0 or n_pos % TILE:
        raise ValueError(
            f"data: need n_pos + max_steps bytes with n_pos a positive "
            f"multiple of {TILE}, got {data.shape[0]}")
    if not 0 <= input_size <= n_pos:
        raise ValueError(f"input_size {input_size} outside [0, {n_pos}]")
    if not multi and t.n_shards != 1:
        raise ValueError(f"phf_scan takes one shard's tables, got "
                         f"{t.n_shards}")
    if t.n_shards > MAX_SHARDS:
        raise ValueError(f"at most {MAX_SHARDS} shards per launch, got "
                         f"{t.n_shards}")
    return n_pos


def _scan_cuda(data, t, *, multi, input_size, max_steps, emit, seg_bytes,
               halo_bytes, shift):
    global launches, launches_multi
    dev = data.device
    for name in ("s0", "r", "packed"):
        check_operand(getattr(t, name), dev, name)
    if t.desc.shape != (t.n_shards, len(PHF_DESC_FIELDS)):
        raise ValueError(f"desc: need {t.n_shards} shard rows, got "
                         f"{t.desc.shape}")
    n_pos = data.shape[0] - max_steps
    bitmap = emit == "bitmap"
    if bitmap:
        cnt = torch.empty(n_pos, dtype=torch.int32, device=dev)
        bits = torch.empty((t.n_shards, n_pos) if multi else (n_pos,),
                           dtype=torch.int32, device=dev)
        total = None
    else:
        cnt = bits = None
        total = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().phf_scan(
        data.data_ptr(), n_pos, int(input_size), max_steps,
        t.s0.data_ptr(), t.r.data_ptr(), t.packed.data_ptr(),
        t.desc.ctypes.data, t.n_shards, int(t.dead_exit), int(t.one_word),
        seg_bytes, halo_bytes, int(bitmap),
        None if cnt is None else cnt.data_ptr(),
        None if bits is None else bits.data_ptr(), int(shift),
        None if total is None else total.data_ptr(), stream)
    if err:
        name = "phf_scan_multi" if multi else "phf_scan"
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if multi:
        launches_multi += 1
    else:
        launches += 1
    return (cnt, bits) if bitmap else total


def _scan(data, t, multi, *, input_size, max_steps, emit, seg_bytes,
          halo_bytes, shift):
    _check(data, t, input_size, max_steps, emit, multi)
    kw = dict(input_size=input_size, max_steps=max_steps, emit=emit,
              seg_bytes=seg_bytes, halo_bytes=halo_bytes, shift=shift)
    if data.device.type == "cpu":
        plain = phf_scan_multi_plain if multi else phf_scan_plain
        return plain(data, t, **kw)
    if data.device.type != "cuda":
        raise ValueError(f"no banked-PHF kernel for device {data.device}")
    return _scan_cuda(data, t, multi=multi, **kw)


def phf_scan(data: torch.Tensor, t: PhfKernelTables, *, input_size: int,
             max_steps: int, emit: str = "bitmap", seg_bytes: int = 0,
             halo_bytes: int = 0, shift=0):
    """One shard's banked-PHF walk over a padded uint8 corpus
    (``n_pos + max_steps`` bytes, ``n_pos % 1024 == 0``).

    ``emit="bitmap"`` -> (cnt, bits), int32 [n_pos] each (at most 32
    steps); ``emit="count"`` -> int64 [1] total over positions >= shift
    (at most 128 steps).  ``seg_bytes`` > 0 applies the reference's
    segment + halo cut, any positive segment size.
    """
    return _scan(data, t, False, input_size=input_size, max_steps=max_steps,
                 emit=emit, seg_bytes=seg_bytes, halo_bytes=halo_bytes,
                 shift=shift)


def phf_scan_multi(data: torch.Tensor, t: PhfKernelTables, *,
                   input_size: int, max_steps: int, emit: str = "bitmap",
                   seg_bytes: int = 0, halo_bytes: int = 0, shift=0):
    """Every shard's walk in one launch: bitmap mode gives (cnt summed
    over shards int32 [n_pos], bits int32 [n_shards, n_pos]); count mode
    the int64 [1] total over all shards and positions >= shift."""
    return _scan(data, t, True, input_size=input_size, max_steps=max_steps,
                 emit=emit, seg_bytes=seg_bytes, halo_bytes=halo_bytes,
                 shift=shift)


# ---- scanners ----------------------------------------------------------------

def _seg(cfg) -> int:
    return cfg.segment_bytes if cfg.truncation == "segment" else 0


class PallasShardScanner(ShardScanner):
    """Scans one shard with the banked-PHF kernel; counts + bitmaps."""

    def __init__(self, shard: ShardTables, *, device):
        self.pt = PallasTables(shard)
        self.shard = shard
        self.device = torch.device(device)
        self.tables = PhfKernelTables.from_tables([self.pt], self.device)

    def scan(self, data_padded, input_size, cfg, max_steps):
        if max_steps > MAX_BITMAP_STEPS:
            raise PhfUnsupported(
                f"pallas bitmap path supports max_pat_len <= "
                f"{MAX_BITMAP_STEPS}, got steps {max_steps}"
            )
        return phf_scan(
            to_device_bytes(data_padded, self.device), self.tables,
            input_size=input_size, max_steps=max_steps,
            seg_bytes=_seg(cfg), halo_bytes=cfg.halo_bytes)


class MultiShardScanner:
    """All shards in one launch of the multi-shard kernel.

    scan(data_padded, input_size, cfg, max_steps, emit_bitmap) ->
      (counts [n_pos] summed over shards,
       bitmaps [num_shards, n_pos] or None)
    """

    def __init__(self, shards: list, *, device):
        self.pts = [PallasTables(sh) for sh in shards]
        self.device = torch.device(device)
        self.tables = PhfKernelTables.from_tables(self.pts, self.device)

    def scan(self, data_padded, input_size, cfg, max_steps, *,
             emit_bitmap=True):
        # per-position counts come with the bitmaps, so a counts-only
        # call is bound by the bitmap depth too (totals at more steps:
        # multi_count_scanner)
        if max_steps > MAX_BITMAP_STEPS:
            raise PhfUnsupported(
                f"pallas bitmap path supports max_pat_len <= "
                f"{MAX_BITMAP_STEPS}, got steps {max_steps}"
            )
        cnt, bits = phf_scan_multi(
            to_device_bytes(data_padded, self.device), self.tables,
            input_size=input_size, max_steps=max_steps,
            seg_bytes=_seg(cfg), halo_bytes=cfg.halo_bytes)
        return cnt, (bits if emit_bitmap else None)


class PhfCountScan(CountScan):
    """Count-mode banked-PHF scan over a scanner's tables (one shard or
    all): the raw padded corpus is its staged form."""

    def __init__(self, scanner, kernel, max_steps, seg_bytes=0,
                 halo_bytes=0):
        super().__init__(max_steps)
        self.scanner, self.kernel = scanner, kernel
        self.seg_bytes, self.halo_bytes = seg_bytes, halo_bytes

    def prepare(self, data_padded, input_size):
        return to_device_bytes(data_padded, self.scanner.device)

    def scan(self, staged, input_size, shift):
        return self.kernel(staged, self.scanner.tables,
                           input_size=int(input_size),
                           max_steps=self.max_steps, emit="count",
                           seg_bytes=self.seg_bytes,
                           halo_bytes=self.halo_bytes, shift=shift)


def pallas_count_scanner(shard: ShardTables, max_steps: int, *, device):
    """Count-mode scan fn(data, input_size, shift) -> total (exact mode)."""
    if max_steps > MAX_COUNT_STEPS:
        # fail at construction so engine_select can fall back
        raise PhfUnsupported(f"pallas scan supports max_steps <= {LANE}")
    return PhfCountScan(PallasShardScanner(shard, device=device), phf_scan,
                        max_steps)


def multi_count_scanner(shards: list, max_steps: int, cfg, *, device):
    """Fused count-mode scan fn(data, input_size, shift) -> total."""
    return PhfCountScan(MultiShardScanner(shards, device=device),
                        phf_scan_multi, max_steps, _seg(cfg),
                        cfg.halo_bytes)
