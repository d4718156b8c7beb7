"""Pair scan: the stride-2 PFAC walk over compile.pair's tables.

Replaces the Pallas TPU kernel ``phfpfac_tpu/ops/pallas_pair.py::
_make_pair_kernel``.  For compact-alphabet dictionaries (at most 63
symbols): two input bytes per probe.  One walker per byte offset over
the staged pair-symbol stream (ops.staging.stage_pairs,
``(code[i+1] << CB) | code[i]``):

* pair step 0 probes the dense depths-1+2 table p0: bit 0 / bit 1 of
  the entry are the matches of length 1 / 2, ``v >> 2`` the next
  displacement, -1 = dead;
* pair step k >= 1 reads the symbol at ``pos + 2k``:

      sidx = disp + (pair & CBM);  w = side_k[sidx >> 2]   # 4 B/word
      fin_mid = ((w >> ((sidx & 3) * 8)) & 255) == (pair & CBM) + 1
      g = P_k[disp + pair]
      hit = g >= 0 and (g & pair_mask) == pair
      fin_end = hit and (g >> 2CB) & 1;  disp' = hit ? g >> (2CB+1) : MISS

  (nibble side tables hold 8 entries per word and store
  ``(code & 7) + 1``); ``fin_mid`` is bit 2k, ``fin_end`` bit 2k+1.

Bytes outside the dictionary alphabet and past input_size carry the
reserved miss code, so no bounds masking is needed.  Segment truncation
is NOT supported (a stride-2 walk cannot reproduce
master_kernel.cu:141-144 mid-pair cuts exactly); callers use the plan or
depth kernel for that mode.

Same output contract as ops.plan.  ``pair_scan`` is the kernel wrapper:
a CUDA tensor launches ``csrc/pair_scan.cu`` (warp tiles over
pre-decoded steps, ``pair_descriptors``), a CPU tensor runs
``pair_scan_plain``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from phfpfac_tpu_torch.compile.pair import (
    PairTables,
    PairUnsupported,
    build_pair_tables,
)
from phfpfac_tpu_torch.compile.tables import ShardTables
from phfpfac_tpu_torch.ops.plan import (
    CountScan,
    ShardScanner,
    check_operand,
    check_staged,
    count_total,
    popcount32,
    probe_banks,
)
from phfpfac_tpu_torch.ops.staging import (
    LANE,
    TILE,
    stage_pairs,
    staged_rows,
    to_device_bytes,
)
from phfpfac_tpu_torch.utils.profile import span

# one row of the pair tables' step list (compile.pair)
STEP_FIELDS = ("p_off", "p_nb", "p_k0", "s_off", "s_nb", "s_k0", "s_nibble")
# one pair step's ready operands, as the tile kernel reads them (struct
# Step of csrc/pair_scan.cu)
PAIR_DESC_FIELDS = ("base", "lo", "span", "s_base", "s_lo", "s_span", "wsh",
                    "smask", "fsh", "fmask", "amask")

launches = 0  # CUDA kernel launches (the CPU plain path never counts)


@dataclass
class PairKernelTables:
    """One shard's pair tables as tensors on the scan device."""

    p0: torch.Tensor  # int32 [nb_p0, 128]
    packed: torch.Tensor  # int32 [NB, 128]
    side: torch.Tensor  # int32 [NS, 128]
    code_of: torch.Tensor  # int32 [256]
    step_rows: tuple  # host [n_pair_steps - 1] rows of STEP_FIELDS
    desc: np.ndarray  # host uint32 [n_pair_steps - 1, 11]: pair_descriptors
    n_pair_steps: int
    cb: int
    disp_miss: int
    # a dead walker's probes (disp_miss + symbol) lie past every pair
    # and side table, so the kernel may stop it: checked here, never
    # assumed
    dead_exit: bool

    @classmethod
    def from_pair(cls, pt: PairTables, device) -> "PairKernelTables":
        nibbles = pt.s_nibbles or (False,) * (pt.n_pair_steps - 1)
        rows = tuple(
            tuple(int(x) for x in row) for row in zip(
                pt.p_offs, pt.p_nbs, pt.p_k0s, pt.s_offs, pt.s_nbs,
                pt.s_k0s, nibbles)
        )
        dead_exit = all(
            pt.disp_miss >> 7 >= p_k0 + p_nb
            and (pt.disp_miss >> (3 if nib else 2)) >> 7 >= s_k0 + s_nb
            for (_po, p_nb, p_k0, _so, s_nb, s_k0, nib) in rows
        )

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        return cls(
            p0=dev(pt.p0_banks), packed=dev(pt.packed_banks),
            side=dev(pt.side_banks), code_of=dev(pt.code_of),
            step_rows=rows, desc=pair_descriptors(rows),
            n_pair_steps=pt.n_pair_steps, cb=pt.code_bits,
            disp_miss=pt.disp_miss, dead_exit=dead_exit,
        )


def pair_descriptors(rows) -> np.ndarray:
    """The pair steps' rows (``STEP_FIELDS``) as the tile kernel's ready
    operands: uint32 [len(rows), len(PAIR_DESC_FIELDS)].

    A probe of a table at (off, nb, k0) becomes ``u = idx - lo; u < span
    ? banks[base + u] : -1`` with ``base = off * 128``, ``lo = k0 * 128``,
    ``span = nb * 128`` (unsigned arithmetic), for the pair table and the
    side table alike; the side word of ``sidx`` is read at ``sidx >> wsh``
    and its field ``(w >> ((sidx & smask) << fsh)) & fmask`` is held
    against ``(a1 & amask) + 1``: 4 byte fields a word, or 8 nibbles
    holding the code's low 3 bits."""
    out = []
    for po, pn, pk0, so, sn, sk0, nib in rows:
        side = (3, 7, 2, 15, 7) if nib else (2, 3, 3, 255, 0xFFFFFFFF)
        out.append([po * LANE, pk0 * LANE, pn * LANE, so * LANE, sk0 * LANE,
                    sn * LANE, *side])
    out = np.asarray(out, np.uint32).reshape(-1, len(PAIR_DESC_FIELDS))
    out.setflags(write=False)  # shared by every launch over these steps
    return out


def pair_scan_plain(staged: torch.Tensor, t: PairKernelTables, *,
                    emit: str = "bitmap", shift=0):
    """Every step for every position, no early exit."""
    flat = staged.reshape(-1)
    n_pos = flat.shape[0] - TILE
    cb = t.cb
    cbm = (1 << cb) - 1
    pair_mask = (1 << (2 * cb)) - 1
    fin_bit = 1 << (2 * cb)
    cur = flat[:n_pos].to(torch.int64)
    v = probe_banks(t.p0, cur, 0, t.p0.shape[0], 0)
    alive = v >= 0
    out = torch.where(alive, v & 3, 0)
    disp = torch.where(alive, v >> 2, t.disp_miss)
    for k, (po, pn, pk0, so, sn, sk0, nib) in enumerate(t.step_rows, 1):
        cur = flat[2 * k:2 * k + n_pos].to(torch.int64)
        a1 = cur & cbm
        sidx = disp + a1
        # a -1 side miss reads as byte 255 / nibble 15: never a code + 1
        if nib:
            w = probe_banks(t.side, sidx >> 3, so, sn, sk0)
            fin_mid = ((w >> ((sidx & 7) << 2)) & 15) == (a1 & 7) + 1
        else:
            w = probe_banks(t.side, sidx >> 2, so, sn, sk0)
            fin_mid = ((w >> ((sidx & 3) << 3)) & 255) == a1 + 1
        g = probe_banks(t.packed, disp + cur, po, pn, pk0)
        hit = (g >= 0) & ((g & pair_mask) == cur)
        fin_end = hit & ((g & fin_bit) != 0)
        out = (out | (fin_mid.to(torch.int64) << (2 * k))
               | (fin_end.to(torch.int64) << (2 * k + 1)))
        disp = torch.where(hit, g >> (2 * cb + 1), t.disp_miss)
    if emit == "count":
        return count_total(out, shift, None)
    return popcount32(out).to(torch.int32), out.to(torch.int32)


def _lib():
    from phfpfac_tpu_torch import _build

    lib = _build.load("pair_scan")
    if lib.pair_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pair_scan.argtypes = [
            p, i, p, i, p, p, p, i, i, i, i, i, p, p, i, p, p,
        ]
        lib.pair_scan.restype = i
    return lib


def _pair_scan_cuda(staged, t, *, emit, shift):
    global launches
    dev = staged.device
    for name in ("p0", "packed", "side"):
        check_operand(getattr(t, name), dev, name)
    check_operand(staged, dev, "staged")
    check_staged(staged)
    if len(t.desc) != t.n_pair_steps - 1:
        raise ValueError(f"desc: need {t.n_pair_steps - 1} step rows, got "
                         f"{len(t.desc)}")
    n_pos = staged.numel() - TILE
    bitmap = emit == "bitmap"
    if bitmap:
        cnt = torch.empty(n_pos, dtype=torch.int32, device=dev)
        bits = torch.empty(n_pos, dtype=torch.int32, device=dev)
        total = None
    else:
        cnt = bits = None
        total = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().pair_scan(
        staged.data_ptr(), n_pos, t.p0.data_ptr(), t.p0.shape[0],
        t.packed.data_ptr(), t.side.data_ptr(), t.desc.ctypes.data,
        t.n_pair_steps, t.cb, t.disp_miss, int(t.dead_exit), int(bitmap),
        None if cnt is None else cnt.data_ptr(),
        None if bits is None else bits.data_ptr(),
        int(shift),
        None if total is None else total.data_ptr(),
        stream,
    )
    if err:
        raise RuntimeError(f"pair_scan launch failed: CUDA error {err}")
    launches += 1
    return (cnt, bits) if bitmap else total


def pair_scan(staged: torch.Tensor, t: PairKernelTables, *,
              emit: str = "bitmap", shift=0):
    """Pair walk over a staged pair stream (exact mode only).

    ``emit="bitmap"`` -> (cnt, bits), int32 [n_pos] each;
    ``emit="count"`` -> int64 [1] total over positions >= shift.
    """
    if emit not in ("bitmap", "count"):
        raise ValueError(f"emit must be 'bitmap' or 'count', got {emit!r}")
    if staged.dim() != 2 or staged.shape[1] != LANE or \
            staged.shape[0] * LANE <= TILE:
        raise ValueError("staged: need a (rows, 128) pair stream with its "
                         "spare 8-row block")
    if staged.device.type == "cpu":
        return pair_scan_plain(staged, t, emit=emit, shift=shift)
    if staged.device.type != "cuda":
        raise ValueError(f"no pair kernel for device {staged.device}")
    return _pair_scan_cuda(staged, t, emit=emit, shift=shift)


class PairShardScanner(ShardScanner):
    """Bitmap-mode stride-2 scanner for one shard (exact mode only).

    Raises compile.pair.PairUnsupported at construction when the shard's
    alphabet or tables do not fit the pair entry."""

    def __init__(self, shard: ShardTables, *, device):
        self.pt: PairTables = build_pair_tables(shard)
        self.shard = shard
        self.device = torch.device(device)
        self.tables = PairKernelTables.from_pair(self.pt, self.device)

    def stage(self, data: torch.Tensor, input_size: int,
              max_steps: int) -> torch.Tensor:
        n_pos = data.shape[0] - max_steps
        with span("stage:input.stage"):
            return stage_pairs(data, input_size, self.tables.code_of,
                               n_rows=staged_rows(n_pos),
                               cb=self.pt.code_bits)

    def scan(self, data_padded, input_size, cfg, max_steps):
        """(per-position counts, per-position bitmaps) on the device."""
        if cfg.truncation == "segment":
            raise PairUnsupported("segment truncation needs stride-1")
        data = to_device_bytes(data_padded, self.device)
        staged = self.stage(data, input_size, max_steps)
        with span("stage:scan.launch"):
            return pair_scan(staged, self.tables)


class PairCountScan(CountScan):
    """Count-mode stride-2 scan."""

    def __init__(self, shard: ShardTables, max_steps: int, *, device):
        super().__init__(max_steps)
        self.scanner = PairShardScanner(shard, device=device)
        self.pt = self.scanner.pt

    def scan(self, staged, input_size, shift):
        return pair_scan(staged, self.scanner.tables, emit="count",
                         shift=shift)


def pair_count_scanner(shard: ShardTables, max_steps: int, *,
                       device) -> PairCountScan:
    return PairCountScan(shard, max_steps, device=device)
