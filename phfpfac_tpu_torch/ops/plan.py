"""Plan scan: the hybrid-stride PFAC walk over compile.plan's tables.

Replaces the Pallas TPU kernel ``phfpfac_tpu/ops/pallas_plan.py::
_make_plan_kernel`` (step body ``_run_steps``).  One walker per byte
offset walks the plan's static step chain over the staged pair-symbol
stream (ops.staging.stage_pairs):

* prologue at offset 0: a probe of p0 — the dense depths-1+2 table
  ("dense"), the code-indexed depth-1 table ("s0"), or the
  two-byte-addressed split prologue ("s0x");
* then per step either a one-byte "mono" probe (``idx = disp + sym``)
  or a two-byte "pair" probe plus its odd-depth side table;
* every probe verifies the stored symbol, sets the step's fin bit(s)
  and chains the next displacement; a miss carries the dead
  displacement 0, which stays dead (dead-zone scheme, compile.plan).

Output contract (shared with every scan kernel): per position an int32
bitmap, bit t set iff a match of length t+1 starts there, and its
popcount; or, in count mode, the total of those counts over positions
``>= shift``.

``plan_scan`` is the kernel wrapper: a CUDA tensor launches the
hand-written CUDA kernel (``csrc/plan_scan.cu``), a CPU tensor runs
``plan_scan_plain``, the same walk in plain torch ops (loop over steps,
vectorised over positions).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from phfpfac_tpu_torch.compile.pair import PairUnsupported
from phfpfac_tpu_torch.compile.plan import PlanTables, build_plan_tables
from phfpfac_tpu_torch.compile.tables import ShardTables
from phfpfac_tpu_torch.ops.staging import (
    LANE,
    TILE,
    stage_pairs,
    staged_rows,
    to_device_bytes,
)

# one row of the step array the kernel reads (csrc/plan_scan.cu)
STEP_FIELDS = ("kind", "depth0", "off", "nb", "k0", "s_off", "s_nb",
               "s_k0", "s_nibble", "miss", "col_bits")
P0_MODES = {"dense": 0, "s0": 1, "s0x": 2}

launches = 0  # CUDA kernel launches (the CPU plain path never counts)


@dataclass
class PlanKernelTables:
    """One shard's plan tables as tensors on the scan device."""

    p0: torch.Tensor  # int32 [nb_p0, 128]
    packed: torch.Tensor  # int32 [nb, 128]
    side: torch.Tensor  # int32 [ns, 128]
    steps: torch.Tensor  # int32 [n_steps, len(STEP_FIELDS)]
    code_of: torch.Tensor  # int32 [256]
    spec: tuple  # tuple[StepSpec]
    cb: int
    p0_mode: str
    p0_miss: int

    @classmethod
    def from_plan(cls, pt: PlanTables, device) -> "PlanKernelTables":
        rows = [
            [int(getattr(s, f)) if f != "kind" else int(s.kind == "pair")
             for f in STEP_FIELDS]
            for s in pt.steps
        ]
        steps = np.asarray(rows, np.int32).reshape(-1, len(STEP_FIELDS))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        return cls(
            p0=dev(pt.p0_banks), packed=dev(pt.packed_banks),
            side=dev(pt.side_banks), steps=dev(steps),
            code_of=dev(pt.code_of), spec=tuple(pt.steps),
            cb=pt.code_bits, p0_mode=pt.p0_mode, p0_miss=pt.p0_miss,
        )


# ---- plain torch version --------------------------------------------------

def probe_banks(banks: torch.Tensor, idx: torch.Tensor, off: int,
                nb: int, k0: int) -> torch.Tensor:
    """Banked lookup: banks[off + (idx >> 7) - k0][idx & 127] when the
    bank lies in [k0, k0 + nb), else the -1 miss.  int64 in and out."""
    bank = idx >> 7  # arithmetic: negative indices miss
    ok = (bank >= k0) & (bank < k0 + nb)
    j = torch.where(ok, (off + bank - k0) * LANE + (idx & (LANE - 1)), 0)
    return torch.where(ok, banks.reshape(-1)[j].to(torch.int64), -1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each value's low 32 bits (int64 in, int64 out)."""
    x = x & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def segment_room(n_pos: int, seg_bytes: int, halo_bytes: int,
                 device) -> torch.Tensor:
    """Chars a walker may read before the segment cut (power-of-two
    segments): ``(pos & ~(seg-1)) + seg + halo - pos``."""
    pos = torch.arange(n_pos, dtype=torch.int64, device=device)
    return (pos & ~(seg_bytes - 1)) + (seg_bytes + halo_bytes) - pos


def count_total(out: torch.Tensor, shift, prev_total) -> torch.Tensor:
    """Count-mode reduction: sum of popcounts over positions >= shift,
    where a chained scan's shift is ``(prev_total + shift) % 2``."""
    pos = torch.arange(out.shape[0], dtype=torch.int64, device=out.device)
    s = torch.as_tensor(shift, dtype=torch.int64, device=out.device)
    if prev_total is not None:
        s = (prev_total.reshape(()) + s) % 2
    return torch.where(pos >= s, popcount32(out), 0).sum().reshape(1)


def plan_scan_plain(staged: torch.Tensor, t: PlanKernelTables, *,
                    emit: str = "bitmap", seg_bytes: int = 0,
                    halo_bytes: int = 0, shift=0, prev_total=None):
    """Every step for every position, no early exit."""
    flat = staged.reshape(-1)
    n_pos = flat.shape[0] - TILE
    cb = t.cb
    cbm = (1 << cb) - 1
    room = (
        segment_room(n_pos, seg_bytes, halo_bytes, flat.device)
        if seg_bytes else None
    )
    c0 = flat[:n_pos].to(torch.int64)
    if t.p0_mode == "dense":
        idx = c0
    elif t.p0_mode == "s0x":
        sb = cb - 6
        idx = ((c0 & cbm) << sb) | ((c0 >> (cb + 6)) & ((1 << sb) - 1))
    else:
        idx = c0 & cbm
    v = probe_banks(t.p0, idx, 0, t.p0.shape[0], 0)
    alive = v >= 0
    out = (alive & ((v & 1) == 1)).to(torch.int64)
    if t.p0_mode == "dense":
        fin2 = alive & ((v & 2) == 2)
        if room is not None:
            fin2 = fin2 & (room > 1)
        out = out | (fin2.to(torch.int64) << 1)
        disp = torch.where(alive, v >> 2, t.p0_miss)
    else:
        disp = torch.where(alive, v >> 1, t.p0_miss)

    pair_mask = (1 << (2 * cb)) - 1
    for sp in t.spec:
        o = sp.depth0 - 1
        if room is not None:
            disp = torch.where(room > o, disp, sp.miss)
        cur = flat[o:o + n_pos].to(torch.int64)
        if sp.kind == "mono":
            if sp.col_bits:
                cmask, finm, vsh = ((1 << sp.col_bits) - 1,
                                    1 << (sp.col_bits + 1), sp.col_bits + 2)
            else:
                cmask, finm, vsh = cbm, 1 << cb, cb + 1
            sym = cur & cmask
            g = probe_banks(t.packed, disp + sym, sp.off, sp.nb, sp.k0)
            gs = g & ((1 << vsh) - 1)
            fin = gs == (sym | finm)
            hit = (gs == sym) | fin
            out = out | (fin.to(torch.int64) << o)
            disp = torch.where(hit, g >> vsh, sp.miss)
        else:
            g = probe_banks(t.packed, disp + cur, sp.off, sp.nb, sp.k0)
            a1 = cur & cbm
            sidx = disp + a1
            wshift = 3 if sp.s_nibble else 2
            w = probe_banks(t.side, sidx >> wshift, sp.s_off, sp.s_nb,
                            sp.s_k0)
            if sp.s_nibble:
                fin_mid = ((w >> ((sidx & 7) << 2)) & 15) == (a1 & 7) + 1
            else:
                fin_mid = ((w >> ((sidx & 3) << 3)) & 255) == a1 + 1
            gs = g & (pair_mask | (1 << (2 * cb)))
            fin_end = gs == (cur | (1 << (2 * cb)))
            hit = (gs == cur) | fin_end
            if room is not None:
                # cut between the pair's two chars: the mid completion
                # stands, the end match and the chain do not
                ok2 = room > o + 1
                hit = hit & ok2
                fin_end = fin_end & ok2
            out = (out | (fin_mid.to(torch.int64) << o)
                   | (fin_end.to(torch.int64) << (o + 1)))
            disp = torch.where(hit, g >> (2 * cb + 1), sp.miss)

    if emit == "count":
        return count_total(out, shift, prev_total)
    return popcount32(out).to(torch.int32), out.to(torch.int32)


# ---- CUDA kernel -----------------------------------------------------------

def _lib():
    from phfpfac_tpu_torch import _build

    lib = _build.load("plan_scan")
    if lib.plan_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.plan_scan.argtypes = [
            p, i, p, i, p, p, p, i, i, i, i, i, i, i, p, p, i, p, p, p,
        ]
        lib.plan_scan.restype = i
    return lib


def check_operand(x: torch.Tensor, device, name: str) -> None:
    if x.device != device or x.dtype != torch.int32 or \
            not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous int32 tensor on {device}, got "
            f"{x.dtype} on {x.device}"
        )


def _plan_scan_cuda(staged, t, *, emit, seg_bytes, halo_bytes, shift,
                    prev_total):
    global launches
    dev = staged.device
    for name in ("p0", "packed", "side", "steps"):
        check_operand(getattr(t, name), dev, name)
    check_operand(staged, dev, "staged")
    if seg_bytes & (seg_bytes - 1):
        raise ValueError("the plan kernel takes power-of-two segments")
    n_pos = staged.numel() - TILE
    bitmap = emit == "bitmap"
    if bitmap:
        cnt = torch.empty(n_pos, dtype=torch.int32, device=dev)
        bits = torch.empty(n_pos, dtype=torch.int32, device=dev)
        total = None
    else:
        cnt = bits = None
        total = torch.zeros(1, dtype=torch.int64, device=dev)
    if prev_total is not None and (prev_total.device != dev
                                   or prev_total.dtype != torch.int64):
        raise ValueError("prev_total: need an int64 tensor on the device")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().plan_scan(
        staged.data_ptr(), n_pos, t.p0.data_ptr(), t.p0.shape[0],
        t.packed.data_ptr(), t.side.data_ptr(), t.steps.data_ptr(),
        t.steps.shape[0], t.cb, P0_MODES[t.p0_mode], t.p0_miss,
        seg_bytes, halo_bytes, int(bitmap),
        None if cnt is None else cnt.data_ptr(),
        None if bits is None else bits.data_ptr(),
        int(shift),
        None if prev_total is None else prev_total.data_ptr(),
        None if total is None else total.data_ptr(),
        stream,
    )
    if err:
        raise RuntimeError(f"plan_scan launch failed: CUDA error {err}")
    launches += 1
    return (cnt, bits) if bitmap else total


def plan_scan(staged: torch.Tensor, t: PlanKernelTables, *,
              emit: str = "bitmap", seg_bytes: int = 0, halo_bytes: int = 0,
              shift=0, prev_total=None):
    """Plan walk over a staged pair stream.

    ``emit="bitmap"`` -> (cnt, bits), int32 [n_pos] each;
    ``emit="count"`` -> int64 [1] total over positions >= shift (with
    ``prev_total``, a chained scan: shift = (prev_total + shift) % 2).
    ``seg_bytes`` > 0 applies the reference's segment + halo cut.
    """
    if emit not in ("bitmap", "count"):
        raise ValueError(f"emit must be 'bitmap' or 'count', got {emit!r}")
    kw = dict(emit=emit, seg_bytes=seg_bytes, halo_bytes=halo_bytes,
              shift=shift, prev_total=prev_total)
    if staged.device.type == "cpu":
        return plan_scan_plain(staged, t, **kw)
    if staged.device.type != "cuda":
        raise ValueError(f"no plan kernel for device {staged.device}")
    return _plan_scan_cuda(staged, t, **kw)


class PlanShardScanner:
    """Bitmap-mode plan scanner for one shard."""

    def __init__(self, shard: ShardTables, *, device, train=None, pt=None):
        # ``pt``: a previously built (possibly deserialized) PlanTables
        self.pt: PlanTables = (
            pt if pt is not None else build_plan_tables(shard, train=train)
        )
        self.shard = shard
        self.device = torch.device(device)
        self.tables = PlanKernelTables.from_plan(self.pt, self.device)

    def stage(self, data: torch.Tensor, input_size: int,
              max_steps: int) -> torch.Tensor:
        n_pos = data.shape[0] - max_steps
        return stage_pairs(data, input_size, self.tables.code_of,
                           n_rows=staged_rows(n_pos), cb=self.pt.code_bits)

    def scan(self, data_padded, input_size, cfg, max_steps):
        """(per-position counts, per-position bitmaps) on the device."""
        seg, halo = 0, 0
        if cfg.truncation == "segment":
            if cfg.segment_bytes & (cfg.segment_bytes - 1):
                raise PairUnsupported("segment size must be a power of 2")
            seg, halo = cfg.segment_bytes, cfg.halo_bytes
        data = to_device_bytes(data_padded, self.device)
        return plan_scan(self.stage(data, input_size, max_steps),
                         self.tables, seg_bytes=seg, halo_bytes=halo)


class CountScan:
    """Count-mode scan over one bitmap scanner's tables, exact mode:
    fn(data_padded, input_size, shift) -> int64 [1] total over positions
    >= shift, also as ``prepare`` (stage once) + ``scan``.  A subclass
    builds ``self.scanner`` and defines ``scan``."""

    scanner = None

    def __init__(self, max_steps: int):
        self.max_steps = max_steps

    def prepare(self, data_padded, input_size):
        data = to_device_bytes(data_padded, self.scanner.device)
        return self.scanner.stage(data, input_size, self.max_steps)

    def scan(self, staged, input_size, shift):
        raise NotImplementedError

    def __call__(self, data_padded, input_size, shift):
        return self.scan(self.prepare(data_padded, input_size),
                         input_size, shift)


class PlanCountScan(CountScan):
    """Count-mode plan scan."""

    def __init__(self, shard: ShardTables, max_steps: int, *, device,
                 train=None, pt=None):
        super().__init__(max_steps)
        self.scanner = PlanShardScanner(shard, device=device, train=train,
                                        pt=pt)
        self.pt = self.scanner.pt

    def scan(self, staged, input_size, shift):
        return plan_scan(staged, self.scanner.tables, emit="count",
                         shift=shift)


def plan_count_scanner(shard: ShardTables, max_steps: int, *, device,
                       train=None, pt=None) -> PlanCountScan:
    return PlanCountScan(shard, max_steps, device=device, train=train,
                         pt=pt)
