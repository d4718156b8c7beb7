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

``plan_scan_compact`` is the two-phase form of the same scan (replaces
``_plan_scan_bitmap_compact`` / ``_plan_scan_count_compact`` and their
``_make_planb_kernel``): the steps before a cut run for every position
and hand on the walkers still live at the cut, the steps after it run
for those survivors only (``csrc/planb_scan.cu``) and merge into the
first phase's outputs.  It returns the TRUE survivor count beside the
result, as a device tensor: with ``count > cap`` the result is
incomplete and the caller rescans (``PlanShardScanner.scan_async`` /
``PlanCountScan.check_overflow``).  ``plan_scan_compact_plain`` is its
plain version.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field

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
from phfpfac_tpu_torch.utils.profile import span

P0_MODES = {"dense": 0, "s0": 1, "s0x": 2}

# the plan kernel's geometry (csrc/plan_scan.cu kTile, kHalo)
PLAN_TILE = 2048  # a block's tile: 8 warp tiles of 256 positions
PLAN_HALO = 32  # staged words past a warp tile that its windows may read
# one step's ready operands, as the tile kernel reads them (struct Step)
STEP_DESC_FIELDS = ("o", "pair", "base", "lo", "span", "cmask", "finm",
                    "vmask", "vsh", "s_base", "s_lo", "s_span", "wsh",
                    "smask", "fsh", "fmask", "amask")

launches = 0  # CUDA kernel launches (the CPU plain path never counts)
launches_compact_a = 0  # launches of the compacted scan's phase A ...
launches_compact_b = 0  # ... and of its phase B
overflow_rescans = 0  # uncompacted rescans after count > cap


@dataclass
class PlanKernelTables:
    """One shard's plan tables as tensors on the scan device."""

    p0: torch.Tensor  # int32 [nb_p0, 128]
    packed: torch.Tensor  # int32 [nb, 128]
    side: torch.Tensor  # int32 [ns, 128]
    code_of: torch.Tensor  # int32 [256]
    spec: tuple  # tuple[StepSpec]
    desc: np.ndarray  # host uint32 [n_steps, 17]: step_descriptors(spec)
    cb: int
    p0_mode: str
    p0_miss: int
    # cut -> K6's descriptors of spec[cut:] and their address (deep_desc)
    _deep: dict = field(default_factory=dict, init=False, repr=False,
                        compare=False)

    @classmethod
    def from_plan(cls, pt: PlanTables, device) -> "PlanKernelTables":
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        with span("stage:tables.upload"):
            p0, packed = dev(pt.p0_banks), dev(pt.packed_banks)
            side, code_of = dev(pt.side_banks), dev(pt.code_of)
        return cls(
            p0=p0, packed=packed, side=side, code_of=code_of,
            spec=tuple(pt.steps),
            desc=step_descriptors(pt.steps, pt.code_bits, pt.p0_miss),
            cb=pt.code_bits, p0_mode=pt.p0_mode, p0_miss=pt.p0_miss,
        )

    def deep_desc(self, cut: int) -> np.ndarray:
        """K6's steps: ``step_descriptors(spec[cut:])``, built once a cut
        and kept; the table operands it walks are checked then, once."""
        return self._deep_entry(cut)[0]

    def _deep_entry(self, cut: int):
        got = self._deep.get(cut)
        if got is None:
            for name in ("packed", "side"):
                check_operand(getattr(self, name), self.packed.device, name)
            desc = step_descriptors(self.spec[cut:], self.cb, self.p0_miss)
            got = self._deep[cut] = (desc, desc.ctypes.data)
        return got


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


def count_shift(shift, prev_total, device) -> torch.Tensor:
    """A count-mode scan's shift as a scalar tensor; a chained scan's is
    ``(prev_total + shift) % 2``."""
    s = torch.as_tensor(shift, dtype=torch.int64, device=device)
    if prev_total is not None:
        s = (prev_total.reshape(()) + s) % 2
    return s


def count_total(out: torch.Tensor, shift, prev_total) -> torch.Tensor:
    """Count-mode reduction: sum of popcounts over positions >= shift."""
    pos = torch.arange(out.shape[0], dtype=torch.int64, device=out.device)
    s = count_shift(shift, prev_total, out.device)
    return torch.where(pos >= s, popcount32(out), 0).sum().reshape(1)


def _prologue_plain(flat, n_pos: int, t: PlanKernelTables, room):
    """The probe of p0 at offset 0 for every position: (out, disp)."""
    cb = t.cb
    cbm = (1 << cb) - 1
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
    return out, disp


def plan_steps_plain(spec, t: PlanKernelTables, window, room, disp, out):
    """The step chain ``spec`` for a set of walkers, no early exit:
    ``window(o)`` gives their pair symbols at char offset ``o``,
    ``room`` their chars before the segment cut (None in exact mode).
    Returns (disp, out)."""
    cb = t.cb
    cbm = (1 << cb) - 1
    pair_mask = (1 << (2 * cb)) - 1
    for sp in spec:
        o = sp.depth0 - 1
        if room is not None:
            disp = torch.where(room > o, disp, sp.miss)
        cur = window(o).to(torch.int64)
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
    return disp, out


def _walk_all_plain(staged, t: PlanKernelTables, spec, seg_bytes,
                    halo_bytes):
    """Prologue + ``spec`` for every position: (flat, disp, out)."""
    flat = staged.reshape(-1)
    n_pos = flat.shape[0] - TILE
    room = (
        segment_room(n_pos, seg_bytes, halo_bytes, flat.device)
        if seg_bytes else None
    )
    out, disp = _prologue_plain(flat, n_pos, t, room)
    disp, out = plan_steps_plain(
        spec, t, lambda o: flat[o:o + n_pos], room, disp, out)
    return flat, disp, out


def plan_scan_plain(staged: torch.Tensor, t: PlanKernelTables, *,
                    emit: str = "bitmap", seg_bytes: int = 0,
                    halo_bytes: int = 0, shift=0, prev_total=None):
    """Every step for every position, no early exit."""
    _flat, _disp, out = _walk_all_plain(staged, t, t.spec, seg_bytes,
                                        halo_bytes)
    if emit == "count":
        return count_total(out, shift, prev_total)
    return popcount32(out).to(torch.int32), out.to(torch.int32)


def plan_scan_compact_a_plain(staged: torch.Tensor, t: PlanKernelTables,
                               *, cut: int, cap: int, emit: str = "bitmap",
                               seg_bytes: int = 0, halo_bytes: int = 0,
                               shift=0, prev_total=None):
    """Phase A in plain torch ops: ``spec[:cut]`` for every position.
    -> (result, survivors): the result as ``plan_scan_plain`` gives it
    for those steps, and (pos, disp, count) of the walkers live at the
    cut, ascending, the first ``cap`` of them, with their true number."""
    _flat, disp, out = _walk_all_plain(staged, t, t.spec[:cut], seg_bytes,
                                       halo_bytes)
    live = disp != t.p0_miss
    pos = torch.nonzero(live).reshape(-1)[:cap]
    surv = (pos.to(torch.int32), disp[pos].to(torch.int32),
            live.sum().to(torch.int32))
    if emit == "count":
        return count_total(out, shift, prev_total), surv
    return (popcount32(out).to(torch.int32), out.to(torch.int32)), surv


def planb_scan_plain(staged: torch.Tensor, t: PlanKernelTables, result,
                     surv, *, cut: int, cap: int, emit: str = "bitmap",
                     seg_bytes: int = 0, halo_bytes: int = 0, shift=0,
                     prev_total=None) -> None:
    """Phase B in plain torch ops: ``spec[cut:]`` for the survivors,
    windows read at ``flat[pos + o]``, the segment room recomputed per
    survivor; merges the deep bits into ``result`` IN PLACE (a position
    occurs once, and shallow and deep length bits are disjoint)."""
    pos, disp, count = surv
    n = min(int(count), cap)
    pos, disp = pos[:n].to(torch.int64), disp[:n].to(torch.int64)
    flat = staged.reshape(-1)
    room = (
        (pos & ~(seg_bytes - 1)) + (seg_bytes + halo_bytes) - pos
        if seg_bytes else None
    )
    _disp, deep = plan_steps_plain(
        t.spec[cut:], t, lambda o: flat[pos + o], room, disp,
        torch.zeros_like(pos))
    if emit == "count":
        s = count_shift(shift, prev_total, flat.device)
        result += torch.where(pos >= s, popcount32(deep), 0).sum()
    else:
        cnt, bits = result
        bits[pos] |= deep.to(torch.int32)
        cnt[pos] += popcount32(deep).to(torch.int32)


# ---- CUDA kernels ----------------------------------------------------------

def step_descriptors(spec: tuple, cb: int, p0_miss: int) -> np.ndarray:
    """The steps of ``spec`` as the tile kernel's ready operands: uint32
    [len(spec), len(STEP_DESC_FIELDS)], one row per step.

    ``spec`` is the plan's step list on the host (``t.spec``), so no
    launch reads the device; K1 walks all of it, K6 ``spec[cut:]``.  A
    probe of a table at (off, nb, k0) becomes
    ``u = idx - lo; u < span ? banks[base + u] : -1`` with ``base = off *
    128``, ``lo = k0 * 128``, ``span = nb * 128`` (unsigned arithmetic:
    a negative ``idx`` misses); a mono step's symbol mask, fin flag, kept
    bits and value shift come ready, and a pair step's side word is read
    as ``(w >> ((sidx & smask) << fsh)) & fmask == (a1 & amask) + 1`` at
    ``banks[sidx >> wsh]``.  The kernel drops a walker whose displacement
    is the dead sentinel, so every step's miss must be it."""
    rows = []
    for sp in spec:
        o = sp.depth0 - 1
        if sp.miss != p0_miss or not 0 <= o < PLAN_HALO:
            raise ValueError(f"a step the tile kernel cannot walk: {sp}")
        if sp.col_bits:
            cmask, finm, vsh = ((1 << sp.col_bits) - 1,
                                1 << (sp.col_bits + 1), sp.col_bits + 2)
        else:
            cmask, finm, vsh = (1 << cb) - 1, 1 << cb, cb + 1
        side = (3, 7, 2, 15, 7) if sp.s_nibble else (2, 3, 3, 255, 0xFFFFFFFF)
        rows.append([o, int(sp.kind == "pair"), sp.off * LANE, sp.k0 * LANE,
                     sp.nb * LANE, cmask, finm, (1 << vsh) - 1, vsh,
                     sp.s_off * LANE, sp.s_k0 * LANE, sp.s_nb * LANE, *side])
    out = np.asarray(rows, np.uint32).reshape(-1, len(STEP_DESC_FIELDS))
    out.setflags(write=False)  # shared by every launch over these steps
    return out


def check_staged(staged: torch.Tensor) -> None:
    """The tile kernels' demands on the staged stream (K1 here, K2 and K3
    in ops.depth and ops.pair): a 16-byte aligned view (its tiles arrive
    in 16-byte copies) of n_pos + TILE words, n_pos a multiple of TILE (so
    a warp tile is whole and the last tile's look-ahead of 32 words stays
    inside the spare TILE)."""
    if staged.data_ptr() % 16:
        raise ValueError("staged: the tile kernels copy 16-byte chunks; "
                         "need a 16-byte aligned view")
    n_pos = staged.numel() - TILE
    if n_pos < 0 or n_pos % TILE:
        raise ValueError(f"n_pos must be a multiple of {TILE}, got {n_pos}")


def _lib():
    from phfpfac_tpu_torch import _build

    lib = _build.load("plan_scan")
    if lib.plan_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        scan_args = [p, i, p, i, p, p, p, i, i, i, i, i, i, i, p, p, i, p, p]
        lib.plan_scan.argtypes = scan_args + [p]
        lib.plan_scan.restype = i
        lib.plan_scan_compact_a.argtypes = scan_args + [i, p, p, p, p]
        lib.plan_scan_compact_a.restype = i
        lib.plan_scan_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.plan_scan_geometry.restype = i
    return lib


def plan_kernel_geometry(device) -> dict:
    """The tile kernel's geometry on ``device`` (CUDA): positions per
    tile, threads and shared-memory bytes per block, resident blocks per
    SM (bitmap mode under the segment cut)."""
    vals = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device):
        err = _lib().plan_scan_geometry(*[ctypes.byref(v) for v in vals])
    if err:
        raise RuntimeError(f"plan_scan_geometry failed: CUDA error {err}")
    return dict(zip(("tile", "threads", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def _lib_b():
    from phfpfac_tpu_torch import _build

    lib = _build.load("planb_scan")
    if lib.planb_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.planb_scan.argtypes = [
            p, p, p, p, i, i, i, i, i, i, p, p, p, i, p, p, i, p, p, p,
        ]
        lib.planb_scan.restype = i
    return lib


def check_operand(x: torch.Tensor, device, name: str) -> None:
    if x.device != device or x.dtype != torch.int32 or \
            not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous int32 tensor on {device}, got "
            f"{x.dtype} on {x.device}"
        )


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(dev):
    """``dev``'s current stream as a raw handle: where ``dev`` is the
    current device straight from PyTorch's stream registry (no Stream
    object, no device context), else inside a device context."""
    cur = torch.cuda.current_device()
    if dev.index is None or dev.index == cur:
        return torch._C._cuda_getCurrentRawStream(cur)
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _check_prev(prev_total, dev) -> None:
    if prev_total is not None and (prev_total.device != dev
                                   or prev_total.dtype != torch.int64):
        raise ValueError("prev_total: need an int64 tensor on the device")


def _plan_scan_cuda(staged, t, *, emit, seg_bytes, halo_bytes, shift,
                    prev_total, compact=None):
    """One launch of the plan kernel over every step; with
    ``compact=(cut, cap)`` over ``steps[:cut]`` (phase A), and then
    -> (result, (surv_pos, surv_disp, count))."""
    global launches, launches_compact_a
    dev = staged.device
    for name in ("p0", "packed", "side"):
        check_operand(getattr(t, name), dev, name)
    check_operand(staged, dev, "staged")
    if seg_bytes & (seg_bytes - 1):
        raise ValueError("the plan kernel takes power-of-two segments")
    check_staged(staged)
    n_pos = staged.numel() - TILE
    bitmap = emit == "bitmap"
    if bitmap:
        cnt = torch.empty(n_pos, dtype=torch.int32, device=dev)
        bits = torch.empty(n_pos, dtype=torch.int32, device=dev)
        total = None
    else:
        cnt = bits = None
        total = torch.zeros(1, dtype=torch.int64, device=dev)
    _check_prev(prev_total, dev)
    head = (
        staged.data_ptr(), n_pos, t.p0.data_ptr(), t.p0.shape[0],
        t.packed.data_ptr(), t.side.data_ptr(), t.desc.ctypes.data,
        len(t.spec) if compact is None else compact[0],
    )
    mid = (
        t.cb, P0_MODES[t.p0_mode], t.p0_miss, seg_bytes, halo_bytes,
        int(bitmap), _ptr(cnt), _ptr(bits), int(shift), _ptr(prev_total),
        _ptr(total),
    )
    result = (cnt, bits) if bitmap else total
    if compact is None:
        err = _lib().plan_scan(*head, *mid, _stream(dev))
        if err:
            raise RuntimeError(f"plan_scan launch failed: CUDA error {err}")
        launches += 1
        return result
    cut, cap = compact
    surv_pos = torch.empty(cap, dtype=torch.int32, device=dev)
    surv_disp = torch.empty(cap, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    err = _lib().plan_scan_compact_a(
        *head, *mid, cap, surv_pos.data_ptr(), surv_disp.data_ptr(),
        count.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(
            f"plan_scan_compact_a launch failed: CUDA error {err}")
    launches_compact_a += 1
    return result, (surv_pos, surv_disp, count.reshape(()))


def _planb_scan_cuda(staged, t, result, surv, *, cut, cap, emit, seg_bytes,
                     halo_bytes, shift, prev_total):
    """One launch of K6 over steps ``[cut:]``.  The tables' operands are
    checked once a cut (``t.deep_desc``); what the call brings, every
    call."""
    global launches_compact_b
    dev = staged.device
    desc, desc_ptr = t._deep_entry(cut)
    if t.packed.device != dev:
        raise ValueError(f"tables on {t.packed.device}, staged on {dev}")
    surv_pos, surv_disp, count = surv
    bitmap = emit == "bitmap"
    cnt, bits = result if bitmap else (None, None)
    total = None if bitmap else result
    for name, x in (("staged", staged), ("surv_pos", surv_pos),
                    ("surv_disp", surv_disp), ("count", count),
                    ("cnt", cnt), ("bits", bits)):
        if x is not None:
            check_operand(x, dev, name)
    if surv_pos.numel() < cap or surv_disp.numel() < cap:
        raise ValueError(f"survivor buffers hold fewer than cap={cap}")
    if total is not None and (total.device != dev
                              or total.dtype != torch.int64):
        raise ValueError("total: need an int64 tensor on the device")
    _check_prev(prev_total, dev)
    err = _lib_b().planb_scan(
        staged.data_ptr(), t.packed.data_ptr(), t.side.data_ptr(), desc_ptr,
        len(desc), t.cb, t.p0_miss, seg_bytes, halo_bytes, cap,
        surv_pos.data_ptr(), surv_disp.data_ptr(), count.data_ptr(),
        int(bitmap), _ptr(cnt), _ptr(bits), int(shift), _ptr(prev_total),
        _ptr(total), _stream(dev))
    if err:
        raise RuntimeError(f"planb_scan launch failed: CUDA error {err}")
    launches_compact_b += 1


def _check_scan_args(staged, emit):
    if emit not in ("bitmap", "count"):
        raise ValueError(f"emit must be 'bitmap' or 'count', got {emit!r}")
    if staged.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no plan kernel for device {staged.device}")


def plan_scan(staged: torch.Tensor, t: PlanKernelTables, *,
              emit: str = "bitmap", seg_bytes: int = 0, halo_bytes: int = 0,
              shift=0, prev_total=None):
    """Plan walk over a staged pair stream.

    ``emit="bitmap"`` -> (cnt, bits), int32 [n_pos] each;
    ``emit="count"`` -> int64 [1] total over positions >= shift (with
    ``prev_total``, a chained scan: shift = (prev_total + shift) % 2).
    ``seg_bytes`` > 0 applies the reference's segment + halo cut.
    """
    _check_scan_args(staged, emit)
    kw = dict(emit=emit, seg_bytes=seg_bytes, halo_bytes=halo_bytes,
              shift=shift, prev_total=prev_total)
    if staged.device.type == "cpu":
        return plan_scan_plain(staged, t, **kw)
    return _plan_scan_cuda(staged, t, **kw)


def _check_cut(t, cut, cap) -> None:
    if not 1 <= cut < len(t.spec) or cap <= 0:
        raise ValueError(f"bad compaction cut {cut} / cap {cap} for "
                         f"{len(t.spec)} steps")


def plan_scan_compact_a(staged: torch.Tensor, t: PlanKernelTables, *,
                        cut: int, cap: int, emit: str = "bitmap",
                        seg_bytes: int = 0, halo_bytes: int = 0, shift=0,
                        prev_total=None):
    """Phase A of the two-phase walk: steps ``[:cut]`` for every
    position.  -> (result, (surv_pos, surv_disp, count)): the result of
    those steps as ``plan_scan`` shapes it, and the walkers live at the
    cut — position and displacement in int32 buffers that hold up to
    ``cap`` of them, in no order on the card, and their true number as
    an int32 scalar tensor on the device."""
    _check_scan_args(staged, emit)
    _check_cut(t, cut, cap)
    kw = dict(emit=emit, seg_bytes=seg_bytes, halo_bytes=halo_bytes,
              shift=shift, prev_total=prev_total)
    if staged.device.type == "cpu":
        return plan_scan_compact_a_plain(staged, t, cut=cut, cap=cap, **kw)
    return _plan_scan_cuda(staged, t, compact=(cut, cap), **kw)


def planb_scan(staged: torch.Tensor, t: PlanKernelTables, result, surv, *,
               cut: int, cap: int, emit: str = "bitmap",
               seg_bytes: int = 0, halo_bytes: int = 0, shift=0,
               prev_total=None) -> None:
    """Phase B: steps ``[cut:]`` for the survivors ``surv`` of phase A
    (the first ``min(count, cap)`` buffer entries), merged into phase
    A's ``result`` in place: (cnt, bits), or the int64 [1] total."""
    _check_scan_args(staged, emit)
    _check_cut(t, cut, cap)
    kw = dict(cut=cut, cap=cap, emit=emit, seg_bytes=seg_bytes,
              halo_bytes=halo_bytes, shift=shift, prev_total=prev_total)
    if staged.device.type == "cpu":
        return planb_scan_plain(staged, t, result, surv, **kw)
    return _planb_scan_cuda(staged, t, result, surv, **kw)


def _compact(phase_a, phase_b, staged, t, **kw):
    result, surv = phase_a(staged, t, **kw)
    phase_b(staged, t, result, surv, **kw)
    if kw["emit"] == "count":
        return result, surv[2]
    return (*result, surv[2])


def plan_scan_compact_plain(staged: torch.Tensor, t: PlanKernelTables, *,
                            cut: int, cap: int, emit: str = "bitmap",
                            seg_bytes: int = 0, halo_bytes: int = 0,
                            shift=0, prev_total=None):
    """The two-phase walk in plain torch ops: ``spec[:cut]`` for every
    position, then ``spec[cut:]`` for the first ``cap`` walkers (in
    position order) live at the cut.  Results as ``plan_scan_compact``."""
    return _compact(plan_scan_compact_a_plain, planb_scan_plain, staged, t,
                    cut=cut, cap=cap, emit=emit, seg_bytes=seg_bytes,
                    halo_bytes=halo_bytes, shift=shift,
                    prev_total=prev_total)


def plan_scan_compact(staged: torch.Tensor, t: PlanKernelTables, *,
                      cut: int, cap: int, emit: str = "bitmap",
                      seg_bytes: int = 0, halo_bytes: int = 0, shift=0,
                      prev_total=None):
    """Two-phase plan walk: steps ``[:cut]`` for every position, steps
    ``[cut:]`` for at most ``cap`` walkers live at the cut.

    -> (cnt, bits, count) or (total, count) as ``plan_scan``, plus the
    TRUE number of live walkers at the cut, an int32 scalar tensor on
    the device that this function never fetches.  With ``count > cap``
    the result misses the dropped walkers' deep matches: the caller
    must check and rescan with ``plan_scan``.
    """
    return _compact(plan_scan_compact_a, planb_scan, staged, t, cut=cut,
                    cap=cap, emit=emit, seg_bytes=seg_bytes,
                    halo_bytes=halo_bytes, shift=shift,
                    prev_total=prev_total)


# ---- choosing the cut ------------------------------------------------------

# These two and the cap arithmetic below are the JAX package's, kept so
# that a table compacts at the same (cut, cap) in both packages.  What
# the two-phase scan costs on an H100 beside the plain one is in
# PERF.md; until a later change acts on that price, "auto" engages only
# with the opt-in below, and explicit cuts are always honoured.
COMPACT_MARGIN = 2.5  # cap = margin x trained survivor estimate
COMPACT_MAX_FRAC = 0.05  # cut where <= 5% of walkers survive
COMPACT_BLOCK = 8 * TILE  # caps are multiples of this
AUTO_OPT_IN = "PHFPFAC_COMPACT_AUTO"


def resolve_compact(pt: PlanTables, n_pos: int, compact="auto"):
    """Choose the two-phase cut: -> (cut_step, cap) or None.

    ``compact``: off (None, 0, False, "off"); an explicit (cut, cap);
    an int cut, capped from the trained live fraction at that step; or
    "auto", the first step past the prologue whose trained live fraction
    is at most 5%, only with ``PHFPFAC_COMPACT_AUTO=1`` in the
    environment.  The cap carries a 2.5x margin over the trained
    estimate and rounds up to a power-of-two number of blocks; it
    declines when the survivors are too dense (cap * 2 >= n_pos)."""
    if compact in (None, 0, "off", False):
        return None
    block = COMPACT_BLOCK
    if isinstance(compact, tuple):
        cut, cap = compact
        if cap % block:
            raise ValueError(f"cap must be a multiple of {block}")
        return (cut, cap) if 1 <= cut < len(pt.steps) else None
    if isinstance(compact, int) and not isinstance(compact, bool):
        cut = compact
        frac = (
            pt.live_frac[cut]
            if pt.trained and cut < len(pt.live_frac) else COMPACT_MAX_FRAC
        )
    else:
        if os.environ.get(AUTO_OPT_IN) != "1":
            return None
        if not pt.trained or not pt.live_frac:
            return None
        cut = None
        for i, f in enumerate(pt.live_frac):
            if i >= 1 and f <= COMPACT_MAX_FRAC:
                cut = i
                break
        if cut is None:
            return None
        frac = pt.live_frac[cut]
    if not (1 <= cut < len(pt.steps)):
        return None
    cap = max(COMPACT_MARGIN * frac * n_pos, 2 * block)
    b = block
    while b < cap:
        b <<= 1
    cap = b
    if cap * 2 >= n_pos:
        return None  # survivors too dense for compaction to pay
    return cut, cap


# ---- scanners --------------------------------------------------------------

def _segment_cut(cfg) -> tuple[int, int]:
    if cfg.truncation != "segment":
        return 0, 0
    if cfg.segment_bytes & (cfg.segment_bytes - 1):
        raise PairUnsupported("segment size must be a power of 2")
    return cfg.segment_bytes, cfg.halo_bytes


class ShardScanner:
    """Bitmap-mode scanner of one shard.  A subclass defines ``scan`` ->
    (per-position counts, per-position bitmaps) on the device."""

    def scan(self, data_padded, input_size, cfg, max_steps):
        raise NotImplementedError

    def scan_async(self, data_padded, input_size, cfg, max_steps):
        """Dispatch only, for pipelined callers: (cnt, bits, verify);
        ``verify()``, called when the bitmaps are fetched, returns the
        (cnt, bits) to decode.  Nothing waits for the device before it."""
        cnt, bits = self.scan(data_padded, input_size, cfg, max_steps)
        return cnt, bits, lambda: (cnt, bits)


class PlanShardScanner(ShardScanner):
    """Bitmap-mode plan scanner for one shard."""

    def __init__(self, shard: ShardTables, *, device, train=None, pt=None,
                 compact="auto"):
        # ``pt``: a previously built (possibly deserialized) PlanTables
        self.pt: PlanTables = (
            pt if pt is not None else build_plan_tables(shard, train=train)
        )
        self.shard = shard
        self.device = torch.device(device)
        self.compact = compact
        self.tables = PlanKernelTables.from_plan(self.pt, self.device)

    def stage(self, data: torch.Tensor, input_size: int,
              max_steps: int) -> torch.Tensor:
        n_pos = data.shape[0] - max_steps
        with span("stage:input.stage"):
            return stage_pairs(data, input_size, self.tables.code_of,
                               n_rows=staged_rows(n_pos),
                               cb=self.pt.code_bits)

    def scan(self, data_padded, input_size, cfg, max_steps):
        """(per-position counts, per-position bitmaps) on the device."""
        _cnt, _bits, verify = self.scan_async(data_padded, input_size, cfg,
                                              max_steps)
        return verify()

    def scan_async(self, data_padded, input_size, cfg, max_steps):
        """As ``ShardScanner.scan_async``: ``verify()`` reads the
        compacted scan's true survivor count and, past the cap, rescans
        uncompacted and returns the corrected (cnt, bits); else it
        returns the originals."""
        seg, halo = _segment_cut(cfg)
        data = to_device_bytes(data_padded, self.device)
        staged = self.stage(data, input_size, max_steps)
        cc = resolve_compact(self.pt, staged.numel() - TILE, self.compact)
        if cc is None:
            with span("stage:scan.launch"):
                cnt, bits = plan_scan(staged, self.tables, seg_bytes=seg,
                                      halo_bytes=halo)
            return cnt, bits, lambda: (cnt, bits)
        cut, cap = cc
        with span("stage:scan.launch"):
            cnt, bits, count = plan_scan_compact(
                staged, self.tables, cut=cut, cap=cap, seg_bytes=seg,
                halo_bytes=halo)

        def verify():
            global overflow_rescans
            with span("stage:scan.verify"):
                fits = int(count) <= cap
            if fits:
                return cnt, bits
            # the trained estimate was wrong for this input: rescan
            # uncompacted, never truncate
            overflow_rescans += 1
            with span("stage:scan.launch"):
                return plan_scan(staged, self.tables, seg_bytes=seg,
                                 halo_bytes=halo)

        return cnt, bits, verify


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
    """Count-mode plan scan, compacted where ``compact`` resolves to a
    cut.  A compacted scan's total is a truncation when its survivors
    outran the cap: ``check_overflow()`` says so, after the fact, with
    one fetch for all scans since the last check."""

    def __init__(self, shard: ShardTables, max_steps: int, *, device,
                 train=None, pt=None, compact="auto"):
        super().__init__(max_steps)
        self.scanner = PlanShardScanner(shard, device=device, train=train,
                                        pt=pt, compact=compact)
        self.pt = self.scanner.pt
        self._surv_margins = []  # device scalars: count - cap per scan

    def scan(self, staged, input_size, shift, prev_total=None):
        t = self.scanner.tables
        cc = resolve_compact(self.pt, staged.numel() - TILE,
                             self.scanner.compact)
        if cc is None:
            return plan_scan(staged, t, emit="count", shift=shift,
                             prev_total=prev_total)
        cut, cap = cc
        total, count = plan_scan_compact(
            staged, t, cut=cut, cap=cap, emit="count", shift=shift,
            prev_total=prev_total)
        self._surv_margins.append(count - cap)
        return total

    def scan_chain(self, staged, input_size, shift, k: int):
        """``k`` dependent scans: each one's shift parity comes from the
        previous total, read on the device.  Returns the last total; a
        compacted chain records each scan's survivor count for
        ``check_overflow()``."""
        total = torch.zeros(1, dtype=torch.int64, device=staged.device)
        for _ in range(k):
            total = self.scan(staged, input_size, shift, prev_total=total)
        return total

    def check_overflow(self) -> bool:
        """True if any compacted scan since the last check outran its
        cap (that total is then a truncation: rerun the input with
        ``compact=0``).  Reduced on the device, fetched once."""
        margins, self._surv_margins = self._surv_margins, []
        if not margins:
            return False
        return int(torch.stack(margins).max()) > 0


def plan_count_scanner(shard: ShardTables, max_steps: int, *, device,
                       train=None, pt=None,
                       compact="auto") -> PlanCountScan:
    return PlanCountScan(shard, max_steps, device=device, train=train,
                         pt=pt, compact=compact)
