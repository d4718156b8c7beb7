"""Depth scan: the stride-1 PFAC walk over compile.depth's tables.

Replaces the Pallas TPU kernel ``phfpfac_tpu/ops/pallas_depth.py::
_make_depth_kernel``.  One walker per byte offset over the staged byte
stream (ops.staging.stage_input):

* step 0 probes the code-indexed s0 table: ``(disp << 1) | fin``, -1 =
  no depth-1 state (PAD_CHAR 256 lies past its 2 banks and misses);
* step t >= 1 probes ONLY the depth-t table: ``idx = disp + c``; the
  entry verifies ``(g & 255) == c``, bit 8 is the fin bit and ``g >> 9``
  the next displacement; a miss carries DISP_MISS;
* segment mode lets step t read only while
  ``pos + t < min(input_size, seg_end + halo)``.

Same output contract as ops.plan.  ``depth_scan`` is the kernel
wrapper: a CUDA tensor launches ``csrc/depth_scan.cu``, a CPU tensor
runs ``depth_scan_plain``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from phfpfac_tpu_torch.compile.depth import (
    DISP_MISS,
    DepthTables,
    build_depth_tables,
)
from phfpfac_tpu_torch.compile.tables import ShardTables
from phfpfac_tpu_torch.ops.plan import (
    check_operand,
    count_total,
    popcount32,
    probe_banks,
)
from phfpfac_tpu_torch.ops.staging import (
    TILE,
    stage_input,
    staged_rows,
    to_device_bytes,
)

launches = 0  # CUDA kernel launches (the CPU plain path never counts)


@dataclass
class DepthKernelTables:
    """One shard's depth tables as tensors on the scan device."""

    s0: torch.Tensor  # int32 [nb_s0, 128]
    packed: torch.Tensor  # int32 [NB, 128]
    steps: torch.Tensor  # int32 [n_steps - 1, 3]: (off, nb, k0) of T_t
    n_steps: int
    # a dead walker's probe (DISP_MISS + c) lies past every table, so
    # the kernel may stop it: checked here, never assumed
    dead_exit: bool

    @classmethod
    def from_depth(cls, dt: DepthTables, device) -> "DepthKernelTables":
        steps = np.asarray(
            list(zip(dt.offs, dt.nbs, dt.k0s)), np.int32
        ).reshape(-1, 3)
        dead_exit = all(k0 + nb <= DISP_MISS >> 7
                        for k0, nb in zip(dt.k0s, dt.nbs))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        return cls(s0=dev(dt.s0_banks), packed=dev(dt.packed_banks),
                   steps=dev(steps), n_steps=dt.n_steps,
                   dead_exit=dead_exit)


def depth_scan_plain(staged: torch.Tensor, t: DepthKernelTables, *,
                     input_size: int, emit: str = "bitmap",
                     seg_bytes: int = 0, halo_bytes: int = 0, shift=0,
                     prev_total=None):
    """Every step for every position, no early exit."""
    flat = staged.reshape(-1)
    n_pos = flat.shape[0] - TILE
    lim = None
    if seg_bytes:
        pos = torch.arange(n_pos, dtype=torch.int64, device=flat.device)
        lim = torch.clamp(
            (pos // seg_bytes + 1) * seg_bytes + halo_bytes, max=input_size
        ) - pos  # step t reads only while t < lim
    cur = flat[:n_pos].to(torch.int64)
    v = probe_banks(t.s0, cur, 0, t.s0.shape[0], 0)
    alive = v >= 0
    out = (alive & ((v & 1) == 1)).to(torch.int64)
    disp = torch.where(alive, v >> 1, DISP_MISS)
    steps = t.steps.cpu().tolist()
    for s in range(1, t.n_steps):
        off, nb, k0 = steps[s - 1]
        if lim is not None:
            disp = torch.where(s < lim, disp, DISP_MISS)
        cur = flat[s:s + n_pos].to(torch.int64)
        g = probe_banks(t.packed, disp + cur, off, nb, k0)
        hit = (g >= 0) & ((g & 255) == cur)
        fin = hit & ((g & 256) != 0)
        out = out | (fin.to(torch.int64) << s)
        disp = torch.where(hit, g >> 9, DISP_MISS)
    if emit == "count":
        return count_total(out, shift, prev_total)
    return popcount32(out).to(torch.int32), out.to(torch.int32)


def _lib():
    from phfpfac_tpu_torch import _build

    lib = _build.load("depth_scan")
    if lib.depth_scan.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.depth_scan.argtypes = [
            p, i, i, p, i, p, p, i, i, i, i, i, p, p, i, p, p, p,
        ]
        lib.depth_scan.restype = i
    return lib


def _depth_scan_cuda(staged, t, *, input_size, emit, seg_bytes,
                     halo_bytes, shift, prev_total):
    global launches
    dev = staged.device
    for name in ("s0", "packed", "steps"):
        check_operand(getattr(t, name), dev, name)
    check_operand(staged, dev, "staged")
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
    err = _lib().depth_scan(
        staged.data_ptr(), n_pos, int(input_size), t.s0.data_ptr(),
        t.s0.shape[0], t.packed.data_ptr(), t.steps.data_ptr(), t.n_steps,
        int(t.dead_exit), seg_bytes, halo_bytes, int(bitmap),
        None if cnt is None else cnt.data_ptr(),
        None if bits is None else bits.data_ptr(),
        int(shift),
        None if prev_total is None else prev_total.data_ptr(),
        None if total is None else total.data_ptr(),
        stream,
    )
    if err:
        raise RuntimeError(f"depth_scan launch failed: CUDA error {err}")
    launches += 1
    return (cnt, bits) if bitmap else total


def depth_scan(staged: torch.Tensor, t: DepthKernelTables, *,
               input_size: int, emit: str = "bitmap", seg_bytes: int = 0,
               halo_bytes: int = 0, shift=0, prev_total=None):
    """Depth walk over a staged byte stream; outputs as ops.plan.plan_scan
    (any positive ``seg_bytes``, not only powers of two)."""
    if emit not in ("bitmap", "count"):
        raise ValueError(f"emit must be 'bitmap' or 'count', got {emit!r}")
    kw = dict(input_size=input_size, emit=emit, seg_bytes=seg_bytes,
              halo_bytes=halo_bytes, shift=shift, prev_total=prev_total)
    if staged.device.type == "cpu":
        return depth_scan_plain(staged, t, **kw)
    if staged.device.type != "cuda":
        raise ValueError(f"no depth kernel for device {staged.device}")
    return _depth_scan_cuda(staged, t, **kw)


class DepthShardScanner:
    """Bitmap-mode depth scanner for one shard.

    Raises compile.depth.DepthUnsupported at construction when the
    shard's automaton cannot be stratified (deeper than the bitmap)."""

    def __init__(self, shard: ShardTables, *, device):
        self.dt: DepthTables = build_depth_tables(shard)
        self.shard = shard
        self.device = torch.device(device)
        self.tables = DepthKernelTables.from_depth(self.dt, self.device)

    def stage(self, data: torch.Tensor, input_size: int,
              max_steps: int) -> torch.Tensor:
        n_pos = data.shape[0] - max_steps
        return stage_input(data, input_size, n_rows=staged_rows(n_pos))

    def scan(self, data_padded, input_size, cfg, max_steps):
        """(per-position counts, per-position bitmaps) on the device."""
        seg = cfg.segment_bytes if cfg.truncation == "segment" else 0
        data = to_device_bytes(data_padded, self.device)
        return depth_scan(self.stage(data, input_size, max_steps),
                          self.tables, input_size=input_size,
                          seg_bytes=seg, halo_bytes=cfg.halo_bytes)
