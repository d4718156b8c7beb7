"""The bitmap kernels over a device mesh: the fast multi-device scan.

The counterpart of the JAX package's ``parallel/mesh_pallas.py``
(``shard_map`` around the Pallas kernels).  ``parallel.mesh`` runs the
torch-op turbo engine per mesh cell; this module launches the
hand-written kernels per cell instead, over the same two axes:

* ``data``     — the staged corpus (``ops.staging``, one int32 per
  position) is cut into equal blocks; a cell scans its block followed by
  the first 1024 staged positions of its right neighbour (the 8-row halo
  the JAX package moves with ``ppermute``: a walk reads at most
  ``max_pat_len - 1`` positions past its block).  The last cell's halo is
  what lies past the input's end: the pad char for the depth kernel, the
  dead pair symbol ``(sigma << cb) | sigma`` for the plan kernel.  The
  corpus is staged once, on the mesh's first device, so a cell's input
  is a window of that tensor, copied to the cell's device where that is
  another one.
* ``patterns`` — a cell scans with the tables of its column's shard.

``PallasMeshMatcher`` runs the depth kernel (K2, exact mode only) on the
JAX package's stacked depth tables.  ``PlanMeshMatcher`` runs the plan
kernel (K1), or with a compaction cut the two-phase pair (K1' then K6)
per cell, in exact and in segment mode: per-cell blocks start on segment
boundaries, so the kernel's position-local cut equals the single-device
one.  Output: per shard and cell a per-position int32 bitmap, fetched
with ``ops.bitmap.fetch_hit_bits`` and decoded and merged as on one
device.

Every cell's staging, launches and fetch run with the cell's device
current (``parallel.mesh.on_device``), and every cell is dispatched
before any is fetched.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from phfpfac_tpu_torch.compile.depth import (
    DepthTables,
    DepthUnsupported,
    build_depth_tables,
)
from phfpfac_tpu_torch.compile.pair import PairUnsupported
from phfpfac_tpu_torch.compile.plan import (
    PlanTables,
    StackedPlanTables,
    build_plan_tables,
    build_stacked_plan_tables,
)
from phfpfac_tpu_torch.compile.tables import CompiledDictionary
from phfpfac_tpu_torch.ops import plan as plan_ops
from phfpfac_tpu_torch.ops.bitmap import decode_hits, fetch_hit_bits
from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
from phfpfac_tpu_torch.ops.depth import DepthKernelTables, depth_scan
from phfpfac_tpu_torch.ops.staging import (
    TILE,
    stage_input,
    stage_pairs,
    staged_rows,
    to_device_bytes,
)
from phfpfac_tpu_torch.parallel.merge import merge_flat_matches
from phfpfac_tpu_torch.parallel.mesh import DeviceMesh, on_device


@dataclass
class StackedDepthTables:
    """All shards' depth tables with uniform static geometry: per-depth
    bank counts padded to the max across shards (probes into the -1
    padding miss), no trimming (k0 = 0 everywhere), shallower shards
    with empty tables up to the deepest shard's step count."""

    s0: np.ndarray  # int32 [S, 2, 128]
    packed: np.ndarray  # int32 [S, NB, 128]
    offs: tuple
    nbs: tuple
    n_steps: int

    @property
    def num_shards(self) -> int:
        return self.s0.shape[0]


def stack_depth_tables(compiled: CompiledDictionary) -> StackedDepthTables:
    """Raises compile.depth.DepthUnsupported when any shard cannot."""
    dts: list[DepthTables] = [
        build_depth_tables(sh, trim=False) for sh in compiled.shards
    ]
    n_steps = max(dt.n_steps for dt in dts)
    # per-step bank counts padded to the max across shards
    nbs = tuple(
        max(
            (dt.nbs[t] if t < len(dt.nbs) else 1)
            for dt in dts
        )
        for t in range(n_steps - 1)
    )
    offs, acc = [], 0
    for nb in nbs:
        offs.append(acc)
        acc += nb
    packed = np.full((len(dts), acc, 128), -1, dtype=np.int32)
    for s, dt in enumerate(dts):
        for t in range(len(dt.nbs)):
            src = dt.packed_banks[dt.offs[t] : dt.offs[t] + dt.nbs[t]]
            packed[s, offs[t] : offs[t] + src.shape[0]] = src
    s0 = np.stack([dt.s0_banks for dt in dts])
    return StackedDepthTables(
        s0=s0, packed=packed, offs=tuple(offs), nbs=nbs, n_steps=n_steps
    )


def stacked_depth_shard(st: StackedDepthTables, s: int) -> DepthTables:
    """Shard ``s`` of the stack as one shard's DepthTables."""
    return DepthTables(
        s0_banks=st.s0[s], packed_banks=st.packed[s], offs=st.offs,
        nbs=st.nbs, k0s=(0,) * len(st.nbs), n_steps=st.n_steps,
        max_pat_len=st.n_steps, num_final=0,
    )


def stacked_plan_shard(st: StackedPlanTables, s: int) -> PlanTables:
    """Shard ``s`` of the stack as one shard's PlanTables: its own bank
    arrays under the stack's shared coding and step list."""
    return PlanTables(
        code_of=st.code_of, code_bits=st.code_bits, p0_mode=st.p0_mode,
        p0_banks=st.p0_banks[s], packed_banks=st.packed_banks[s],
        side_banks=st.side_banks[s], steps=st.steps, p0_miss=st.p0_miss,
        max_pat_len=st.max_pat_len, trained=st.trained,
        live_frac=st.live_frac,
    )


def _cell_window(staged: torch.Tensor, d: int, block: int,
                 dev: torch.device) -> torch.Tensor:
    """Data cell ``d``'s block of the flat staged stream plus its
    1024-position right halo, on ``dev``."""
    flat = staged.reshape(-1)
    return flat[d * block:(d + 1) * block + TILE].to(dev)


def _fetch_cells(cells, block: int, input_size: int):
    """(hit positions, their bitmaps) of one shard from its per-cell
    bitmaps, data-major."""
    pos_parts, hb_parts = [], []
    for d, bits in enumerate(cells):
        n = min(max(input_size - d * block, 0), block)
        with on_device(bits.device):
            pos, hb = fetch_hit_bits(bits, n)
        pos_parts.append(pos + d * block)
        hb_parts.append(hb)
    return np.concatenate(pos_parts), np.concatenate(hb_parts)


class PallasMeshMatcher:
    """Mesh-parallel matcher on the depth kernel (exact mode).

    Raises DepthUnsupported at construction when the dictionary cannot
    use depth tables, or under the segment cut (segment runs ride the
    plan mesh or the turbo mesh).
    """

    def __init__(self, compiled: CompiledDictionary, config,
                 mesh: DeviceMesh):
        if config.truncation == "segment":
            raise DepthUnsupported("segment truncation needs the turbo mesh")
        self.compiled = compiled
        self.config = config
        self.mesh = mesh
        self.stacked = stack_depth_tables(compiled)
        n_pat = mesh.shape["patterns"]
        if self.stacked.num_shards != n_pat:
            raise ValueError(
                f"{self.stacked.num_shards} shards != patterns axis {n_pat}"
            )
        self._on = {}  # (shard, device) -> DepthKernelTables

    def _tables_on(self, s: int, dev: torch.device) -> DepthKernelTables:
        if (s, dev) not in self._on:
            self._on[s, dev] = DepthKernelTables.from_depth(
                stacked_depth_shard(self.stacked, s), dev)
        return self._on[s, dev]

    def match(self, data: bytes, *, input_size: int | None = None):
        """Flat [(position, global pattern id)] in reference order."""
        if input_size is None:
            input_size = len(data)
        max_steps = padded_steps(self.compiled.max_pat_len)
        n_data = self.mesh.shape["data"]
        padded = pad_input(data, 1024 * n_data, max_steps)
        n_pos = len(padded) - max_steps
        block = n_pos // n_data
        dev0 = self.mesh.device(0, 0)
        with on_device(dev0):
            # the spare block past n_pos holds the pad char: it is the
            # last cell's halo
            staged = stage_input(
                to_device_bytes(padded[:n_pos], dev0), input_size,
                n_rows=staged_rows(n_pos))
        per_shard = []
        for s in range(self.stacked.num_shards):
            cells = []
            for d in range(n_data):
                dev = self.mesh.device(d, s)
                with on_device(dev):
                    _cnt, bits = depth_scan(
                        _cell_window(staged, d, block, dev),
                        self._tables_on(s, dev),
                        input_size=2**31 - 1,  # the pad char is the bound
                    )
                cells.append(bits)
            per_shard.append(cells)
        flats = []
        for shard, cells in zip(self.compiled.shards, per_shard):
            pos, hb = _fetch_cells(cells, block, input_size)
            flats.append(
                decode_hits(hb, pos, data, input_size, shard, max_steps)
            )
        return merge_flat_matches(self.compiled, flats, input_size)


class PlanMeshMatcher:
    """Mesh matcher on the plan kernel, exact or segment mode.

    With ``patterns`` axis == shard count the shards ride that axis on
    the stacked uniform-geometry tables
    (``compile.plan.build_stacked_plan_tables``; every cell reads its
    own shard's slice).  Otherwise, or where the stacked build refuses,
    shards loop on the host, each with its own tables, its scan
    data-parallel over the cells of one column (shard ``i`` on column
    ``i mod patterns``).

    ``train`` shapes the profile-guided table layout exactly as on one
    device.  ``compact``: as ``ops.plan.resolve_compact``, resolved
    against the PER-CELL position count; when any cell's true survivor
    count outruns the cap, the whole scan runs again uncompacted.
    """

    def __init__(self, compiled: CompiledDictionary, config,
                 mesh: DeviceMesh, *, train: bytes | None = None,
                 compact="auto"):
        self.compact = compact
        if config.truncation == "segment" and (
            config.segment_bytes & (config.segment_bytes - 1)
        ):
            # the in-kernel positional cut needs a power-of-two segment
            raise PairUnsupported("segment size must be a power of 2")
        self.compiled = compiled
        self.config = config
        self.mesh = mesh
        self.stacked = None
        n_pat = mesh.shape["patterns"]
        if n_pat > 1 and n_pat == len(compiled.shards):
            try:
                self.stacked = build_stacked_plan_tables(
                    compiled.shards, train=train
                )
            except PairUnsupported:
                self.stacked = None  # host shard loop below
        self.pts = None
        if self.stacked is None:
            self.pts = [
                build_plan_tables(sh, train=train)
                for sh in compiled.shards
            ]
            self._shard_pts = self.pts
        else:
            self._shard_pts = [
                stacked_plan_shard(self.stacked, s)
                for s in range(self.stacked.num_shards)
            ]
        self._on = {}  # (shard, device) -> PlanKernelTables

    def _tables_on(self, s: int, dev: torch.device):
        if (s, dev) not in self._on:
            self._on[s, dev] = plan_ops.PlanKernelTables.from_plan(
                self._shard_pts[s], dev)
        return self._on[s, dev]

    def _scan_group(self, staged, shards, block, cc, seg, halo):
        """Dispatch the scan of ``shards`` (a list of (shard, column))
        over one staged stream on every data cell.  -> per shard its
        cells' bitmaps, and every cell's survivor count (device scalars;
        empty when uncompacted)."""
        per_shard, counts = [], []
        for s, p in shards:
            cells = []
            for d in range(self.mesh.shape["data"]):
                dev = self.mesh.device(d, p)
                with on_device(dev):
                    local = _cell_window(staged, d, block, dev)
                    t = self._tables_on(s, dev)
                    if cc is None:
                        _cnt, bits = plan_ops.plan_scan(
                            local, t, seg_bytes=seg, halo_bytes=halo)
                    else:
                        _cnt, bits, count = plan_ops.plan_scan_compact(
                            local, t, cut=cc[0], cap=cc[1], seg_bytes=seg,
                            halo_bytes=halo)
                        counts.append(count)
                cells.append(bits)
            per_shard.append(cells)
        return per_shard, counts

    def _scan_checked(self, staged, shards, block, cc, seg, halo):
        """``_scan_group``; a compacted scan any of whose cells outran
        the cap runs again uncompacted, all of it."""
        per_shard, counts = self._scan_group(staged, shards, block, cc, seg,
                                             halo)
        if cc is not None and max(int(c) for c in counts) > cc[1]:
            plan_ops.overflow_rescans += 1
            per_shard, _ = self._scan_group(staged, shards, block, None,
                                            seg, halo)
        return per_shard

    def match(self, data: bytes, *, input_size: int | None = None):
        """Flat [(position, global pattern id)] in reference order."""
        if input_size is None:
            input_size = len(data)
        max_steps = padded_steps(self.compiled.max_pat_len)
        n_data = self.mesh.shape["data"]
        n_pat = self.mesh.shape["patterns"]
        seg, halo = 0, 0
        pad_to = 1024 * n_data
        if self.config.truncation == "segment":
            # per-cell blocks must start ON segment boundaries so that
            # the kernel's cell-local position arithmetic computes the
            # same cut limits as a single-device scan (the limit depends
            # only on pos mod segment)
            seg = self.config.segment_bytes
            halo = self.config.halo_bytes
            pad_to = n_data * max(1024, seg)
        padded = pad_input(data, pad_to, max_steps)
        n_pos = len(padded) - max_steps
        block = n_pos // n_data  # survivors compact per cell: cut and
        # cap resolve against the PER-CELL position count
        dev0 = self.mesh.device(0, 0)
        with on_device(dev0):
            corpus = to_device_bytes(padded[:n_pos], dev0)

        def stage(pt):
            # past the input's end every code is the miss code, so the
            # spare block past n_pos, the last cell's halo, holds the
            # dead pair symbol (sigma << cb) | sigma
            with on_device(dev0):
                code_of = torch.from_numpy(
                    np.ascontiguousarray(pt.code_of, np.int32)).to(dev0)
                return stage_pairs(corpus, input_size, code_of,
                                   n_rows=staged_rows(n_pos),
                                   cb=pt.code_bits)

        n_shards = len(self.compiled.shards)
        if self.stacked is not None:
            cc = plan_ops.resolve_compact(self.stacked, block, self.compact)
            per_shard = self._scan_checked(
                stage(self.stacked), [(s, s) for s in range(n_shards)],
                block, cc, seg, halo)
        else:
            per_shard = []
            for s, pt in enumerate(self.pts):
                cc = plan_ops.resolve_compact(pt, block, self.compact)
                per_shard += self._scan_checked(
                    stage(pt), [(s, s % n_pat)], block, cc, seg, halo)
        flats = []
        for shard, cells in zip(self.compiled.shards, per_shard):
            pos, hb = _fetch_cells(cells, block, input_size)
            flats.append(
                decode_hits(hb, pos, data, input_size, shard, max_steps)
            )
        return merge_flat_matches(self.compiled, flats, input_size)
