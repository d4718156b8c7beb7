"""Multi-device PFAC runtime: a ("data", "patterns") mesh of devices,
driven by one process.

The counterpart of the JAX package's ``parallel/mesh.py``.  The
reference scales out with OpenMP threads pinning CUDA devices and
pattern-set sharding (main.cc:180-241); the JAX package runs one SPMD
program under ``shard_map``.  Here one process drives every cell of the
mesh in turn (kernel launches and torch ops are asynchronous, so the
cells' work overlaps on their devices):

* axis ``patterns`` — dictionary shards: a cell scans with the tables of
  its column's shards;
* axis ``data``     — the input byte stream in contiguous blocks.  Walks
  that start near a block's end read into the next block, so each cell
  gets the first ``max_steps`` bytes of its right neighbour's block,
  copied device to device (the JAX package's ``ppermute``; the last cell
  wraps to cell 0's head exactly as it does there, and ``input_size``
  kills those walks).

The per-cell computation is ``ops.turbo.scan_core`` with
``pos0 = data_index * block``, so the global segment cut and the input
bound hold whatever the mesh shape.  The host merge is the
single-device one.

A mesh is an explicit grid of devices.  ``make_mesh(n_data, n_patterns)``
takes every visible CUDA device; a caller may pass a list in which one
device appears more than once, which is how one card (or the CPU)
carries a whole mesh.  Nothing picks a device the caller did not name.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from phfpfac_tpu_torch.compile.tables import CompiledDictionary
from phfpfac_tpu_torch.ops.common import (
    pad_input,
    padded_steps,
    walk_limits,
)
from phfpfac_tpu_torch.ops.reference import scan_shard
from phfpfac_tpu_torch.ops.turbo import build_turbo_tables, scan_core
from phfpfac_tpu_torch.parallel.merge import merge_flat_matches
from phfpfac_tpu_torch.utils.config import PfacConfig


@dataclass
class StackedTables:
    """All shards' turbo tables padded to common shapes and stacked.

    The JAX package needs this for SPMD (every cell runs one program, so
    per-shard tables must share shapes); the port keeps the layout so
    that both scan the same arrays.  Padding is semantics-free: ``r``
    pads with 0 (points at the guard band), probe tables pad with -1
    (never verify as a hit).
    """

    s0: np.ndarray  # int32 [S, 256]
    r: np.ndarray  # int32 [S, R]
    tbl_a: np.ndarray  # int32 [S, A]  (packed or ht)
    tbl_b: np.ndarray  # int32 [S, B]  (val or width-1 dummy)
    width_bit: np.ndarray  # int32 [S]
    row_bits: np.ndarray  # int32 [S]
    dead: np.ndarray  # int32 [S]
    num_final: np.ndarray  # int32 [S]
    is_packed: bool
    max_pat_len: int

    @property
    def num_shards(self) -> int:
        return self.s0.shape[0]


def stack_tables(compiled: CompiledDictionary) -> StackedTables:
    tts = [build_turbo_tables(sh) for sh in compiled.shards]
    is_packed = all(t.is_packed for t in tts)

    def pad_stack(arrs: list[np.ndarray], fill: int) -> np.ndarray:
        width = max(len(a) for a in arrs)
        out = np.full((len(arrs), width), fill, dtype=np.int32)
        for i, a in enumerate(arrs):
            out[i, : len(a)] = a
        return out

    if is_packed:
        tbl_a = pad_stack([t.packed for t in tts], -1)
        tbl_b = np.zeros((len(tts), 1), dtype=np.int32)
    else:
        # force the split representation for every shard
        hts, vals = [], []
        for sh, t in zip(compiled.shards, tts):
            if t.is_packed:
                w = sh.width
                g = np.full(w + len(sh.ht) + w, -1, dtype=np.int32)
                g[w : w + len(sh.ht)] = sh.ht
                hts.append(g)
                g2 = np.full(w + len(sh.val) + w, -1, dtype=np.int32)
                g2[w : w + len(sh.val)] = sh.val
                vals.append(g2)
            else:
                hts.append(t.ht)
                vals.append(t.val)
        tbl_a = pad_stack(hts, -1)
        tbl_b = pad_stack(vals, -1)

    return StackedTables(
        s0=np.stack([t.s0 for t in tts]),
        r=pad_stack([t.r for t in tts], 0),
        tbl_a=tbl_a,
        tbl_b=tbl_b,
        width_bit=np.array([t.width_bit for t in tts], np.int32),
        row_bits=np.array([t.row_bits for t in tts], np.int32),
        dead=np.array([t.dead for t in tts], np.int32),
        num_final=np.array([t.num_final for t in tts], np.int32),
        is_packed=is_packed,
        max_pat_len=compiled.max_pat_len,
    )


class DeviceMesh:
    """A (data, patterns) grid of ``torch.device``s; ``shape["data"]``,
    ``shape["patterns"]`` and ``device(d, p)``."""

    def __init__(self, grid: list[list[torch.device]]):
        self.grid = grid
        self.shape = {"data": len(grid), "patterns": len(grid[0])}

    def device(self, d: int, p: int = 0) -> torch.device:
        return self.grid[d][p]

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {self.grid})"


def make_mesh(n_data: int, n_patterns: int, devices=None) -> DeviceMesh:
    """The first ``n_data * n_patterns`` of ``devices`` (default: every
    visible CUDA device) as a row-major (data, patterns) grid."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = n_data * n_patterns
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return DeviceMesh([
        devices[d * n_patterns : (d + 1) * n_patterns] for d in range(n_data)
    ])


def on_device(dev: torch.device):
    """Context that makes ``dev`` the current CUDA device (the kernels
    launch on the current stream of their tensors' device, and torch
    allocates there); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def mesh_blocks(mesh: DeviceMesh, corpus: torch.Tensor, block: int,
                halo: int) -> list[list[torch.Tensor]]:
    """Per cell ``[d][p]`` its block of ``corpus`` (a host tensor of
    ``n_data * block`` elements) followed by the first ``halo`` elements
    of the right neighbour's block, on the cell's device.  A block goes
    up once per device that holds a cell of its row; the halo is copied
    from the neighbour's device."""
    n_data, n_pat = mesh.shape["data"], mesh.shape["patterns"]
    own = []
    for d in range(n_data):
        by_dev = {}
        row = []
        for p in range(n_pat):
            dev = mesh.device(d, p)
            if dev not in by_dev:
                by_dev[dev] = corpus[d * block:(d + 1) * block].to(dev)
            row.append(by_dev[dev])
        own.append(row)
    ext = []
    for d in range(n_data):
        by_dev = {}  # cells of this row that share a device share a copy
        row = []
        for p in range(n_pat):
            dev = mesh.device(d, p)
            if dev not in by_dev:
                with on_device(dev):
                    head = own[(d + 1) % n_data][p][:halo].to(dev)
                    by_dev[dev] = torch.cat([own[d][p], head])
            row.append(by_dev[dev])
        ext.append(row)
    return ext


def _distributed_scan(
    mesh: DeviceMesh,
    blocks: list,  # mesh_blocks(...) of the corpus: n_data blocks + halos
    block: int,  # positions per data cell
    st: StackedTables,
    shard: int,
    input_size: int,  # global
    seg_bytes: int,
    halo_bytes: int,
    *,
    tables_on,  # (shard, device) -> (s0, r, tbl_a, tbl_b) tensors there
    max_steps: int,
    full_steps: int,
    cap: int,
    emit_counts: bool,
):
    """One shard's scan on every data cell of its patterns column: a
    list, per data index, of ``scan_core``'s (full, cnt, tail, tail_pos,
    tail_cnt, overflow) on that cell's device.  Dispatch only."""
    n_data, n_pat = mesh.shape["data"], mesh.shape["patterns"]
    p = shard // (st.num_shards // n_pat)  # the column that holds it
    outs = []
    for d in range(n_data):
        dev = mesh.device(d, p)
        with on_device(dev):
            outs.append(scan_core(
                blocks[d][p], d * block, *tables_on(shard, dev),
                int(input_size), int(st.width_bit[shard]),
                int(st.row_bits[shard]), int(st.dead[shard]),
                int(st.num_final[shard]), seg_bytes, halo_bytes,
                max_steps=max_steps, full_steps=full_steps, cap=cap,
                emit_counts=emit_counts,
            ))
    return outs


class DistributedMatcher:
    """Mesh-parallel matcher: data-sharded input x pattern-sharded tables.

    ``compiled.num_shards`` must be a multiple of the mesh's
    ``patterns`` axis size.
    """

    def __init__(
        self,
        compiled: CompiledDictionary,
        config: PfacConfig,
        mesh: DeviceMesh,
        *,
        full_steps: int = 2,
        cap_frac: int = 8,
    ):
        self.compiled = compiled
        self.config = config
        self.mesh = mesh
        self.full_steps = full_steps
        self.cap_frac = cap_frac
        self.stacked = stack_tables(compiled)
        n_pat = mesh.shape["patterns"]
        if self.stacked.num_shards % n_pat:
            raise ValueError(
                f"{self.stacked.num_shards} shards not divisible by "
                f"patterns axis {n_pat}"
            )
        self.shards_per_cell = self.stacked.num_shards // n_pat
        self._on = {}  # (shard, device) -> its table tensors there

    def _tables_on(self, shard: int, dev: torch.device) -> tuple:
        """(s0, r, tbl_a, tbl_b) of one shard as int32 tensors on
        ``dev``, uploaded once; tbl_b is None for packed tables."""
        if (shard, dev) not in self._on:
            st = self.stacked

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a[shard])).to(
                    dev)

            self._on[shard, dev] = (
                up(st.s0), up(st.r), up(st.tbl_a),
                None if st.is_packed else up(st.tbl_b))
        return self._on[shard, dev]

    def _geometry(self, data: bytes):
        max_steps = padded_steps(self.compiled.max_pat_len)
        n_data = self.mesh.shape["data"]
        padded = pad_input(data, 1024 * n_data, max_steps)
        n_pos = len(padded) - max_steps
        block = n_pos // n_data
        cap = max(-(-block // self.cap_frac), 128)
        return padded[:n_pos], max_steps, block, cap

    def _scan_shards(self, data: bytes, input_size: int, emit_counts: bool):
        """Yields (shard, per-data-cell scan_core results, block, cap,
        max_steps), one shard at a time: a shard's row buffers are
        dropped before the next shard's are made."""
        body, max_steps, block, cap = self._geometry(data)
        blocks = mesh_blocks(self.mesh, torch.from_numpy(body), block,
                             max_steps)
        seg = (self.config.segment_bytes
               if self.config.truncation == "segment" else 0)
        for s in range(self.stacked.num_shards):
            outs = _distributed_scan(
                self.mesh, blocks, block, self.stacked, s, input_size, seg,
                self.config.halo_bytes, tables_on=self._tables_on,
                max_steps=max_steps, full_steps=self.full_steps, cap=cap,
                emit_counts=emit_counts,
            )
            yield s, outs, block, cap, max_steps

    def match(self, data: bytes, *, input_size: int | None = None) -> np.ndarray:
        """Flat [(position, global pattern id)] in reference output order."""
        if input_size is None:
            input_size = len(data)
        flats: list[np.ndarray] = []
        for s, outs, block, cap, max_steps in self._scan_shards(
                data, input_size, emit_counts=False):
            t0 = min(self.full_steps + 1, max_steps)
            # hits are found on each cell's device; only they come down
            found = []
            for d, (full, _cnt, tail, tail_pos, _tc, ovf) in enumerate(outs):
                t_idx, p_idx = torch.nonzero(full >= 0, as_tuple=True)
                f_hits = torch.stack(
                    [p_idx + d * block, t_idx,
                     full[t_idx, p_idx].to(torch.int64)], dim=1)
                t_idx, j_idx = torch.nonzero(tail >= 0, as_tuple=True)
                # j indexes the data-major [n_data * cap] tail slots
                t_hits = torch.stack(
                    [j_idx + d * cap, t_idx,
                     tail[t_idx, j_idx].to(torch.int64),
                     tail_pos[j_idx].to(torch.int64)], dim=1)
                found.append((f_hits, t_hits, ovf))
            del outs
            if any(bool(ovf) for _f, _t, ovf in found):
                flats.append(self._dense_fallback(s, data, input_size))
                continue
            parts = []
            for f_hits, t_hits, _ovf in found:
                if f_hits.shape[0]:
                    parts.append(f_hits.cpu().numpy())
                if t_hits.shape[0]:
                    th = t_hits.cpu().numpy()
                    j_idx = th[:, 0]
                    gpos = th[:, 3] + (j_idx // cap) * block
                    parts.append(
                        np.stack([gpos, th[:, 1] + t0, th[:, 2]], axis=1))
            if parts:
                m = np.concatenate(parts).astype(np.int64)
                m = m[np.lexsort((m[:, 1], m[:, 0]))]
                flats.append(m)
            else:
                flats.append(np.empty((0, 3), dtype=np.int64))
        return merge_flat_matches(self.compiled, flats, input_size)

    def count_matches(self, data: bytes, *, input_size: int | None = None):
        if input_size is None:
            input_size = len(data)
        total = None
        for s, outs, block, cap, _ms in self._scan_shards(
                data, input_size, emit_counts=True):
            if total is None:
                total = np.zeros(block * len(outs), dtype=np.int64)
            if any(bool(o[5]) for o in outs):
                m = self._dense_fallback(s, data, input_size)
                np.add.at(total, m[:, 0], 1)
                continue
            cnt = np.concatenate(
                [o[1].cpu().numpy() for o in outs]).astype(np.int64)
            tail_pos = np.concatenate([o[3].cpu().numpy() for o in outs])
            tail_cnt = np.concatenate([o[4].cpu().numpy() for o in outs])
            total += cnt
            gpos = tail_pos + (np.arange(len(tail_pos)) // cap) * block
            np.add.at(total, gpos, tail_cnt)
        return total[:input_size]

    def _dense_fallback(self, s: int, data: bytes, input_size: int) -> np.ndarray:
        """The whole input again with the dense engine, for a shard whose
        survivors outran ``cap`` on some cell; on the mesh's first
        device."""
        from phfpfac_tpu_torch.parallel.matcher import _dense_slots

        shard = self.compiled.shards[s]
        max_steps = padded_steps(self.compiled.max_pat_len)
        padded = pad_input(data, 1024, max_steps)
        n_pos = len(padded) - max_steps
        limits = walk_limits(n_pos, input_size, shard.max_pat_len, self.config)
        dev = self.mesh.device(0, 0)
        with on_device(dev):
            out, _ = scan_shard(
                shard, padded, limits, input_size,
                slots=_dense_slots(shard), device=dev,
            )
            p, j = torch.nonzero(out >= 0, as_tuple=True)
            rows = torch.stack([p, j, out[p, j].to(torch.int64)], dim=1)
        return rows.cpu().numpy().astype(np.int64)
