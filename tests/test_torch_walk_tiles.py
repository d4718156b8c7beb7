"""The depth and pair kernels' host side: pre-decoded step descriptors,
the warp-tile geometry and the staged stream's demands
(phfpfac_tpu_torch.ops.depth, ops.pair).

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
holds them to the plain versions at tile edges, on deep lists, with
dead_exit off and on mesh-cell views); what the host hands them is checked
here, on the CPU: the descriptor probe equals ``probe_banks`` for every
step of every dictionary below (exact), on a shard's own tables (leading
banks trimmed) and on the mesh's stacked tables (none trimmed); the
sources' tile constants keep every warp tile whole and the deepest window
inside the tile's copy; and both wrappers refuse a stream the kernels
cannot read.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_plan_tiles import _indices, desc_probe

from phfpfac_tpu_torch.compile.depth import MAX_DEPTH_STEPS, build_depth_tables
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import depth as tdepth
from phfpfac_tpu_torch.ops import pair as tpair
from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
from phfpfac_tpu_torch.ops.plan import probe_banks
from phfpfac_tpu_torch.ops.staging import LANE, TILE, to_device_bytes
from phfpfac_tpu_torch.parallel.mesh_pallas import (
    stack_depth_tables,
    stacked_depth_shard,
)
from phfpfac_tpu_torch.utils.config import PfacConfig

CSRC = Path(tdepth.__file__).resolve().parent.parent / "csrc"


def _words(alphabet: bytes, count: int, longest: int, seed: int):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return list(dict.fromkeys(
        bytes(a[rng.integers(0, len(a), int(rng.integers(1, longest + 1)))])
        for _ in range(count)))


def _deep():
    rng = np.random.default_rng(5)
    pat = bytes(rng.integers(97, 123, 32, dtype=np.uint8))
    return [pat[i:] + pat[:i] for i in range(32)] + _words(
        b"abcdefghijklmnopqrstuvwxyz", 300, 8, 6)


# alphabets of 4, 7, 12, 36 symbols (code bits 3, 4, 4, 6: nibble and byte
# side tables), raw bytes, and 32-byte patterns (every step)
DICTS = {
    "abcd": lambda: _words(b"abcd", 400, 15, 0),
    "abcdefg": lambda: _words(b"abcdefg", 600, 15, 1),
    "dense": lambda: _words(b"abcdefghijkl", 800, 15, 2),
    "lower": lambda: _words(b"abcdefghijklmnopqrstuvwxyz0123456789", 3000,
                            32, 3),
    "bytes": lambda: [bytes(np.random.default_rng(7).integers(
        0, 256, 40000, dtype=np.uint8))[i:i + 3 + i % 20]
        for i in range(0, 40000, 40)],
    "deep": _deep,
}
PAIR_DICTS = [n for n in DICTS if n != "bytes"]  # over 63 symbols: refused
_cache: dict = {}


def _compiled(name, shards=2):
    key = (name, shards)
    if key not in _cache:
        words = DICTS[name]()
        _cache[key] = compile_patterns(
            [Pattern(i + 1, w) for i, w in enumerate(words)],
            PfacConfig(width=4096, num_shards=shards))
    return _cache[key]


def _depth_tables(name, layout):
    """Every shard's depth kernel tables: each shard's own, or the
    mesh's stacked tables (one step geometry for all shards)."""
    comp = _compiled(name)
    if layout == "own":
        dts = [build_depth_tables(sh) for sh in comp.shards]
    else:
        st = stack_depth_tables(comp)
        dts = [stacked_depth_shard(st, s) for s in range(st.num_shards)]
    return [tdepth.DepthKernelTables.from_depth(dt, "cpu") for dt in dts]


def _pair_tables(name):
    return [tpair.PairKernelTables.from_pair(
        tpair.build_pair_tables(sh), "cpu") for sh in _compiled(name).shards]


@pytest.mark.parametrize("layout", ["own", "stacked"])
@pytest.mark.parametrize("name", list(DICTS))
def test_depth_descriptor_probe_equals_probe_banks(name, layout):
    checked = 0
    for kt in _depth_tables(name, layout):
        assert kt.desc.shape == (kt.n_steps - 1,
                                 len(tdepth.DEPTH_DESC_FIELDS))
        for (off, nb, k0), row in zip(kt.steps.tolist(), kt.desc.tolist()):
            d = dict(zip(tdepth.DEPTH_DESC_FIELDS, row))
            idx = _indices(d["lo"], d["span"])
            assert torch.equal(
                desc_probe(kt.packed, idx, d["base"], d["lo"], d["span"]),
                probe_banks(kt.packed, idx, off, nb, k0))
            checked += 1
        # s0: base 0, lo 0, span = all of it; PAD_CHAR 256 misses
        span = kt.s0.shape[0] * LANE
        idx = _indices(0, span)
        assert torch.equal(desc_probe(kt.s0, idx, 0, 0, span),
                           probe_banks(kt.s0, idx, 0, kt.s0.shape[0], 0))
        assert int(desc_probe(kt.s0, torch.tensor([256]), 0, 0, span)) == -1
    assert checked > 0


@pytest.mark.parametrize("name", PAIR_DICTS)
def test_pair_descriptor_probe_equals_probe_banks(name):
    checked, layouts = 0, set()
    for kt in _pair_tables(name):
        assert kt.desc.shape == (kt.n_pair_steps - 1,
                                 len(tpair.PAIR_DESC_FIELDS))
        for (po, pn, pk0, so, sn, sk0, nib), row in zip(kt.step_rows,
                                                        kt.desc.tolist()):
            d = dict(zip(tpair.PAIR_DESC_FIELDS, row))
            for banks, geom, ops in (
                    (kt.packed, (po, pn, pk0), (d["base"], d["lo"],
                                                d["span"])),
                    (kt.side, (so, sn, sk0), (d["s_base"], d["s_lo"],
                                              d["s_span"]))):
                idx = _indices(ops[1], ops[2])
                assert torch.equal(desc_probe(banks, idx, *ops),
                                   probe_banks(banks, idx, *geom))
                checked += 1
            # the side word and field: sidx >> wsh, then the field of
            # sidx's slot against (a1 & amask) + 1, as pair_scan_plain
            per_word = 8 if nib else 4
            assert 1 << d["wsh"] == per_word
            assert d["smask"] == per_word - 1
            assert (1 << d["fsh"]) * per_word == 32
            assert d["fmask"] == (1 << (32 // per_word)) - 1
            assert d["amask"] == (7 if nib else 0xFFFFFFFF)
            layouts.add(nib)
    assert checked > 0
    if name in ("lower", "deep"):
        assert layouts == {0, 1}  # byte and nibble side tables


@pytest.mark.parametrize("name", ["dense", "deep"])
def test_descriptors_are_built_once_with_the_tables(name):
    for kt in _depth_tables(name, "own"):
        want = tdepth.depth_descriptors(kt.steps.numpy())
        assert kt.desc.dtype == np.uint32 and np.array_equal(kt.desc, want)
        assert not kt.desc.flags.writeable
        off, nb, k0 = kt.steps.numpy().T.astype(np.int64)
        assert np.array_equal(kt.desc.astype(np.int64),
                              np.stack([off, k0, nb], 1) * 128)
    for kt in _pair_tables(name):
        want = tpair.pair_descriptors(kt.step_rows)
        assert kt.desc.dtype == np.uint32 and np.array_equal(kt.desc, want)
        assert not kt.desc.flags.writeable


def _constants(*files):
    src = "".join((CSRC / f).read_text() for f in files)
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}


def test_tile_and_halo_constants_cover_the_deepest_window():
    tile = _constants("warp_tile.cuh")
    k2 = _constants("depth_scan.cu")["kMaxSteps"]
    k3 = _constants("pair_scan.cu")["kMaxSteps"]
    warp_tile = 32 * tile["kPer"]
    assert warp_tile <= 256  # K2 keeps a walker's offset in 8 bits
    # K2: step t <= MAX_DEPTH_STEPS - 1 reads pos + t; K3: pair step
    # k <= 15 reads pos + 2k (32 and 30 words past pos's own)
    assert k2 == MAX_DEPTH_STEPS and 2 * k3 == MAX_DEPTH_STEPS
    assert tile["kHalo"] >= k2 - 1 and tile["kHalo"] >= 2 * (k3 - 1)
    # a multiple of TILE positions is whole warp tiles, each copied in
    # 16-byte pieces, and the last tile's look-ahead fits the spare TILE
    assert TILE % warp_tile == 0 and warp_tile % 4 == 0
    assert (warp_tile + tile["kHalo"]) % 4 == 0 and tile["kHalo"] <= TILE
    # a block tile is whole warp tiles
    assert tile["kThreads"] % 32 == 0


@pytest.mark.parametrize("n_pos", [TILE, 3 * TILE, 11 * TILE, 64 << 20])
def test_warp_tiles_cover_every_position_once(n_pos):
    """The kernels' tiling (block tiles grid-stride, each of kThreads /
    32 warp tiles that start below n_pos) over n_pos, for grids of one
    block, a few, a full card and one block per tile."""
    k = _constants("warp_tile.cuh")
    warp_tile = 32 * k["kPer"]
    block_tile = k["kThreads"] // 32 * warp_tile
    tiles = -(-n_pos // block_tile)
    warps = np.arange(0, block_tile, warp_tile)
    for grid in sorted({1, 7, 132 * k["kMinBlocks"], tiles}):
        taken = np.concatenate([np.arange(b, tiles, grid)
                                for b in range(min(grid, tiles))])
        starts = (taken[:, None] * block_tile + warps).ravel()
        starts = starts[starts < n_pos]
        assert np.array_equal(np.sort(starts),
                              np.arange(0, n_pos, warp_tile))
    last = n_pos - warp_tile
    assert last + warp_tile + k["kHalo"] <= n_pos + TILE


def _staged(name):
    """(depth tables, staged bytes, pair tables, staged pairs) of one
    shard over 8 KiB of text."""
    comp = _compiled(name, 1)
    sh = comp.shards[0]
    rng = np.random.default_rng(9)
    data = bytes(np.frombuffer(b"abcdefghijkl", np.uint8)[
        rng.integers(0, 12, 8192)])
    ms = padded_steps(sh.max_pat_len)
    padded = to_device_bytes(pad_input(data, 1024, ms), "cpu")
    ds = tdepth.DepthShardScanner(sh, device="cpu")
    ps = tpair.PairShardScanner(sh, device="cpu")
    return (ds.tables, ds.stage(padded, len(data), ms), ps.tables,
            ps.stage(padded, len(data), ms))


def test_wrappers_refuse_a_misaligned_or_ragged_staged_view():
    dt, dst, pt, pst = _staged("dense")
    flat = dst.reshape(-1)
    n_pos = flat.numel() - TILE
    view = flat[1:1 + (n_pos - TILE) + TILE]  # numel n_pos', 4 B off 16
    assert view.data_ptr() % 16 == 4
    kw = dict(input_size=8192, emit="bitmap", seg_bytes=0, halo_bytes=0,
              shift=0, prev_total=None)
    with pytest.raises(ValueError, match="aligned"):
        tdepth._depth_scan_cuda(view, dt, **kw)
    with pytest.raises(ValueError, match="multiple"):
        tdepth._depth_scan_cuda(flat[:flat.numel() - 256], dt, **kw)
    pflat = pst.reshape(-1)
    pview = pflat[1:1 + pflat.numel() - LANE].reshape(-1, LANE)
    assert pview.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        tpair._pair_scan_cuda(pview, pt, emit="bitmap", shift=0)
    with pytest.raises(ValueError, match="multiple"):
        tpair._pair_scan_cuda(pst[:-2], pt, emit="bitmap", shift=0)
    # the plain versions on the CPU take every view the kernels take
    cell = flat[TILE:]
    assert cell.data_ptr() % 16 == 0
    got = tdepth.depth_scan(cell, dt, input_size=8192)
    assert got[1].numel() == n_pos - TILE
    assert tpair.pair_scan(pst[8:], pt)[1].numel() == n_pos - TILE
