"""The plan kernel's host side: pre-decoded step descriptors, the tile
geometry and the staged stream's demands (phfpfac_tpu_torch.ops.plan).

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py
holds it to the plain version at tile edges, on deep lists and on
mesh-cell views); what the host hands it is checked here, on the CPU:
the descriptor probe equals ``probe_banks`` for every step of every
dictionary of test_torch_plan.py (exact), the kernel source's tile
constants keep every warp tile whole and its look-ahead inside the
staged stream, and the wrapper refuses a stream the kernel cannot read.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_plan import CASES

from phfpfac_tpu_torch.compile.plan import build_plan_tables
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import plan as tplan
from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
from phfpfac_tpu_torch.ops.staging import TILE, stage_pairs, staged_rows
from phfpfac_tpu_torch.utils.config import PfacConfig

U32 = 0xFFFFFFFF
PARAMS = [(n, t) for n in CASES for t in (False, True)]
_cache: dict = {}


def _case(name, trained):
    """(kernel tables on the CPU, staged stream) of a test_torch_plan case,
    built by the port's own compiler."""
    key = (name, trained)
    if key not in _cache:
        words, data = CASES[name]()
        sh = compile_patterns(
            [Pattern(i + 1, w) for i, w in enumerate(words)],
            PfacConfig(width=4096, num_shards=1)).shards[0]
        pt = build_plan_tables(sh, train=data[:2048] if trained else None)
        kt = tplan.PlanKernelTables.from_plan(pt, "cpu")
        ms = padded_steps(sh.max_pat_len)
        padded = pad_input(data, 1024, ms)
        n_pos = len(padded) - ms
        staged = stage_pairs(torch.from_numpy(padded), len(data), kt.code_of,
                             n_rows=staged_rows(n_pos), cb=pt.code_bits)
        _cache[key] = (kt, staged)
    return _cache[key]


def desc_probe(banks, idx, base, lo, span):
    """The kernel's probe over a descriptor, in torch: ``u = idx - lo``
    in 32-bit unsigned arithmetic, ``banks[base + u]`` for ``u < span``,
    else -1.  int64 in and out."""
    u = (idx - lo) & U32
    hit = u < span
    val = banks.reshape(-1)[torch.where(hit, base + u, 0)].to(torch.int64)
    return torch.where(hit, val, -1)


def _indices(lo, span):
    """Every index of the table's range, a margin on both sides, and the
    int32 extremes."""
    near = torch.arange(lo - 2048, lo + span + 2048, dtype=torch.int64)
    far = torch.tensor([-(1 << 31), -(1 << 20), -129, -128, -1,
                        (1 << 31) - 1, (1 << 30)], dtype=torch.int64)
    return torch.cat([near, far])


@pytest.mark.parametrize("name,trained", PARAMS)
def test_descriptor_probe_equals_probe_banks(name, trained):
    kt, _staged = _case(name, trained)
    desc = torch.from_numpy(kt.desc.astype(np.int64))
    assert desc.shape == (len(kt.spec), len(tplan.STEP_DESC_FIELDS))
    checked = 0
    for sp, row in zip(kt.spec, desc.tolist()):
        d = dict(zip(tplan.STEP_DESC_FIELDS, row))
        assert d["o"] == sp.depth0 - 1 and d["pair"] == (sp.kind == "pair")
        tables = [(kt.packed, (sp.off, sp.nb, sp.k0),
                   (d["base"], d["lo"], d["span"]))]
        if sp.kind == "pair":
            tables.append((kt.side, (sp.s_off, sp.s_nb, sp.s_k0),
                           (d["s_base"], d["s_lo"], d["s_span"])))
        for banks, geom, ops in tables:
            idx = _indices(ops[1], ops[2])
            assert torch.equal(desc_probe(banks, idx, *ops),
                               tplan.probe_banks(banks, idx, *geom))
            checked += 1
    # the prologue's probe: base 0, lo 0, span = all of p0
    span = kt.p0.shape[0] * tplan.LANE
    idx = _indices(0, span)
    assert torch.equal(desc_probe(kt.p0, idx, 0, 0, span),
                       tplan.probe_banks(kt.p0, idx, 0, kt.p0.shape[0], 0))
    assert checked >= len(kt.spec)


@pytest.mark.parametrize("name,trained", PARAMS)
def test_step_descriptors_hold_ready_operands(name, trained):
    kt, _staged = _case(name, trained)
    # built once, with the tables, from their host copy of the steps
    desc = tplan.step_descriptors(kt.spec, kt.cb, kt.p0_miss)
    assert kt.desc.dtype == np.uint32 and np.array_equal(kt.desc, desc)
    assert not kt.desc.flags.writeable
    assert kt.desc.shape == (len(kt.spec), len(tplan.STEP_DESC_FIELDS))
    for sp, row in zip(kt.spec, desc.tolist()):
        d = dict(zip(tplan.STEP_DESC_FIELDS, row))
        assert (d["base"], d["lo"], d["span"]) == (
            sp.off * 128, sp.k0 * 128, sp.nb * 128)
        assert d["vmask"] == (1 << d["vsh"]) - 1
        if sp.col_bits:
            assert (d["cmask"], d["finm"], d["vsh"]) == (
                (1 << sp.col_bits) - 1, 1 << (sp.col_bits + 1),
                sp.col_bits + 2)
        else:
            assert (d["cmask"], d["finm"], d["vsh"]) == (
                (1 << kt.cb) - 1, 1 << kt.cb, kt.cb + 1)
        if sp.kind == "pair" and sp.s_nibble:
            assert (d["wsh"], d["smask"], d["fsh"], d["fmask"],
                    d["amask"]) == (3, 7, 2, 15, 7)
        elif sp.kind == "pair":
            assert (d["wsh"], d["fmask"], d["amask"]) == (2, 255, 0xFFFFFFFF)


def test_step_descriptors_refuse_what_the_kernel_cannot_walk():
    kt, _staged = _case("s0", False)
    sp = kt.spec[0]
    with pytest.raises(ValueError):
        tplan.step_descriptors((dataclasses.replace(sp, miss=sp.miss + 1),),
                               kt.cb, kt.p0_miss)
    with pytest.raises(ValueError):
        tplan.step_descriptors((dataclasses.replace(sp, depth0=33),), kt.cb,
                               kt.p0_miss)


def _kernel_constants():
    """kThreads, kPer, kHalo of csrc/plan_scan.cu and kMaxSteps of
    csrc/plan_step.cuh, read from the sources the kernel is built from."""
    csrc = Path(tplan.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "plan_scan.cu").read_text() + \
        (csrc / "plan_step.cuh").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("kThreads", "kPer", "kHalo", "kMaxSteps")}


def test_kernel_tile_constants_match_the_host():
    k = _kernel_constants()
    warp_tile = 32 * k["kPer"]
    assert tplan.PLAN_TILE == k["kThreads"] // 32 * warp_tile
    assert tplan.PLAN_HALO == k["kHalo"]
    # the deepest window (depth0 - 1 <= kMaxSteps - 1) lies in the copy
    assert k["kHalo"] >= k["kMaxSteps"]
    # a multiple of TILE positions is whole warp tiles, each copied in
    # 16-byte pieces, and its look-ahead fits the staged spare TILE
    assert TILE % warp_tile == 0 and warp_tile % 4 == 0
    assert (warp_tile + k["kHalo"]) % 4 == 0 and k["kHalo"] <= TILE


@pytest.mark.parametrize("n_pos", [TILE, tplan.PLAN_TILE,
                                   tplan.PLAN_TILE + TILE,
                                   5 * tplan.PLAN_TILE, 64 << 20])
def test_tiles_cover_every_position_once(n_pos):
    """The kernel's tiling (kTile block tiles grid-stride, each of
    kTile / kWarpTile warp tiles that start below n_pos) over n_pos: one
    tile, a partial last tile, many, and a 64 MiB window."""
    k = _kernel_constants()
    warp_tile = 32 * k["kPer"]
    tiles = -(-n_pos // tplan.PLAN_TILE)
    warps = np.arange(0, tplan.PLAN_TILE, warp_tile)
    for grid in sorted({1, 7, 132 * 5, tiles}):
        taken = np.concatenate([np.arange(b, tiles, grid)
                                for b in range(min(grid, tiles))])
        starts = (taken[:, None] * tplan.PLAN_TILE + warps).ravel()
        starts = starts[starts < n_pos]
        assert np.array_equal(np.sort(starts),
                              np.arange(0, n_pos, warp_tile))
    last = (n_pos - 1) // warp_tile * warp_tile  # the last warp tile
    assert last + warp_tile == n_pos  # whole
    # its copy: its positions and kHalo words past them, inside the
    # n_pos + TILE staged words
    assert last + warp_tile + k["kHalo"] <= n_pos + TILE
    staged = torch.zeros(1, dtype=torch.int32).expand(n_pos + TILE)
    tplan.check_staged(staged)


def test_check_staged_takes_every_multiple_of_a_staging_tile():
    for m in range(0, 257):
        tplan.check_staged(torch.zeros((m + 1) * TILE, dtype=torch.int32))
    for n_pos in (-TILE, TILE + 4, 100):
        with pytest.raises(ValueError, match="multiple"):
            tplan.check_staged(torch.zeros(n_pos + TILE, dtype=torch.int32))


def test_wrapper_raises_on_a_misaligned_staged_view():
    kt, staged = _case("dense", False)
    flat = staged.reshape(-1)
    n_pos = flat.numel() - TILE
    tplan.check_staged(staged)
    # one word in: numel still n_pos' + TILE, data 4 bytes off 16
    view = flat[1:1 + (n_pos - TILE) + TILE]
    assert view.data_ptr() % 16 == 4
    kw = dict(emit="bitmap", seg_bytes=0, halo_bytes=0, shift=0,
              prev_total=None)
    with pytest.raises(ValueError, match="aligned"):
        tplan.check_staged(view)
    with pytest.raises(ValueError, match="aligned"):
        tplan._plan_scan_cuda(view, kt, **kw)
    with pytest.raises(ValueError, match="aligned"):
        tplan._plan_scan_cuda(view, kt, compact=(1, 8192), **kw)
    # an aligned view at a tile boundary (a mesh cell's) passes
    cell = flat[TILE:]
    assert cell.data_ptr() % 16 == 0
    tplan.check_staged(cell)
