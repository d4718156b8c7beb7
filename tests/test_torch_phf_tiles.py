"""The banked-PHF kernels' host side (phfpfac_tpu_torch.ops.scan): the
pre-decoded shard descriptors, the list-entry proof, and the warp-tile
byte copies of csrc/phf_scan.cu.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py holds it to
the plain versions at every tile geometry, on views at odd byte offsets,
with 1, 3 and 64 shards, with dead_exit off and in count mode at 128
steps).  What the host hands it is checked here, on the CPU: the
descriptor probe equals ``_lut`` on every table of every shard (exact);
the source's constants agree with the wrapper's limits; a numpy model of
the tile copies reads no byte outside the tensor and covers every byte a
walk reads, at every base offset; and the one-word list entries are used
only where every state fits in 24 bits.
"""

import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_plan_tiles import _indices, desc_probe

from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import scan as tscan
from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
from phfpfac_tpu_torch.ops.staging import TILE, to_device_bytes
from phfpfac_tpu_torch.utils.config import PfacConfig

CSRC = Path(tscan.__file__).resolve().parent.parent / "csrc"
U32 = 0xFFFFFFFF


def _signatures(count, seed, longest=32):
    """Random byte signatures of 8..longest bytes (clamav5k's kind)."""
    rng = np.random.default_rng(seed)
    return list(dict.fromkeys(
        bytes(rng.integers(0, 256, int(rng.integers(8, longest + 1)),
                           dtype=np.uint8)) for _ in range(count)))


def _words(count, seed):
    """Short words over 8 letters: small tables, few row bits."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(b"abcdefgh", np.uint8)
    return list(dict.fromkeys(
        bytes(a[rng.integers(0, 8, int(rng.integers(1, 12)))])
        for _ in range(count)))


def _tables(words, shards, width=4096):
    compiled = compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)],
        PfacConfig(width=width, num_shards=shards))
    return [tscan.PallasTables(sh) for sh in compiled.shards], compiled


DICTS = {"signatures": lambda: _signatures(1500, 3),
         "words": lambda: _words(400, 4)}


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("name", list(DICTS))
def test_descriptor_probe_equals_lut(name, shards):
    pts, _ = _tables(DICTS[name](), shards)
    kt = tscan.PhfKernelTables.from_tables(pts, "cpu")
    assert kt.desc.shape == (shards, len(tscan.PHF_DESC_FIELDS))
    for spec, row in zip(kt.spec_rows, kt.desc.astype(np.int64).tolist()):
        sp = dict(zip(tscan.SPEC_FIELDS, spec))
        d = dict(zip(tscan.PHF_DESC_FIELDS, row))
        for banks, off, nb, base, span in (
                (kt.s0, sp["s0_off"], sp["nb_s0"], d["s0_base"],
                 d["s0_span"]),
                (kt.r, sp["r_off"], sp["nb_r"], d["r_base"], d["r_span"]),
                (kt.packed, sp["p_off"], sp["nb_p"], d["p_base"],
                 d["p_span"])):
            idx = _indices(0, span)  # negatives, the edges, int32 extremes
            want = tscan._lut(banks, idx.to(torch.int32), off, nb)
            assert torch.equal(desc_probe(banks, idx, base, 0, span),
                               want.to(torch.int64))
            # the nb * 128 edge: the last entry is read, the next misses
            edge = torch.tensor([span - 1, span], dtype=torch.int64)
            got = desc_probe(banks, edge, base, 0, span)
            assert int(got[1]) == -1
            assert int(got[0]) == int(banks.reshape(-1)[base + span - 1])
        assert d["wb"] == sp["width_bit"] and d["rb"] == sp["row_bits"]
        assert d["wm1"] == (1 << sp["width_bit"]) - 1
        assert d["row_mask"] == (1 << sp["row_bits"]) - 1
        assert d["dead"] == sp["dead"] and d["num_final"] == sp["num_final"]
        # the DEAD state's keys: its rows of r are sentinel rows, and the
        # packed probe they lead to misses, by either probe
        keys = (sp["dead"] << 8) + torch.arange(256, dtype=torch.int64)
        rows = keys >> sp["width_bit"]
        rv = desc_probe(kt.r, rows, d["r_base"], 0, d["r_span"])
        assert torch.equal(rv, tscan._lut(kt.r, rows.to(torch.int32),
                                          sp["r_off"], sp["nb_r"]).long())
        assert bool((rv == tscan.SENTINEL_R).all())
        idx = (rv + (keys & d["wm1"])) & U32
        assert bool((desc_probe(kt.packed, idx, d["p_base"], 0,
                                d["p_span"]) == -1).all())


@pytest.mark.parametrize("name", list(DICTS))
def test_descriptors_are_built_once_with_the_tables(name):
    pts, _ = _tables(DICTS[name](), 3)
    kt = tscan.PhfKernelTables.from_tables(pts, "cpu")
    assert kt.desc.dtype == np.uint32 and not kt.desc.flags.writeable
    assert np.array_equal(kt.desc, tscan.phf_descriptors(kt.spec_rows))
    off = np.asarray(kt.spec_rows, np.int64)[:, [0, 2, 4]]
    assert np.array_equal(kt.desc[:, [0, 2, 4]].astype(np.int64), off * 128)
    assert kt.dead_exit  # the compiled tables prove it
    # the kernel reads no spec array on the device any more
    assert not any(isinstance(v, torch.Tensor) and v.dim() == 2
                   and v.shape[1] == len(tscan.SPEC_FIELDS)
                   for v in vars(kt).values())


def _constants(*files):
    src = "".join((CSRC / f).read_text() for f in files)
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}


def test_source_constants_agree_with_the_wrapper():
    k = _constants("warp_tile.cuh", "phf_scan.cu")
    warp_tile = 32 * k["kPer"]
    assert warp_tile <= 256  # a list entry keeps its offset in 8 bits
    assert TILE % warp_tile == 0  # n_pos % 1024 == 0: whole warp tiles
    assert k["kMaxShards"] == tscan.MAX_SHARDS
    assert k["kMaxSteps"] == tscan.MAX_COUNT_STEPS
    assert k["kMaxBitmapSteps"] == tscan.MAX_BITMAP_STEPS
    # step t <= max_steps - 1 reads pos + t inside the tile's copy
    assert k["kHalo"] >= tscan.MAX_COUNT_STEPS - 1
    assert k["kShortHalo"] >= tscan.MAX_BITMAP_STEPS - 1
    assert k["kHalo"] % 16 == 0 and k["kShortHalo"] % 16 == 0
    assert k["kLead"] == 16  # room for any offset from a 16-byte boundary
    # one 16-byte copy a lane covers a stage
    assert (warp_tile + k["kHalo"]) // 16 + 1 <= 32
    # the descriptor: 12 words, in PHF_DESC_FIELDS' order
    assert k["kDescWords"] == len(tscan.PHF_DESC_FIELDS)
    body = re.search(r"struct Desc \{(.*?)\};",
                     (CSRC / "phf_scan.cu").read_text(), re.S).group(1)
    names = re.findall(r"(\w+)(?=[,;])", body)
    assert tuple(names) == tscan.PHF_DESC_FIELDS
    # a position's cnt over the shards fits the 16-bit counts it is
    # summed in
    assert tscan.MAX_SHARDS * tscan.MAX_BITMAP_STEPS < 1 << 16
    # the deep list is walked a lane a walker, and an entry keeps its
    # shard and its room (at most 128, or 255 for none) in 8 bits each
    assert 1 <= k["kDeep"] <= 32 and 1 <= k["kNear"] < tscan.MAX_COUNT_STEPS
    assert tscan.MAX_SHARDS <= 256 and tscan.MAX_COUNT_STEPS < 255


def _copies(start, mis, chunks, n_bytes):
    """load_bytes of phf_scan.cu, one 16-byte chunk a lane: (stage
    offset, first tensor byte, bytes) of each read, and the kind."""
    out = []
    for lane in range(min(chunks, 32)):
        g = start - mis + 16 * lane
        if g >= 0:
            left = n_bytes - g
            if left >= 16:
                out.append((16 * lane, g, 16, "cp.async"))
            elif left > 0:
                out.append((16 * lane, g, left, "zero-fill"))
        else:
            lo = -g
            hi = min(16, n_bytes - g)
            if hi > lo:
                out.append((16 * lane + lo, 0, hi - lo, "bytes"))
    return out


@pytest.mark.parametrize("max_steps", [1, 2, 17, 32, 33, 128])
@pytest.mark.parametrize("n_pos", [TILE, 3 * TILE, 11 * TILE])
def test_tile_copies_stay_inside_the_tensor_and_cover_every_walk(n_pos,
                                                                 max_steps):
    """Every warp tile of a window of n_pos + max_steps bytes at every
    offset from a 16-byte boundary: the copies read only bytes of the
    tensor, each byte to its place in the stage, and cover every byte a
    walk of the tile reads (pos + t, t < max_steps); the stage holds the
    copies."""
    k = _constants("warp_tile.cuh", "phf_scan.cu")
    warp_tile, lead = 32 * k["kPer"], k["kLead"]
    halo = k["kHalo"] if max_steps > tscan.MAX_BITMAP_STEPS else \
        k["kShortHalo"]
    stage = lead + warp_tile + halo
    chunks = (warp_tile + halo) // 16 + 1
    n_bytes = n_pos + max_steps
    for mis in range(16):
        kinds = set()
        for start in range(0, n_pos, warp_tile):
            have = np.zeros(stage, bool)
            for at, first, size, kind in _copies(start, mis, chunks,
                                                 n_bytes):
                kinds.add(kind)
                assert 0 <= first and first + size <= n_bytes
                assert at + size <= stage
                # stage byte at holds tensor byte start - mis + at
                assert first == start - mis + at
                have[at:at + size] = True
            # a walk reads tensor bytes start + p + t at stage mis + p + t
            need = mis + np.arange(warp_tile + max_steps - 1)
            assert have[need].all()
        # the last tile's copy reaches past the tensor's end, so the chunk
        # across it is cut short unless the end is a 16-byte boundary;
        # and the tensor's first chunk starts before it unless aligned
        assert ("zero-fill" in kinds) == bool((n_bytes + mis) % 16)
        assert ("bytes" in kinds) == bool(mis)
        assert "cp.async" in kinds


def test_copies_of_a_window_at_a_byte_offset_read_its_bytes_only():
    """The model on a view of a larger buffer: every byte a copy reads
    is a byte of the view (never the bytes around it)."""
    buf = np.arange(4 * TILE + 64, dtype=np.int64)
    for k in (1, 3, 7, 13):
        n_pos, ms = 2 * TILE, 32
        view = buf[k:k + n_pos + ms]
        mis = k % 16  # a 16-byte aligned buffer
        got = set()
        for start in range(0, n_pos, 256):
            for _at, first, size, _kind in _copies(start, mis, 19,
                                                   view.size):
                got.update(view[first:first + size].tolist())
        assert got == set(view.tolist())


def test_one_word_entries_only_where_every_state_fits_24_bits():
    wide_rows, _ = _tables(_signatures(2000, 5), 2)
    narrow_rows, _ = _tables(_words(90, 6), 1)
    assert all(pt.row_bits >= 8 for pt in wide_rows)
    assert narrow_rows[0].row_bits < 8
    # a probe outside packed reads -1; its state is -1 >> row_bits
    assert all(tscan.states_fit_24(pt) for pt in wide_rows)
    assert not tscan.states_fit_24(narrow_rows[0])
    assert tscan.PhfKernelTables.from_tables(wide_rows, "cpu").one_word
    mixed = tscan.PhfKernelTables.from_tables(wide_rows + narrow_rows, "cpu")
    assert not mixed.one_word
    # a DEAD state or an s0 state past 24 bits: no one-word entries (with
    # 8 row bits or more, g >> row_bits always fits)
    big = copy.copy(wide_rows[0])
    big.dead = 1 << 24
    assert not tscan.states_fit_24(big)
    big = copy.copy(wide_rows[0])
    big.s0 = big.s0.copy()
    big.s0.ravel()[7] = 1 << 24
    assert not tscan.states_fit_24(big)
    # where it holds, every state a walker can hold does fit: s0's, the
    # chained g >> row_bits, DEAD
    for pt in wide_rows:
        states = np.concatenate([
            pt.s0.ravel().view(np.uint32),
            pt.packed.ravel().view(np.uint32) >> pt.row_bits,
            np.array([pt.dead, U32 >> pt.row_bits], np.uint32)])
        assert int(states.max()) < 1 << 24


def test_dead_exit_needs_a_dead_state_that_is_no_match():
    pts, _ = _tables(_signatures(600, 7), 1)
    assert tscan.PhfKernelTables.from_tables(pts, "cpu").dead_exit
    odd = copy.copy(pts[0])
    odd.num_final = odd.dead + 1  # a stopped walker would be a match
    assert not tscan.PhfKernelTables.from_tables([odd], "cpu").dead_exit


@pytest.mark.parametrize("k", [1, 3, 7, 13])
def test_wrappers_take_a_window_at_any_byte_offset(k):
    """No refusal for a view that starts off a 16-byte boundary (as
    match_chunked's views of a staged corpus do): the plain versions on
    the CPU give the aligned copy's answers, and the checks pass."""
    words = _signatures(300, 8)
    pts, compiled = _tables(words, 2)
    kt = tscan.PhfKernelTables.from_tables(pts, "cpu")
    rng = np.random.default_rng(k)
    data = bytearray(rng.integers(0, 256, 5000, dtype=np.uint8))
    for i in range(0, 4900, 97):
        w = words[i % len(words)]
        data[i:i + len(w)] = w
    ms = padded_steps(compiled.max_pat_len)
    padded = to_device_bytes(pad_input(bytes(data), 1024, ms), "cpu")
    buf = torch.from_numpy(rng.integers(0, 256, padded.numel() + 32,
                                        dtype=np.uint8))
    view = buf[k:k + padded.numel()]
    view.copy_(padded)
    assert view.data_ptr() % 16 != padded.data_ptr() % 16 or k % 16 == 0
    kw = dict(input_size=len(data), max_steps=ms, seg_bytes=100,
              halo_bytes=3)
    got = tscan.phf_scan_multi(view, kt, **kw)
    want = tscan.phf_scan_multi(padded, kt, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[0].sum()) > 0
    assert int(tscan.phf_scan_multi(view, kt, emit="count", **kw)) == \
        int(want[0].sum())
