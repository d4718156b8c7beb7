"""Banked-PHF scan (phfpfac_tpu_torch.ops.scan) vs the JAX package's
banked-LUT Pallas kernels in interpret mode, on the same tables.

Integer outputs, compared exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.ops import pallas_scan as jscan
from phfpfac_tpu.ops.common import pad_input, padded_steps
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import scan as tscan
from phfpfac_tpu_torch.ops.bitmap import decode_bitmap
from phfpfac_tpu_torch.oracle.ac import match_oracle
from phfpfac_tpu_torch.parallel.merge import merge_flat_matches
from phfpfac_tpu_torch.utils.config import PfacConfig

PT_FIELDS = ("s0", "r", "packed", "width_bit", "row_bits", "dead",
             "num_final", "max_pat_len")
# (segment_bytes, halo_bytes); 0 = exact mode.  The tiny halo makes the
# cut bite, and 100 is no power of two (the PHF kernels take any)
GEOMS = [(0, 0), (64, 2), (100, 3)]
_cache: dict = {}


def _case(shards):
    if shards not in _cache:
        rng = np.random.default_rng(11 + shards)
        a = np.frombuffer(b"abcdefgh", dtype=np.uint8)
        words = list(dict.fromkeys(
            bytes(a[rng.integers(0, len(a), int(rng.integers(1, 12)))])
            for _ in range(90)))
        data = bytearray(a[rng.integers(0, len(a), 2000)])
        for i in range(0, len(data) - 16, 53):
            w = words[i % len(words)]
            data[i:i + len(w)] = w
        data = bytes(data)
        jc = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                         JaxConfig(width=256, num_shards=shards))
        tcfg = PfacConfig(width=256, num_shards=shards)
        tc = compile_patterns(
            [Pattern(i + 1, w) for i, w in enumerate(words)], tcfg)
        ms = padded_steps(jc.max_pat_len)
        _cache[shards] = dict(words=words, data=data, jc=jc, tc=tc, ms=ms,
                              tcfg=tcfg, padded=pad_input(data, 1024, ms))
    return _cache[shards]


def _jax_single(c, jpt, seg, halo, bitmap=True):
    return map(np.asarray, jscan._pallas_scan(
        jnp.asarray(c["padded"]), jnp.int32(len(c["data"])),
        jnp.asarray(jpt.s0), jnp.asarray(jpt.r), jnp.asarray(jpt.packed),
        max_steps=c["ms"], width_bit=jpt.width_bit, row_bits=jpt.row_bits,
        dead=jpt.dead, num_final=jpt.num_final, nb_s0=jpt.s0.shape[0],
        nb_r=jpt.r.shape[0], nb_packed=jpt.packed.shape[0], seg_bytes=seg,
        halo_bytes=halo, emit_bitmap=bitmap, interpret=True))


@pytest.mark.parametrize("shards", [1, 3])
def test_pallas_tables_equal(shards):
    c = _case(shards)
    for jsh, tsh in zip(c["jc"].shards, c["tc"].shards):
        jpt, tpt = jscan.PallasTables(jsh), tscan.PallasTables(tsh)
        for f in PT_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jpt, f)),
                                          np.asarray(getattr(tpt, f)))
        assert tpt.n_banks == jpt.n_banks
    assert tscan.recommended_shards(5000) == jscan.recommended_shards(5000)
    assert tscan.MAX_BITMAP_STEPS == jscan.MAX_BITMAP_STEPS == 32


@pytest.mark.parametrize("seg,halo", GEOMS)
def test_phf_scan_plain_bitmap_matches_jax(seg, halo):
    c = _case(1)
    n = len(c["data"])
    # the JAX package's tables, carried across as arrays
    jpt = jscan.PallasTables(c["jc"].shards[0])
    kt = tscan.PhfKernelTables.from_tables([jpt], "cpu")
    assert kt.dead_exit
    jcnt, jbits = _jax_single(c, jpt, seg, halo)
    cnt, bits = tscan.phf_scan(torch.from_numpy(c["padded"]), kt,
                               input_size=n, max_steps=c["ms"],
                               seg_bytes=seg, halo_bytes=halo)
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    assert cnt.dtype == bits.dtype == torch.int32 and jcnt.sum() > 0
    if seg:
        exact = tscan.phf_scan(torch.from_numpy(c["padded"]), kt,
                               input_size=n, max_steps=c["ms"])[1]
        assert bool((bits != exact).any())  # the cut fired


@pytest.mark.parametrize("shift", [0, 1, 5])
def test_phf_scan_plain_count_matches_jax(shift):
    c = _case(1)
    n = len(c["data"])
    want = int(np.asarray(jscan.pallas_count_scanner(
        c["jc"].shards[0], c["ms"], interpret=True)(
            jnp.asarray(c["padded"]), jnp.int32(n), jnp.int32(shift))))
    scan = tscan.pallas_count_scanner(c["tc"].shards[0], c["ms"],
                                      device="cpu")
    got = scan(c["padded"], n, shift)
    assert got.dtype == torch.int64 and int(got) == want > 0
    assert int(scan.scan(scan.prepare(c["padded"], n), n, shift)) == want


@pytest.mark.parametrize("seg,halo", GEOMS)
def test_phf_scan_multi_plain_bitmap_matches_jax(seg, halo):
    c = _case(3)
    n = len(c["data"])
    cfg = dict(width=256, num_shards=3,
               truncation="segment" if seg else "none",
               segment_bytes=seg or 4096, halo_bytes=halo)
    jm = jscan.MultiShardScanner(c["jc"].shards, interpret=True)
    jcnt, jbits = map(np.asarray, jm.scan(c["padded"], n, JaxConfig(**cfg),
                                          c["ms"]))
    tm = tscan.MultiShardScanner(c["tc"].shards, device="cpu")
    np.testing.assert_array_equal(tm.tables.s0.numpy(), jm.s0_banks)
    np.testing.assert_array_equal(tm.tables.r.numpy(), jm.r_banks)
    np.testing.assert_array_equal(tm.tables.packed.numpy(), jm.p_banks)
    for row, spec in zip(tm.tables.spec_rows, jm.specs):
        assert dict(zip(tscan.SPEC_FIELDS, row)) == spec
    tcfg = PfacConfig(**cfg)
    cnt, bits = tm.scan(c["padded"], n, tcfg, c["ms"])
    assert tuple(bits.shape) == jbits.shape == (3, len(c["padded"]) - c["ms"])
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    cnt2, none = tm.scan(c["padded"], n, tcfg, c["ms"], emit_bitmap=False)
    assert none is None and torch.equal(cnt2, cnt)
    # each row is the single-shard scan of its shard
    for s, sh in enumerate(c["tc"].shards):
        one = tscan.PallasShardScanner(sh, device="cpu").scan(
            c["padded"], n, tcfg, c["ms"])
        assert torch.equal(one[1], bits[s])
    # and the rows decode to the oracle's matches
    flats = [decode_bitmap(bits[s], c["data"], n, sh, c["ms"])
             for s, sh in enumerate(c["tc"].shards)]
    got = merge_flat_matches(c["tc"], flats, n)
    pats = [Pattern(i + 1, w) for i, w in enumerate(c["words"])]
    assert [tuple(x) for x in got.tolist()] == match_oracle(
        pats, c["data"], tcfg)


@pytest.mark.parametrize("trunc", ["segment", "none"])
@pytest.mark.parametrize("shift", [0, 3])
def test_phf_scan_multi_plain_count_matches_jax(shift, trunc):
    c = _case(3)
    n = len(c["data"])
    cfg = dict(width=256, num_shards=3, truncation=trunc, segment_bytes=64,
               halo_bytes=2)
    want = int(np.asarray(jscan.multi_count_scanner(
        c["jc"].shards, c["ms"], JaxConfig(**cfg), interpret=True)(
            jnp.asarray(c["padded"]), jnp.int32(n), jnp.int32(shift))))
    got = tscan.multi_count_scanner(c["tc"].shards, c["ms"],
                                    PfacConfig(**cfg), device="cpu")(
        c["padded"], n, shift)
    assert got.dtype == torch.int64 and int(got) == want > 0


def test_unpacked_tables_are_refused():
    rng = np.random.default_rng(5)
    words = list(dict.fromkeys(
        bytes(rng.integers(0, 256, 30, dtype=np.uint8)) for _ in range(1500)))
    pats = [JaxPattern(i + 1, w) for i, w in enumerate(words)]
    jsh = jax_compile(pats, JaxConfig(width=2, num_shards=1)).shards[0]
    tsh = compile_patterns([Pattern(i + 1, w) for i, w in enumerate(words)],
                           PfacConfig(width=2, num_shards=1)).shards[0]
    with pytest.raises(ValueError, match="packed"):
        jscan.PallasTables(jsh)
    with pytest.raises(tscan.PhfUnsupported, match="packed"):
        tscan.PallasTables(tsh)
    with pytest.raises(tscan.PhfUnsupported, match="packed"):
        tscan.MultiShardScanner([tsh], device="cpu")


def test_steps_past_the_bitmap_are_refused():
    c = _case(1)
    n = len(c["data"])
    cfg = PfacConfig(width=256, num_shards=1)
    padded = pad_input(c["data"], 1024, 40)
    for sc in (tscan.PallasShardScanner(c["tc"].shards[0], device="cpu"),
               tscan.MultiShardScanner(c["tc"].shards, device="cpu")):
        with pytest.raises(tscan.PhfUnsupported, match="max_pat_len <= 32"):
            sc.scan(padded, n, cfg, 40)
    with pytest.raises(tscan.PhfUnsupported, match="max_steps <= 128"):
        tscan.pallas_count_scanner(c["tc"].shards[0], 136, device="cpu")
    # count mode walks past 32 steps (no bitmap to overflow)
    got = tscan.pallas_count_scanner(c["tc"].shards[0], 40, device="cpu")(
        padded, n, 0)
    want = tscan.pallas_count_scanner(c["tc"].shards[0], c["ms"],
                                      device="cpu")(c["padded"], n, 0)
    assert int(got) == int(want)


def test_wrappers_refuse_bad_operands():
    c = _case(1)
    n = len(c["data"])
    kt = tscan.PallasShardScanner(c["tc"].shards[0], device="cpu").tables
    data = torch.from_numpy(c["padded"])
    kw = dict(input_size=n, max_steps=c["ms"])
    with pytest.raises(ValueError, match="uint8"):
        tscan.phf_scan(data.to(torch.int32), kt, **kw)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tscan.phf_scan(data[:-1], kt, **kw)
    with pytest.raises(ValueError, match="emit"):
        tscan.phf_scan(data, kt, emit="rows", **kw)
    with pytest.raises(ValueError, match="input_size"):
        tscan.phf_scan(data, kt, input_size=len(data), max_steps=c["ms"])
    three = tscan.MultiShardScanner(_case(3)["tc"].shards, device="cpu")
    with pytest.raises(ValueError, match="one shard"):
        tscan.phf_scan(data, three.tables, **kw)
