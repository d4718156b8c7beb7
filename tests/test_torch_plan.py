"""Plan scan (phfpfac_tpu_torch.ops.plan) vs the JAX plan kernel.

The JAX package builds the tables and runs its Pallas kernel in
interpret mode; the same tables go through
``convert.plan_tables_from_arrays`` into ``plan_scan_plain``.  Integer
outputs, compared exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phfpfac_tpu.compile.plan import build_plan_tables as jax_build_plan
from phfpfac_tpu.compile.plan import plan_tables_arrays as jax_plan_arrays
from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.ops.common import pad_input, padded_steps
from phfpfac_tpu.ops.pallas_plan import PlanShardScanner as JaxPlanScanner
from phfpfac_tpu.ops.pallas_plan import plan_count_scanner
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import convert
from phfpfac_tpu_torch.compile.plan import build_plan_tables
from phfpfac_tpu_torch.compile.plan import plan_tables_arrays
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import plan as tplan
from phfpfac_tpu_torch.ops.staging import stage_pairs, staged_rows
from phfpfac_tpu_torch.utils.config import PfacConfig

# small power-of-two segment geometries: the cut fires often, and with
# halo 0 it also cuts the dense prologue's depth-2 completion
GEOMS = [(64, 0), (128, 4)]


def _words(alpha: bytes, n: int, lo: int, hi: int, seed: int):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alpha, dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(a[rng.integers(0, len(a), int(rng.integers(lo, hi)))])
        for _ in range(n)
    ))
    data = bytearray(a[rng.integers(0, len(a), 2048)])
    for i in range(0, len(data) - 16, 37):  # plant some matches
        w = words[i % len(words)]
        data[i: i + len(w)] = w
    return words, bytes(data)


def _signatures(seed: int = 11):
    """sigma=256 byte signatures: the s0x prologue with col_bits steps."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (4000, 16), dtype=np.uint8).tobytes()
    sigs = list(dict.fromkeys(
        raw[i * 16: i * 16 + 3 + int(rng.integers(0, 6))]
        for i in range(4000)
    ))
    data = bytearray(rng.integers(0, 256, 2048, dtype=np.uint8).tobytes())
    for i in range(0, len(data) - 16, 61):  # plant some matches
        s = sigs[i % len(sigs)]
        data[i: i + len(s)] = s
    return sigs, bytes(data)


# dictionary families: dense p0 with nibble+byte pair steps, s0 with
# byte pair steps, s0x with a col_bits split step (sigma 256)
CASES = {
    "dense": lambda: _words(b"abcdefghijkl", 800, 1, 16, 0),
    "s0": lambda: _words(bytes(range(48, 80)), 600, 3, 16, 0),
    "s0x": _signatures,
}
_cache: dict = {}


def _case(name: str, trained: bool):
    key = (name, trained)
    if key not in _cache:
        words, data = CASES[name]()
        cfg = JaxConfig(width=4096, num_shards=1)
        jc = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                         cfg)
        train = data[:2048] if trained else None
        jpt = jax_build_plan(jc.shards[0], train=train)
        ms = padded_steps(jc.max_pat_len)
        _cache[key] = dict(words=words, data=data, jc=jc, jpt=jpt, ms=ms,
                           train=train, padded=pad_input(data, 1024, ms))
    return _cache[key]


def _port_tables(c):
    arrays, meta = jax_plan_arrays(c["jpt"], "shard0_plan_")
    pt = convert.plan_tables_from_arrays(arrays, meta)
    return pt, tplan.PlanKernelTables.from_plan(pt, "cpu")


def _staged(c, pt):
    padded = torch.from_numpy(c["padded"])
    n_pos = len(c["padded"]) - c["ms"]
    return stage_pairs(padded, len(c["data"]), torch.from_numpy(pt.code_of),
                       n_rows=staged_rows(n_pos), cb=pt.code_bits)


PARAMS = [(n, t) for n in CASES for t in (False, True)]


@pytest.mark.parametrize("name,trained", PARAMS)
def test_plan_scan_plain_bitmap_matches_jax(name, trained):
    c = _case(name, trained)
    pt, kt = _port_tables(c)
    staged = _staged(c, pt)
    n = len(c["data"])
    js = JaxPlanScanner(c["jc"].shards[0], interpret=True, pt=c["jpt"],
                        compact="off")
    exact, cut_fired = None, False
    for seg, halo in [(0, 0)] + GEOMS:
        cfg = JaxConfig(width=4096, num_shards=1,
                        truncation="segment" if seg else "none",
                        segment_bytes=seg or 4096, halo_bytes=halo)
        jcnt, jbits = map(np.asarray,
                          js.scan(c["padded"], n, cfg, c["ms"]))
        cnt, bits = tplan.plan_scan(staged, kt, seg_bytes=seg,
                                    halo_bytes=halo)
        np.testing.assert_array_equal(bits.numpy(), jbits)
        np.testing.assert_array_equal(cnt.numpy(), jcnt)
        assert jcnt.sum() > 0
        if exact is None:
            exact = bits
        else:
            cut_fired |= bool((bits != exact).any())
    assert cut_fired


@pytest.mark.parametrize("name,trained", PARAMS)
def test_plan_scan_plain_count_matches_jax(name, trained):
    c = _case(name, trained)
    pt, kt = _port_tables(c)
    staged = _staged(c, pt)
    n = len(c["data"])
    sc = plan_count_scanner(c["jc"].shards[0], c["ms"], interpret=True,
                            pt=c["jpt"], compact="off")
    jstaged = sc.prepare(c["padded"], n)
    want = {}
    for shift in (0, 1):
        want[shift] = int(np.asarray(sc.scan(jstaged, jnp.int32(n),
                                             jnp.int32(shift))))
        got = tplan.plan_scan(staged, kt, emit="count", shift=shift)
        assert got.dtype == torch.int64 and int(got) == want[shift]
    # a chained scan: shift = (previous total + shift) % 2
    for prev, shift in ((7, 0), (7, 1), (4, 1)):
        got = tplan.plan_scan(staged, kt, emit="count", shift=shift,
                              prev_total=torch.tensor([prev]))
        assert int(got) == want[(prev + shift) % 2]


@pytest.mark.parametrize("name,trained", PARAMS)
def test_port_builds_the_same_plan_tables(name, trained):
    c = _case(name, trained)
    tc = compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(c["words"])],
        PfacConfig(width=4096, num_shards=1),
    )
    pt = build_plan_tables(tc.shards[0], train=c["train"])
    mine, my_meta = plan_tables_arrays(pt, "p_")
    theirs, their_meta = jax_plan_arrays(c["jpt"], "p_")
    assert my_meta == their_meta
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_plan_cases_cover_every_step_geometry():
    """The cases above exercise each prologue mode, split (col_bits)
    steps and both side-table packings."""
    seen = set()
    for name, trained in PARAMS:
        pt = _case(name, trained)["jpt"]
        seen.add(pt.p0_mode)
        for s in pt.steps:
            if s.kind == "pair":
                seen.add("nibble" if s.s_nibble else "byte")
            if s.col_bits:
                seen.add("col_bits")
        if trained:
            assert pt.trained
    assert {"dense", "s0", "s0x", "nibble", "byte", "col_bits"} <= seen


def test_plan_scan_rejects_other_devices_and_emits():
    c = _case("dense", False)
    _pt, kt = _port_tables(c)
    with pytest.raises(ValueError):
        tplan.plan_scan(torch.zeros((16, 128), dtype=torch.int32,
                                    device="meta"), kt)
    with pytest.raises(ValueError):
        tplan.plan_scan(torch.zeros((16, 128), dtype=torch.int32), kt,
                        emit="rows")
