"""Depth scan (phfpfac_tpu_torch.ops.depth) vs the JAX depth kernel.

The JAX package builds the tables and runs its Pallas kernel in
interpret mode; the same tables go through
``convert.depth_tables_from_arrays`` into ``depth_scan_plain``.
Integer outputs, compared exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phfpfac_tpu.compile.depth import build_depth_tables as jax_build_depth
from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.ops.common import pad_input, padded_steps
from phfpfac_tpu.ops.pallas_depth import DepthShardScanner as JaxDepth
from phfpfac_tpu.ops.pallas_depth import depth_count_scanner
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import convert
from phfpfac_tpu_torch.compile.depth import build_depth_tables
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import depth as tdepth
from phfpfac_tpu_torch.ops.staging import stage_input, staged_rows
from phfpfac_tpu_torch.utils.config import PfacConfig

# segment geometries: power-of-two and not (the depth kernel takes any)
GEOMS = [(64, 0), (100, 3)]
FIELDS = ("s0_banks", "packed_banks", "offs", "nbs", "k0s", "n_steps",
          "max_pat_len", "num_final")


def _text(seed=0):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(b"abcdefghijkl", dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(a[rng.integers(0, len(a), int(rng.integers(1, 16)))])
        for _ in range(500)
    ))
    data = bytearray(a[rng.integers(0, len(a), 2048)])
    for i in range(0, len(data) - 16, 37):
        w = words[i % len(words)]
        data[i: i + len(w)] = w
    return words, bytes(data)


def _signatures(seed=7):
    rng = np.random.default_rng(seed)
    sigs = list(dict.fromkeys(
        bytes(rng.integers(0, 256, int(rng.integers(3, 12)), dtype=np.uint8))
        for _ in range(800)
    ))
    data = bytearray(rng.integers(0, 256, 2048, dtype=np.uint8).tobytes())
    for i in range(0, len(data) - 16, 61):
        s = sigs[i % len(sigs)]
        data[i: i + len(s)] = s
    return sigs, bytes(data)


CASES = {"text": _text, "signatures": _signatures}
_cache: dict = {}


def _case(name):
    if name not in _cache:
        words, data = CASES[name]()
        jc = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                         JaxConfig(width=4096, num_shards=1))
        ms = padded_steps(jc.max_pat_len)
        _cache[name] = dict(words=words, data=data, jc=jc, ms=ms,
                            jdt=jax_build_depth(jc.shards[0]),
                            padded=pad_input(data, 1024, ms))
    return _cache[name]


def _port(c):
    dt = convert.depth_tables_from_arrays(
        **{f: getattr(c["jdt"], f) for f in FIELDS})
    kt = tdepth.DepthKernelTables.from_depth(dt, "cpu")
    n_pos = len(c["padded"]) - c["ms"]
    staged = stage_input(torch.from_numpy(c["padded"]),
                         len(c["data"]), n_rows=staged_rows(n_pos))
    return kt, staged


@pytest.mark.parametrize("name", list(CASES))
def test_depth_scan_plain_bitmap_matches_jax(name):
    c = _case(name)
    kt, staged = _port(c)
    n = len(c["data"])
    js = JaxDepth(c["jc"].shards[0], interpret=True)
    exact, cut_fired = None, False
    for seg, halo in [(0, 0)] + GEOMS:
        cfg = JaxConfig(width=4096, num_shards=1,
                        truncation="segment" if seg else "none",
                        segment_bytes=seg or 4096, halo_bytes=halo)
        jcnt, jbits = map(np.asarray,
                          js.scan(c["padded"], n, cfg, c["ms"]))
        cnt, bits = tdepth.depth_scan(staged, kt, input_size=n,
                                      seg_bytes=seg, halo_bytes=halo)
        np.testing.assert_array_equal(bits.numpy(), jbits)
        np.testing.assert_array_equal(cnt.numpy(), jcnt)
        assert jcnt.sum() > 0
        if exact is None:
            exact = bits
        else:
            cut_fired |= bool((bits != exact).any())
    assert cut_fired


@pytest.mark.parametrize("name", list(CASES))
def test_depth_scan_plain_count_matches_jax(name):
    c = _case(name)
    kt, staged = _port(c)
    n = len(c["data"])
    sc = depth_count_scanner(c["jc"].shards[0], c["ms"], interpret=True)
    jstaged = sc.prepare(c["padded"], n)
    want = {}
    for shift in (0, 1):
        want[shift] = int(np.asarray(sc.scan(jstaged, jnp.int32(n),
                                             jnp.int32(shift))))
        got = tdepth.depth_scan(staged, kt, input_size=n, emit="count",
                                shift=shift)
        assert got.dtype == torch.int64 and int(got) == want[shift]
    for prev, shift in ((3, 0), (3, 1)):
        got = tdepth.depth_scan(staged, kt, input_size=n, emit="count",
                                shift=shift,
                                prev_total=torch.tensor([prev]))
        assert int(got) == want[(prev + shift) % 2]


@pytest.mark.parametrize("name", list(CASES))
def test_port_builds_the_same_depth_tables(name):
    c = _case(name)
    tc = compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(c["words"])],
        PfacConfig(width=4096, num_shards=1),
    )
    dt = build_depth_tables(tc.shards[0])
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(dt, f)),
                                      np.asarray(getattr(c["jdt"], f)))
    assert tdepth.DepthKernelTables.from_depth(dt, "cpu").dead_exit
