"""Pair scan (phfpfac_tpu_torch.ops.pair) vs the JAX pair kernel.

The JAX package builds the tables and runs its Pallas kernel in
interpret mode; the same tables go through
``convert.pair_tables_from_arrays`` into ``pair_scan_plain``.
Integer outputs, compared exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phfpfac_tpu.compile.pair import build_pair_tables as jax_build_pair
from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.ops.common import pad_input, padded_steps
from phfpfac_tpu.ops.pallas_pair import PairShardScanner as JaxPair
from phfpfac_tpu.ops.pallas_pair import pair_count_scanner as jax_pair_count
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import convert
from phfpfac_tpu_torch.compile.pair import PairUnsupported, build_pair_tables
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import pair as tpair
from phfpfac_tpu_torch.ops.bitmap import decode_bitmap
from phfpfac_tpu_torch.ops.staging import stage_pairs, staged_rows
from phfpfac_tpu_torch.oracle.ac import match_oracle
from phfpfac_tpu_torch.parallel.merge import merge_flat_matches
from phfpfac_tpu_torch.utils.config import PfacConfig

FIELDS = ("code_of", "p0_banks", "packed_banks", "side_banks", "p_offs",
          "p_nbs", "p_k0s", "s_offs", "s_nbs", "s_k0s", "s_nibbles",
          "n_pair_steps", "code_bits", "disp_miss", "max_pat_len")


def _dictionary(alpha: bytes, n: int, seed=0):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alpha, dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(a[rng.integers(0, len(a), int(rng.integers(1, 16)))])
        for _ in range(n)))
    data = bytearray(a[rng.integers(0, len(a), 2040)])
    for i in range(0, len(data) - 16, 37):
        w = words[i % len(words)]
        data[i: i + len(w)] = w
    data[-3:] = words[0][:3]  # a walk that runs into the input's end
    return words, bytes(data)


CASES = {
    # 12 symbols, cb 4: every side table holds bytes
    "bytes": lambda: _dictionary(b"abcdefghijkl", 500),
    # 40 symbols, cb 6: nibble and byte side tables both
    "nibbles": lambda: _dictionary(bytes(range(48, 88)), 800),
}
_cache: dict = {}


def _case(name):
    if name not in _cache:
        words, data = CASES[name]()
        jc = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                         JaxConfig(width=256, num_shards=1))
        tcfg = PfacConfig(width=256, num_shards=1, truncation="none")
        tc = compile_patterns(
            [Pattern(i + 1, w) for i, w in enumerate(words)], tcfg)
        ms = padded_steps(jc.max_pat_len)
        _cache[name] = dict(words=words, data=data, jc=jc, tc=tc, ms=ms,
                            tcfg=tcfg, jpt=jax_build_pair(jc.shards[0]),
                            padded=pad_input(data, 1024, ms))
    return _cache[name]


def _port(c):
    """The JAX package's tables and the staged stream, in the port."""
    pt = convert.pair_tables_from_arrays(
        **{f: getattr(c["jpt"], f) for f in FIELDS})
    kt = tpair.PairKernelTables.from_pair(pt, "cpu")
    n_pos = len(c["padded"]) - c["ms"]
    staged = stage_pairs(torch.from_numpy(c["padded"]), len(c["data"]),
                         kt.code_of, n_rows=staged_rows(n_pos), cb=kt.cb)
    return kt, staged


@pytest.mark.parametrize("name", list(CASES))
def test_port_builds_the_same_pair_tables(name):
    c = _case(name)
    pt = build_pair_tables(c["tc"].shards[0])
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(pt, f)),
                                      np.asarray(getattr(c["jpt"], f)))
    want = {"bytes": {False}, "nibbles": {False, True}}[name]
    assert set(pt.s_nibbles) == want
    assert pt.n_pair_steps > 3


@pytest.mark.parametrize("name", list(CASES))
def test_pair_scan_plain_bitmap_matches_jax(name):
    c = _case(name)
    kt, staged = _port(c)
    n = len(c["data"])
    jcfg = JaxConfig(width=256, num_shards=1, truncation="none")
    jcnt, jbits = map(np.asarray, JaxPair(
        c["jc"].shards[0], interpret=True).scan(c["padded"], n, jcfg,
                                                c["ms"]))
    cnt, bits = tpair.pair_scan(staged, kt)
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    assert cnt.dtype == bits.dtype == torch.int32
    # odd and even depths both matched
    ub = jbits.view(np.uint32)
    assert (ub & 0x55555554).any() and (ub & 0xAAAAAAA8).any()
    # and the bitmap decodes to the oracle's matches
    flat = decode_bitmap(bits, c["data"], n, c["tc"].shards[0], c["ms"])
    got = merge_flat_matches(c["tc"], [flat], n)
    pats = [Pattern(i + 1, w) for i, w in enumerate(c["words"])]
    assert [tuple(x) for x in got.tolist()] == match_oracle(
        pats, c["data"], c["tcfg"])


@pytest.mark.parametrize("shift", [0, 1, 6])
@pytest.mark.parametrize("name", list(CASES))
def test_pair_scan_plain_count_matches_jax(name, shift):
    c = _case(name)
    kt, staged = _port(c)
    n = len(c["data"])
    sc = jax_pair_count(c["jc"].shards[0], c["ms"], interpret=True)
    want = int(np.asarray(sc.scan(sc.prepare(c["padded"], n), jnp.int32(n),
                                  jnp.int32(shift))))
    got = tpair.pair_scan(staged, kt, emit="count", shift=shift)
    assert got.dtype == torch.int64 and int(got) == want > 0
    mine = tpair.pair_count_scanner(c["tc"].shards[0], c["ms"], device="cpu")
    assert int(mine(c["padded"], n, shift)) == want


def test_pair_scanner_scans_and_refuses_the_segment_cut():
    c = _case("bytes")
    n = len(c["data"])
    sc = tpair.PairShardScanner(c["tc"].shards[0], device="cpu")
    kt, staged = _port(c)
    got = sc.scan(c["padded"], n, c["tcfg"], c["ms"])
    want = tpair.pair_scan_plain(staged, kt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    seg = PfacConfig(width=256, num_shards=1, truncation="segment")
    with pytest.raises(PairUnsupported, match="segment"):
        sc.scan(c["padded"], n, seg, c["ms"])


def test_pair_tables_refuse_a_big_alphabet():
    rng = np.random.default_rng(1)
    words = list(dict.fromkeys(
        bytes(rng.integers(0, 256, 6, dtype=np.uint8)) for _ in range(80)))
    sh = compile_patterns([Pattern(i + 1, w) for i, w in enumerate(words)],
                          PfacConfig(width=256, num_shards=1)).shards[0]
    with pytest.raises(PairUnsupported, match="alphabet"):
        tpair.PairShardScanner(sh, device="cpu")


def test_pair_wrapper_refuses_bad_operands():
    kt, staged = _port(_case("bytes"))
    with pytest.raises(ValueError, match="emit"):
        tpair.pair_scan(staged, kt, emit="rows")
    with pytest.raises(ValueError, match="128"):
        tpair.pair_scan(staged[:, :64], kt)
    with pytest.raises(ValueError, match="128"):
        tpair.pair_scan(staged.reshape(-1), kt)
