"""The torch-op engines (ops.turbo, ops.reference, ops.engine_select) vs
the JAX package's XLA engines on the same tables and inputs.

Integer outputs, compared exactly (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.ops.common import pad_input, padded_steps, walk_limits
from phfpfac_tpu.ops.engine_select import (
    best_count_scanner as jax_best,
    xla_count_scanner as jax_xla,
)
from phfpfac_tpu.ops.reference_jnp import scan_shard_jnp
from phfpfac_tpu.ops.turbo_jnp import (
    build_turbo_tables as jax_build_turbo,
    expand_turbo_matches as jax_expand,
    scan_shard_turbo as jax_turbo,
)
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import convert
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import engine_select, reference, turbo
from phfpfac_tpu_torch.ops.depth import DepthCountScan
from phfpfac_tpu_torch.ops.pair import PairCountScan
from phfpfac_tpu_torch.ops.plan import PlanCountScan
from phfpfac_tpu_torch.oracle.ac import match_oracle
from phfpfac_tpu_torch.utils.config import PfacConfig

TT_FIELDS = ("s0", "r", "packed", "ht", "val", "width_bit", "row_bits",
             "dead", "num_final", "max_pat_len")


def _words(seed=0, n=200, alpha=b"abcdef .", hi=14):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alpha, dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(a[rng.integers(0, len(a), int(rng.integers(1, hi)))])
        for _ in range(n)))
    data = bytearray(a[rng.integers(0, len(a), 3000)])
    for i in range(0, len(data) - 40, 97):
        w = words[i % len(words)]
        data[i:i + len(w)] = w
    return words, bytes(data)


def _pair(words, width=256):
    """The first shard of the same dictionary in both packages."""
    jc = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                     JaxConfig(width=width, num_shards=1))
    tc = compile_patterns([Pattern(i + 1, w) for i, w in enumerate(words)],
                          PfacConfig(width=width, num_shards=1))
    return jc.shards[0], tc.shards[0]


def _cfgs(trunc):
    kw = dict(width=256, num_shards=1, truncation=trunc, segment_bytes=512,
              halo_bytes=8)
    return JaxConfig(**kw), PfacConfig(**kw)


@pytest.mark.parametrize("width", [256, 4096])
def test_build_turbo_tables_equal(width):
    words, _ = _words()
    jsh, tsh = _pair(words, width)
    jt, tt = jax_build_turbo(jsh), turbo.build_turbo_tables(tsh)
    for f in TT_FIELDS:
        a, b = getattr(jt, f), getattr(tt, f)
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tt.is_packed


def test_unpacked_turbo_tables_equal_and_scan():
    # many states at width 2 give many rows: the packed entry's bit
    # budget overflows and the split ht/val tables are used
    rng = np.random.default_rng(5)
    words = list(dict.fromkeys(
        bytes(rng.integers(0, 256, 30, dtype=np.uint8)) for _ in range(1500)))
    jsh, tsh = _pair(words, width=2)
    jt, tt = jax_build_turbo(jsh), turbo.build_turbo_tables(tsh)
    assert not jt.is_packed and not tt.is_packed
    for f in TT_FIELDS:
        a, b = getattr(jt, f), getattr(tt, f)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    data = (words[3] + b"zz" + words[7]) * 20
    jcfg, tcfg = _cfgs("none")
    ms = padded_steps(jsh.max_pat_len)
    padded = pad_input(data, 1024, ms)
    want = jax_turbo(jsh, padded, len(data), jcfg, max_steps=ms,
                     turbo_tables=jt)
    got = turbo.scan_shard_turbo(tsh, padded, len(data), tcfg, max_steps=ms,
                                 turbo_tables=tt, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _turbo_both(words, data, trunc, carry, **kw):
    jsh, tsh = _pair(words)
    jcfg, tcfg = _cfgs(trunc)
    ms = padded_steps(jsh.max_pat_len)
    padded = pad_input(data, 1024, ms)
    jt = jax_build_turbo(jsh)
    tt = (convert.turbo_tables_from_arrays(
        **{f: getattr(jt, f) for f in TT_FIELDS})
        if carry else turbo.build_turbo_tables(tsh))
    want = jax_turbo(jsh, padded, len(data), jcfg, max_steps=ms,
                     turbo_tables=jt, **kw)
    got = turbo.scan_shard_turbo(tsh, padded, len(data), tcfg, max_steps=ms,
                                 turbo_tables=tt, device="cpu", **kw)
    return got, want, ms


@pytest.mark.parametrize("emit_counts", [False, True])
@pytest.mark.parametrize("full_steps", [2, 40])  # with / without a tail
@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_scan_shard_turbo_equals_jax(trunc, full_steps, emit_counts):
    words, data = _words()
    got, want, ms = _turbo_both(words, data, trunc, carry=True,
                                full_steps=full_steps, cap_frac=2,
                                emit_counts=emit_counts)
    assert len(got) == 6
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert not bool(got[5])
    assert int(got[1].sum()) > 0
    if full_steps == 2:
        assert int(got[4].sum()) > 0  # the tail phase found matches
    else:
        assert got[2].shape[0] == 0
    if not emit_counts:
        t0 = min(full_steps + 1, ms)
        np.testing.assert_array_equal(
            turbo.expand_turbo_matches(got, len(data), t0),
            jax_expand(want, len(data), t0))


def test_turbo_overflow_reported_and_expand_raises():
    words = [b"a" * k for k in range(1, 13)]
    data = b"a" * 3000
    got, want, ms = _turbo_both(words, data, "none", carry=False,
                                full_steps=2, cap_frac=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[5]) and bool(np.asarray(want[5]))
    with pytest.raises(OverflowError):
        turbo.expand_turbo_matches(got, len(data), 3)


def test_scan_core_pos0_offsets_the_global_limits():
    # a block scanned at pos0 sees the global segment cut and input size
    words, data = _words(seed=2)
    _jsh, tsh = _pair(words)
    _jcfg, tcfg = _cfgs("segment")
    ms = padded_steps(tsh.max_pat_len)
    tt = turbo.build_turbo_tables(tsh)
    whole = turbo.scan_shard_turbo(tsh, pad_input(data, 1024, ms), len(data),
                                   tcfg, max_steps=ms, full_steps=ms,
                                   turbo_tables=tt, device="cpu")
    base = 1024
    block = torch.from_numpy(pad_input(data[base:], 1024, ms))
    part = turbo.scan_core(
        block, base, *tt.on("cpu"), len(data), tt.width_bit, tt.row_bits,
        tt.dead, tt.num_final, tcfg.segment_bytes, tcfg.halo_bytes,
        max_steps=ms, full_steps=ms, cap=128, emit_counts=False)
    n = len(data) - base
    np.testing.assert_array_equal(part[0][:, :n].numpy(),
                                  whole[0][:, base:base + n].numpy())


@pytest.mark.parametrize("emit_counts", [False, True])
@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_reference_scan_shard_equals_jax(trunc, emit_counts):
    words, data = _words(seed=1)
    jsh, tsh = _pair(words)
    jcfg, _tcfg = _cfgs(trunc)
    ms = padded_steps(jsh.max_pat_len)
    padded = pad_input(data, 1024, ms)
    limits = walk_limits(len(padded) - ms, len(data), jsh.max_pat_len, jcfg)
    for slots in (3, jsh.max_pat_len):
        want = scan_shard_jnp(jsh, padded, limits, len(data), slots=slots,
                              emit_counts=emit_counts)
        got = reference.scan_shard(tsh, padded, limits, len(data),
                                   slots=slots, emit_counts=emit_counts,
                                   device="cpu")
        if emit_counts:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))
            assert int((got[0] >= 0).sum()) > 0


@pytest.mark.parametrize("shift", [0, 1, 7])
def test_xla_count_scanner_equals_jax(shift):
    words, data = _words(seed=3)
    jsh, tsh = _pair(words)
    ms = padded_steps(jsh.max_pat_len)
    padded = pad_input(data, 1024, ms)
    want = int(np.asarray(jax_xla(jsh, ms)(
        jnp.asarray(padded), jnp.int32(len(data)), jnp.int32(shift))))
    got = engine_select.xla_count_scanner(tsh, ms, device="cpu")(
        padded, len(data), shift)
    assert got.dtype == torch.int64 and int(got) == want > 0


CASES = {
    # name -> (words, data, the port's expected scanner type)
    "plan": lambda: (*_words(seed=4), PlanCountScan),
    "long": lambda: ([b"z" * 200, b"zz"], b"zz" * 300, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_best_count_scanner_equals_jax_and_oracle(name):
    words, data, kind = CASES[name]()
    jsh, tsh = _pair(words)
    ms = padded_steps(jsh.max_pat_len)
    padded = pad_input(data, 1024, ms)
    scan = engine_select.best_count_scanner(tsh, ms, device="cpu")
    if kind is None:  # past every kernel's steps: the torch-op scan
        assert not isinstance(scan, (PlanCountScan, PairCountScan,
                                     DepthCountScan))
    else:
        assert isinstance(scan, kind)
    jscan = jax_best(jsh, ms, interpret=True)
    want = int(np.asarray(jscan(jnp.asarray(padded), jnp.int32(len(data)),
                                jnp.int32(0))))
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    cfg = PfacConfig(width=256, num_shards=1, truncation="none")
    assert int(scan(padded, len(data), 0)) == want == \
        len(match_oracle(pats, data, cfg))


def test_best_count_scanner_order(monkeypatch):
    """plan > pair > depth > banked-PHF > torch ops: refusing the head of
    the line hands the shard to the next one."""
    from phfpfac_tpu_torch.compile.pair import PairUnsupported
    from phfpfac_tpu_torch.ops import depth, pair, plan, scan

    words, data = _words(seed=6)
    _jsh, tsh = _pair(words)
    ms = padded_steps(tsh.max_pat_len)
    padded = pad_input(data, 1024, ms)
    want = int(engine_select.best_count_scanner(tsh, ms, device="cpu")(
        padded, len(data), 1))

    def refuse(*a, **k):
        raise PairUnsupported("refused for the test")

    seen = []
    for mod, name, cls in ((plan, "plan_count_scanner", PairCountScan),
                           (pair, "pair_count_scanner", DepthCountScan),
                           (depth, "depth_count_scanner", scan.PhfCountScan),
                           (scan, "pallas_count_scanner", None)):
        monkeypatch.setattr(mod, name, refuse)
        s = engine_select.best_count_scanner(tsh, ms, device="cpu")
        if cls is not None:
            assert isinstance(s, cls)
        seen.append(int(s(padded, len(data), 1)))
    assert seen == [want] * 4

    # only a table build's own refusal moves on: any other error, a plain
    # ValueError included, is a fault
    for exc in (RuntimeError, ValueError):
        def fault(*a, exc=exc, **k):
            raise exc("a fault, not a refusal")

        monkeypatch.setattr(plan, "plan_count_scanner", fault)
        with pytest.raises(exc, match="fault"):
            engine_select.best_count_scanner(tsh, ms, device="cpu")


@pytest.mark.parametrize("engine", ["turbo", "reference"])
def test_engine_default_device_is_cuda(engine, monkeypatch):
    # the engines are entry points too: no device named means the card,
    # and without one they raise rather than walk on the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    words, data = _words()
    _, tsh = _pair(words)
    _, tcfg = _cfgs("none")
    ms = padded_steps(tsh.max_pat_len)
    padded = pad_input(data, 1024, ms)
    with pytest.raises(RuntimeError, match="CUDA"):
        if engine == "turbo":
            turbo.scan_shard_turbo(tsh, padded, len(data), tcfg, max_steps=ms)
        else:
            limits = walk_limits(len(padded) - ms, len(data),
                                 tsh.max_pat_len, tcfg)
            reference.scan_shard(tsh, padded, limits, len(data), slots=4)
