"""Two-phase compacted plan scan (phfpfac_tpu_torch.ops.plan) vs the JAX
package's ``_plan_scan_bitmap_compact`` / ``_plan_scan_count_compact``.

The JAX package builds the tables and runs its Pallas kernels in
interpret mode; the same tables go through
``convert.plan_tables_from_arrays`` into ``plan_scan_compact_plain`` and
the port's scanners.  Integer outputs, compared exactly (tolerance 0).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phfpfac_tpu.compile.plan import build_plan_tables as jax_build_plan
from phfpfac_tpu.compile.plan import plan_tables_arrays as jax_plan_arrays
from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.ops import pallas_plan as jplan
from phfpfac_tpu.ops.common import pad_input, padded_steps
from phfpfac_tpu.oracle.ac import match_oracle
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import convert
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import plan as tplan
from phfpfac_tpu_torch.utils.config import PfacConfig

CAP = 16384
_cache: dict = {}


def _words_case():
    """400 words over ``abcdefgh ._`` and an 80,000 B corpus (the JAX
    package's own compaction test), trained on the corpus head."""
    if "words" not in _cache:
        rng = np.random.default_rng(11)
        alpha = np.frombuffer(b"abcdefgh ._", dtype=np.uint8)
        words = list(dict.fromkeys(
            bytes(alpha[rng.integers(0, len(alpha),
                                     int(rng.integers(1, 12)))])
            for _ in range(400)
        ))
        data = bytes(alpha[rng.integers(0, len(alpha), 80_000)])
        _cache["words"] = _build(words, data, width=1024)
    return _cache["words"]


def _sig_case():
    """sigma-256 signatures: the s0x prologue and a col_bits step."""
    if "sigs" not in _cache:
        rng = np.random.default_rng(11)
        raw = rng.integers(0, 256, (4000, 16), dtype=np.uint8).tobytes()
        sigs = list(dict.fromkeys(
            raw[i * 16: i * 16 + 3 + int(rng.integers(0, 6))]
            for i in range(4000)
        ))
        data = bytearray(
            rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes())
        for i in range(0, len(data) - 16, 61):  # plant some matches
            s = sigs[i % len(sigs)]
            data[i: i + len(s)] = s
        _cache["sigs"] = _build(sigs, bytes(data), width=4096)
    return _cache["sigs"]


def _build(words, data, *, width):
    jc = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                     JaxConfig(width=width, num_shards=1))
    jpt = jax_build_plan(jc.shards[0], train=data[:8192])
    arrays, meta = jax_plan_arrays(jpt, "shard0_plan_")
    pt = convert.plan_tables_from_arrays(arrays, meta)
    ms = padded_steps(jc.max_pat_len)
    return dict(words=words, data=data, jc=jc, jpt=jpt, pt=pt, ms=ms,
                width=width,
                kt=tplan.PlanKernelTables.from_plan(pt, "cpu"))


def _port_scanner(c, compact, cls=tplan.PlanShardScanner, **kw):
    tc = compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(c["words"])],
        PfacConfig(width=c["width"], num_shards=1))
    return cls(tc.shards[0], *kw.pop("args", ()), device="cpu", pt=c["pt"],
               compact=compact, **kw)


def _jax_compact(c, padded, n, seg, halo, cut, cap, emit="bitmap", shift=0):
    """The JAX compacted function itself, with the scanner's statics."""
    js = jplan.PlanShardScanner(c["jc"].shards[0], interpret=True,
                                pt=c["jpt"], compact="off")
    data2d = jplan.stage_pairs(
        jnp.asarray(padded), jnp.asarray(np.int32(n)), js._code,
        n_rows=jplan.staged_rows(len(padded) - c["ms"]),
        cb=c["jpt"].code_bits)
    fn = (jplan._plan_scan_bitmap_compact if emit == "bitmap"
          else jplan._plan_scan_count_compact)
    first = jnp.zeros(1, jnp.int32) if emit == "bitmap" \
        else jnp.asarray(shift, jnp.int32)
    with jplan._eager_if(True):
        out = fn(data2d, first, jnp.asarray(c["jpt"].p0_banks),
                 jnp.asarray(c["jpt"].packed_banks),
                 jnp.asarray(c["jpt"].side_banks), seg_bytes=seg,
                 halo_bytes=halo, cut=cut, cap=cap, **js._statics())
    return [np.asarray(x) for x in out]


def _staged(c, padded, n):
    sc = _port_scanner(c, "off")
    return sc.stage(torch.from_numpy(np.asarray(padded)), n, c["ms"])


# ---- resolve_compact -------------------------------------------------------

@pytest.mark.parametrize("opt_in", [False, True])
@pytest.mark.parametrize("trained", [False, True])
def test_resolve_compact_equals_jax(monkeypatch, opt_in, trained):
    c = _words_case()
    if opt_in:
        monkeypatch.setenv(jplan._AUTO_OPT_IN, "1")
    else:
        monkeypatch.delenv(jplan._AUTO_OPT_IN, raising=False)
    assert tplan.AUTO_OPT_IN == jplan._AUTO_OPT_IN
    if trained:
        jpt, pt = c["jpt"], c["pt"]
    else:
        jpt = jax_build_plan(c["jc"].shards[0])
        pt = convert.plan_tables_from_arrays(*jax_plan_arrays(jpt, "p_"))
    assert pt.trained == jpt.trained == trained
    n_steps = len(pt.steps)
    asked = [None, 0, "off", False, "auto", 1, 2, n_steps // 2, n_steps - 1,
             n_steps, n_steps + 3, (1, 8192), (2, 16384), (0, 8192),
             (n_steps, 8192), (n_steps - 1, 1 << 20)]
    engaged = 0
    for n_pos in (1024, 16384, 40960, 81920, 1 << 20, 1 << 24):
        for compact in asked:
            want = jplan.resolve_compact(jpt, n_pos, compact)
            got = tplan.resolve_compact(pt, n_pos, compact)
            assert got == want, (n_pos, compact)
            engaged += want is not None
    assert engaged > 20
    auto = tplan.resolve_compact(pt, 1 << 24, "auto")
    assert (auto is not None) == (opt_in and trained)
    with pytest.raises(ValueError):
        tplan.resolve_compact(pt, 1 << 20, (1, 1000))


# ---- plain version vs the JAX compacted functions --------------------------

@pytest.mark.parametrize("seg,halo", [(0, 0), (1024, 16)])
@pytest.mark.parametrize("which", ["third", "half"])
def test_compact_plain_bitmap_matches_jax(which, seg, halo):
    c = _words_case()
    n_steps = len(c["pt"].steps)
    cut = max(1, n_steps // 3 if which == "third" else n_steps // 2)
    data, n = c["data"], len(c["data"])
    padded = pad_input(data, 1024, c["ms"])
    cfg = JaxConfig(width=1024, num_shards=1,
                    truncation="segment" if seg else "none",
                    segment_bytes=seg or 4096, halo_bytes=halo)
    js = jplan.PlanShardScanner(c["jc"].shards[0], interpret=True,
                                pt=c["jpt"], compact=(cut, CAP))
    jcnt, jbits = map(np.asarray, js.scan(padded, n, cfg, c["ms"]))
    _c, _b, jcount = _jax_compact(c, padded, n, seg, halo, cut, CAP)
    np.testing.assert_array_equal(_b, jbits)  # the scan did compact

    staged = _staged(c, padded, n)
    cnt, bits, count = tplan.plan_scan_compact(
        staged, c["kt"], cut=cut, cap=CAP, seg_bytes=seg, halo_bytes=halo)
    assert isinstance(count, torch.Tensor) and count.dim() == 0
    assert 0 < int(count) == int(jcount) <= CAP
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    # and equal to the port's own uncompacted scan
    cnt0, bits0 = tplan.plan_scan_plain(staged, c["kt"], seg_bytes=seg,
                                        halo_bytes=halo)
    assert torch.equal(bits, bits0) and torch.equal(cnt, cnt0)
    if not seg:
        pats = [JaxPattern(i + 1, w) for i, w in enumerate(c["words"])]
        assert int(cnt[:n].sum()) == len(match_oracle(pats, data, cfg))


@pytest.mark.parametrize("seg,halo", [(0, 0), (256, 4)])
def test_compact_plain_s0x_cuts_match_jax(seg, halo):
    """sigma-256: a cut at step 1 and one right after the split step."""
    c = _sig_case()
    steps = c["pt"].steps
    assert c["pt"].p0_mode == "s0x"
    split = [i for i, s in enumerate(steps) if s.col_bits]
    assert split and split[0] + 1 < len(steps)
    data, n = c["data"], len(c["data"])
    padded = pad_input(data, 1024, c["ms"])
    staged = _staged(c, padded, n)
    cnt0, bits0 = tplan.plan_scan_plain(staged, c["kt"], seg_bytes=seg,
                                        halo_bytes=halo)
    assert int(cnt0.sum()) > 100
    for cut in sorted({1, split[0] + 1}):
        jcnt, jbits, jcount = _jax_compact(c, padded, n, seg, halo, cut,
                                           8192)
        cnt, bits, count = tplan.plan_scan_compact(
            staged, c["kt"], cut=cut, cap=8192, seg_bytes=seg,
            halo_bytes=halo)
        assert int(count) == int(jcount) <= 8192
        np.testing.assert_array_equal(bits.numpy(), jbits)
        np.testing.assert_array_equal(cnt.numpy(), jcnt)
        assert torch.equal(bits, bits0) and torch.equal(cnt, cnt0)


def test_segment_cut_walkers_are_dead_at_the_cut():
    """A walker the segment cut stops before step ``cut`` is not a
    survivor; one the cut would stop AT step ``cut`` still is (phase B
    kills it) — the count follows the JAX surv plane."""
    c = _words_case()
    data, n = c["data"], len(c["data"])
    padded = pad_input(data, 1024, c["ms"])
    staged = _staged(c, padded, n)
    cut = max(1, len(c["pt"].steps) // 3)
    counts = {}
    for seg, halo in ((0, 0), (16, 0)):
        *_x, count = tplan.plan_scan_compact(
            staged, c["kt"], cut=cut, cap=CAP, seg_bytes=seg,
            halo_bytes=halo)
        *_y, jcount = _jax_compact(c, padded, n, seg, halo, cut, CAP)
        assert int(count) == int(jcount)
        counts[seg] = int(count)
    assert counts[16] < counts[0]


def test_phase_b_does_not_depend_on_slot_order():
    """The card appends survivors in no fixed order: any permutation of
    phase A's buffers gives phase B the same merged result."""
    c = _words_case()
    data, n = c["data"], len(c["data"])
    staged = _staged(c, pad_input(data, 1024, c["ms"]), n)
    cut = max(1, len(c["pt"].steps) // 3)
    kw = dict(cut=cut, cap=CAP, seg_bytes=1024, halo_bytes=16)
    want = tplan.plan_scan_plain(staged, c["kt"], seg_bytes=1024,
                                 halo_bytes=16)
    for emit in ("bitmap", "count"):
        res, (pos, disp, count) = tplan.plan_scan_compact_a(
            staged, c["kt"], emit=emit, shift=1, **kw)
        assert pos.dtype == disp.dtype == count.dtype == torch.int32
        assert pos.numel() == int(count) and bool((pos[1:] > pos[:-1]).all())
        perm = torch.from_numpy(
            np.random.default_rng(0).permutation(pos.numel()))
        tplan.planb_scan(staged, c["kt"], res, (pos[perm], disp[perm], count),
                         emit=emit, shift=1, **kw)
        if emit == "bitmap":
            assert torch.equal(res[0], want[0]) and torch.equal(res[1],
                                                                want[1])
        else:
            assert int(res) == int(tplan.plan_scan_plain(
                staged, c["kt"], emit="count", shift=1, seg_bytes=1024,
                halo_bytes=16))


# ---- the scanners ----------------------------------------------------------

OVER_CAP = 8192  # far below the dense corpus's survivors at step 1


def _dense_corpus(c):
    """The longest word over and over: every position that starts a
    prefix of it is live at step 1 (about 14,500 of 80,000).  The JAX
    package's own overflow test repeats ``words[0]``, a 2-byte word that
    the prologue finishes: no walker survives it and nothing overflows,
    so this corpus is not that one."""
    w = max(c["words"], key=len)
    return (w * (80_000 // len(w)))[:80_000]


def test_overflow_rescans_uncompacted():
    c = _words_case()
    dense = _dense_corpus(c)
    n = len(dense)
    padded = pad_input(dense, 1024, c["ms"])
    cfg = PfacConfig(width=1024, num_shards=1, truncation="none")
    staged = _staged(c, padded, n)
    _c, _b, count = tplan.plan_scan_compact(staged, c["kt"], cut=1, cap=OVER_CAP)
    *_j, jcount = _jax_compact(c, padded, n, 0, 0, 1, OVER_CAP)
    assert int(count) == int(jcount) > OVER_CAP  # reported, never clamped

    sc = _port_scanner(c, (1, OVER_CAP))
    before = tplan.overflow_rescans
    cnt, bits = sc.scan(padded, n, cfg, c["ms"])
    assert tplan.overflow_rescans == before + 1
    cnt0, bits0 = _port_scanner(c, "off").scan(padded, n, cfg, c["ms"])
    assert torch.equal(bits, bits0) and torch.equal(cnt, cnt0)
    js = jplan.PlanShardScanner(c["jc"].shards[0], interpret=True,
                                pt=c["jpt"], compact=(1, OVER_CAP))
    jcfg = JaxConfig(width=1024, num_shards=1, truncation="none")
    jcnt, jbits = map(np.asarray, js.scan(padded, n, jcfg, c["ms"]))
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    # the truncated result really was wrong: the check is what saves it
    assert not torch.equal(_b, bits0)


def _compact_calls(monkeypatch):
    """A list that grows by one with each ``plan_scan_compact`` call."""
    real, calls = tplan.plan_scan_compact, []
    monkeypatch.setattr(
        tplan, "plan_scan_compact",
        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


class _NoFetch:
    """Stands for the survivor count: converting it before ``armed`` is
    a host synchronisation that the dispatch must not make."""

    def __init__(self, value):
        self.value, self.armed, self.fetched = value, False, 0

    def __int__(self):
        assert self.armed, "scan_async fetched the survivor count"
        self.fetched += 1
        return self.value

    __index__ = __int__

    def item(self):
        return int(self)


def test_scan_async_does_not_fetch_the_count(monkeypatch):
    c = _words_case()
    data, n = c["data"], len(c["data"])
    padded = pad_input(data, 1024, c["ms"])
    cfg = PfacConfig(width=1024, num_shards=1, truncation="none")
    cut = len(c["pt"].steps) // 2
    real = tplan.plan_scan_compact
    seen = []

    def spy(*a, **k):
        cnt, bits, count = real(*a, **k)
        assert isinstance(count, torch.Tensor)
        seen.append(_NoFetch(int(count)))
        return cnt, bits, seen[-1]

    monkeypatch.setattr(tplan, "plan_scan_compact", spy)
    sc = _port_scanner(c, (cut, CAP))
    cnt, bits, verify = sc.scan_async(padded, n, cfg, c["ms"])
    assert len(seen) == 1 and seen[0].fetched == 0
    seen[0].armed = True
    cnt2, bits2 = verify()
    assert seen[0].fetched == 1
    assert cnt2 is cnt and bits2 is bits
    # an uncompacted scanner has the same interface and nothing to check
    cnt0, bits0, verify0 = _port_scanner(c, "off").scan_async(
        padded, n, cfg, c["ms"])
    assert verify0()[1] is bits0 and torch.equal(bits0, bits)


def test_count_scan_compacted_total_and_overflow(monkeypatch):
    c = _words_case()
    data, n = c["data"], len(c["data"])
    padded = pad_input(data, 1024, c["ms"])
    cut = max(1, len(c["pt"].steps) // 2)
    plain = _port_scanner(c, "off", cls=tplan.PlanCountScan,
                          args=(c["ms"],))
    comp = _port_scanner(c, (cut, CAP), cls=tplan.PlanCountScan,
                         args=(c["ms"],))
    calls = _compact_calls(monkeypatch)
    t0, t1 = int(plain(padded, n, 0)), int(comp(padded, n, 0))
    assert len(calls) == 1
    pats = [JaxPattern(i + 1, w) for i, w in enumerate(c["words"])]
    jcfg = JaxConfig(width=1024, num_shards=1, truncation="none")
    assert t0 == t1 == len(match_oracle(pats, data, jcfg))
    assert not comp.check_overflow()
    assert not plain.check_overflow()
    for shift in (0, 1):
        jtotal, jcount = _jax_compact(c, padded, n, 0, 0, cut, CAP,
                                      emit="count", shift=shift)
        total, count = tplan.plan_scan_compact(
            _staged(c, padded, n), c["kt"], cut=cut, cap=CAP, emit="count",
            shift=shift)
        assert total.dtype == torch.int64
        assert (int(total), int(count)) == (int(jtotal), int(jcount))
    # the dense corpus outruns the cap: the check says so, once
    dense = _dense_corpus(c)
    over = _port_scanner(c, (1, OVER_CAP), cls=tplan.PlanCountScan,
                         args=(c["ms"],))
    over(pad_input(dense, 1024, c["ms"]), len(dense), 0)
    assert over.check_overflow()
    assert not over.check_overflow()


def test_count_scan_chain_matches_jax():
    c = _words_case()
    data, n = c["data"], len(c["data"])
    padded = pad_input(data, 1024, c["ms"])
    cut = max(1, len(c["pt"].steps) // 2)
    for compact in ("off", (cut, CAP)):
        jsc = jplan.PlanCountScan(c["jc"].shards[0], c["ms"],
                                  interpret=True, pt=c["jpt"],
                                  compact=compact)
        jstaged = jsc.prepare(padded, n)
        sc = _port_scanner(c, compact, cls=tplan.PlanCountScan,
                           args=(c["ms"],))
        staged = sc.prepare(padded, n)
        for shift in (0, 1):
            want = int(np.asarray(jsc.scan_chain(jstaged, n, shift, 2)))
            assert int(sc.scan_chain(staged, n, shift, 2)) == want
        assert sc.check_overflow() == jsc.check_overflow() is False


# ---- fuzz ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_fuzz_compacted_scanner_vs_jax_and_plain(monkeypatch, seed):
    """Random dictionaries and corpora, a cut at every feasible step
    index mod the plan length, tiny caps included (the overflow rescan):
    always the uncompacted result, and the JAX scanner's."""
    rng = np.random.default_rng(2000 + seed)
    alpha = np.frombuffer(
        [b"ab", b"abcd", b"abcdefgh", b"abcdefghijklmnop"][seed % 4],
        dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(alpha[rng.integers(0, len(alpha), int(rng.integers(1, 14)))])
        for _ in range(int(rng.integers(5, 120)))
    ))
    data = bytes(alpha[rng.integers(0, len(alpha), 49_152)])
    seg, halo = ((0, 0), (512, 8))[seed % 2]
    kw = dict(width=1024, num_shards=1,
              truncation="segment" if seg else "none",
              segment_bytes=seg or 4096, halo_bytes=halo)
    jcfg, cfg = JaxConfig(**kw), PfacConfig(**kw)
    jc = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                     jcfg)
    jpt = jax_build_plan(jc.shards[0], train=data[:8192])
    n_steps = len(jpt.steps)
    if n_steps < 2:
        pytest.skip("single-step plan: nothing to compact")
    c = dict(words=words, width=1024, ms=padded_steps(jc.max_pat_len),
             pt=convert.plan_tables_from_arrays(
                 *jax_plan_arrays(jpt, "p_")))
    cut = 1 + (seed % (n_steps - 1))
    cap = 16384 if seed % 3 else 8192
    n = len(data)
    padded = pad_input(data, 1024, c["ms"])
    cnt0, bits0 = _port_scanner(c, "off").scan(padded, n, cfg, c["ms"])
    calls = _compact_calls(monkeypatch)
    cnt, bits = _port_scanner(c, (cut, cap)).scan(padded, n, cfg, c["ms"])
    assert len(calls) == 1
    assert torch.equal(bits, bits0) and torch.equal(cnt, cnt0)
    js = jplan.PlanShardScanner(jc.shards[0], interpret=True, pt=jpt,
                                compact=(cut, cap))
    jcnt, jbits = map(np.asarray, js.scan(padded, n, jcfg, c["ms"]))
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    if not seg:
        pats = [JaxPattern(i + 1, w) for i, w in enumerate(words)]
        assert int(cnt[:n].sum()) == len(match_oracle(pats, data, jcfg))


def test_compact_wrapper_rejects_bad_arguments():
    c = _words_case()
    padded = pad_input(c["data"], 1024, c["ms"])
    staged = _staged(c, padded, len(c["data"]))
    n_steps = len(c["pt"].steps)
    for cut in (0, n_steps, n_steps + 1):
        with pytest.raises(ValueError):
            tplan.plan_scan_compact(staged, c["kt"], cut=cut, cap=CAP)
    with pytest.raises(ValueError):
        tplan.plan_scan_compact(staged, c["kt"], cut=1, cap=CAP,
                                emit="rows")
    with pytest.raises(ValueError):
        tplan.plan_scan_compact(staged.to("meta"), c["kt"], cut=1, cap=CAP)


# ---- phase B (K6): its plain version, its descriptors, its wrapper ---------

@pytest.mark.parametrize("seg,halo", [(0, 0), (1024, 16)])
@pytest.mark.parametrize("which", ["words", "sigs"])
def test_planb_plain_equals_jax_phase_b(which, seg, halo):
    """``planb_scan_plain`` against the JAX phase B itself (``_phase_b``:
    the glue and ``_make_planb_kernel`` in interpret mode) on the same
    survivors: the same deep bits at the same positions, and the same
    count."""
    c = _words_case() if which == "words" else _sig_case()
    data, n = c["data"], len(c["data"])
    padded = pad_input(data, 1024, c["ms"])
    staged = _staged(c, padded, n)
    n_pos = staged.numel() - 1024
    cut = max(1, len(c["pt"].steps) // 3)
    kw = dict(cut=cut, cap=CAP, seg_bytes=seg, halo_bytes=halo)
    _res, surv = tplan.plan_scan_compact_a_plain(staged, c["kt"], **kw)
    assert 0 < int(surv[2]) <= CAP
    cnt = torch.zeros(n_pos, dtype=torch.int32)
    bits = torch.zeros(n_pos, dtype=torch.int32)
    tplan.planb_scan_plain(staged, c["kt"], (cnt, bits), surv, **kw)

    jpt = c["jpt"]
    assert jpt.p0_miss == 0  # the JAX survivor plane's dead value
    plane = np.zeros(n_pos, np.int32)
    plane[surv[0].numpy()] = surv[1].numpy()
    js = jplan.PlanShardScanner(c["jc"].shards[0], interpret=True, pt=jpt,
                                compact="off")
    data2d = jplan.stage_pairs(
        jnp.asarray(padded), jnp.asarray(np.int32(n)), js._code,
        n_rows=jplan.staged_rows(len(padded) - c["ms"]), cb=jpt.code_bits)
    with jplan._eager_if(True):
        bits_b, pos, count = jplan._phase_b(
            data2d, jnp.asarray(plane), jnp.asarray(jpt.packed_banks),
            jnp.asarray(jpt.side_banks), steps_b=jpt.steps[cut:],
            cb=jpt.code_bits, p0_miss=jpt.p0_miss, interpret=True,
            grouped=jpt.trained, gmode=jplan._default_gmode(),
            seg_bytes=seg, halo_bytes=halo, cap=CAP, tpc_b=8)
    pos, bits_b = np.asarray(pos), np.asarray(bits_b)
    keep = pos < n_pos
    want = np.zeros(n_pos, np.int32)
    want[pos[keep]] = bits_b[keep]
    assert int(count) == int(surv[2])
    assert want.any()  # the deep steps find matches here
    np.testing.assert_array_equal(bits.numpy(), want)
    np.testing.assert_array_equal(
        cnt.numpy(), tplan.popcount32(torch.from_numpy(want).to(
            torch.int64)).numpy())


def test_planb_descriptors_are_built_once_a_cut():
    """K6's descriptors: ``step_descriptors(spec[cut:])``, the rows of
    the whole walk's from the cut on, kept per cut on the tables; a copy
    of the tables starts with none."""
    c = _words_case()
    kt = tplan.PlanKernelTables.from_plan(c["pt"], "cpu")
    n_steps = len(kt.spec)
    assert n_steps >= 3
    first = kt.deep_desc(1)
    np.testing.assert_array_equal(
        first, tplan.step_descriptors(kt.spec[1:], kt.cb, kt.p0_miss))
    np.testing.assert_array_equal(first, kt.desc[1:])
    assert kt.deep_desc(1) is first
    last = kt.deep_desc(n_steps - 1)
    assert last.shape == (1, len(tplan.STEP_DESC_FIELDS))
    np.testing.assert_array_equal(
        last, tplan.step_descriptors(kt.spec[-1:], kt.cb, kt.p0_miss))
    assert kt.deep_desc(1) is first and kt.deep_desc(n_steps - 1) is last
    assert last.flags.c_contiguous and not last.flags.writeable
    other = dataclasses.replace(kt, packed=kt.packed.clone())
    assert other.deep_desc(1) is not first
    # the tables' operands are checked where the descriptors are built
    bad = dataclasses.replace(kt, side=kt.side.to(torch.int64))
    with pytest.raises(ValueError, match="side"):
        bad.deep_desc(1)


def _planb_call(emit="bitmap"):
    """A K6 wrapper call that passes every check: (staged, tables,
    result, survivors, keyword arguments), all on the CPU."""
    c = _words_case()
    staged = _staged(c, pad_input(c["data"], 1024, c["ms"]),
                     len(c["data"]))
    kw = dict(cut=1, cap=CAP, emit=emit, seg_bytes=0, halo_bytes=0,
              shift=0, prev_total=None)
    res, (pos, disp, count) = tplan.plan_scan_compact_a_plain(
        staged, c["kt"], cut=1, cap=CAP, emit=emit)
    pad = torch.zeros(CAP - pos.numel(), dtype=torch.int32)
    surv = (torch.cat([pos, pad]), torch.cat([disp, pad]), count)
    return staged, c["kt"], res, surv, kw


def _bad_operands():
    """(what, emit, how to spoil a good call) for every operand K6's
    wrapper checks on each call."""
    i64 = torch.int64

    def stale(x):  # a strided view: not contiguous
        return torch.stack([x, x], -1)[..., 0]

    return [
        ("staged", "bitmap", lambda a: a.update(staged=a["staged"].to(i64))),
        ("staged", "bitmap", lambda a: a.update(staged=stale(a["staged"]))),
        ("tables", "bitmap", lambda a: a.update(
            staged=a["staged"].to("meta"))),
        ("surv_pos", "bitmap", lambda a: a.update(surv=(
            a["surv"][0].to(i64), *a["surv"][1:]))),
        ("surv_disp", "bitmap", lambda a: a.update(surv=(
            a["surv"][0], stale(a["surv"][1]), a["surv"][2]))),
        ("cap", "bitmap", lambda a: a.update(surv=(
            a["surv"][0][:100], a["surv"][1][:100], a["surv"][2]))),
        ("count", "bitmap", lambda a: a.update(surv=(
            *a["surv"][:2], a["surv"][2].to(i64)))),
        ("cnt", "bitmap", lambda a: a.update(result=(
            stale(a["result"][0]), a["result"][1]))),
        ("bits", "bitmap", lambda a: a.update(result=(
            a["result"][0], a["result"][1].to(i64)))),
        ("total", "count", lambda a: a.update(
            result=a["result"].to(torch.int32))),
        ("prev_total", "count", lambda a: a["kw"].update(
            prev_total=torch.zeros(1, dtype=torch.int32))),
    ]


@pytest.mark.parametrize("what,emit,spoil", _bad_operands(),
                         ids=[f"{w}-{i}" for i, (w, _e, _s)
                              in enumerate(_bad_operands())])
def test_planb_wrapper_refuses_each_bad_operand(what, emit, spoil):
    """The K6 wrapper's own checks, before any launch: each operand a
    call brings, and tables on another device than the stream."""
    staged, kt, res, surv, kw = _planb_call(emit)
    a = dict(staged=staged, result=res, surv=surv, kw=kw)
    spoil(a)
    with pytest.raises(ValueError):
        tplan._planb_scan_cuda(a["staged"], kt, a["result"], a["surv"],
                               **a["kw"])
