"""CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA GPU and skips without one.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs, compared exactly (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from phfpfac_tpu_torch import Matcher, PfacConfig, compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import depth as K2
from phfpfac_tpu_torch.ops import engine_select
from phfpfac_tpu_torch.ops import pair as K3
from phfpfac_tpu_torch.ops import plan as K1
from phfpfac_tpu_torch.ops import scan as K4
from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
from phfpfac_tpu_torch.ops.staging import to_device_bytes
from phfpfac_tpu_torch.oracle.ac import match_oracle

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _dictionary(name):
    """Dense p0 + nibble/byte pair steps, s0 + pair steps, or s0x."""
    rng = np.random.default_rng(0)
    if name == "s0x":
        raw = rng.integers(0, 256, (4000, 16), dtype=np.uint8).tobytes()
        words = list(dict.fromkeys(
            raw[i * 16: i * 16 + 3 + int(rng.integers(0, 6))]
            for i in range(4000)))
        data = bytearray(rng.integers(0, 256, 1 << 16, dtype=np.uint8))
    else:
        alpha = np.frombuffer(b"abcdefghijkl" if name == "dense"
                              else bytes(range(48, 80)), dtype=np.uint8)
        words = list(dict.fromkeys(
            bytes(alpha[rng.integers(0, len(alpha),
                                     int(rng.integers(1, 16)))])
            for _ in range(800)))
        data = bytearray(alpha[rng.integers(0, len(alpha), 1 << 16)])
    for i in range(0, len(data) - 16, 61):
        w = words[i % len(words)]
        data[i: i + len(w)] = w
    return words, bytes(data)


def _scanners(name, dev, train):
    words, data = _dictionary(name)
    cfg = PfacConfig(width=4096, num_shards=1)
    sh = compile_patterns([Pattern(i + 1, w) for i, w in enumerate(words)],
                          cfg).shards[0]
    ms = padded_steps(sh.max_pat_len)
    padded = to_device_bytes(pad_input(data, 1024, ms), dev)
    ps = K1.PlanShardScanner(sh, device=dev,
                             train=data[:8192] if train else None)
    ds = K2.DepthShardScanner(sh, device=dev)
    return (ps, ps.stage(padded, len(data), ms),
            ds, ds.stage(padded, len(data), ms), len(data))


GEOMS = [(0, 0), (64, 0), (128, 4), (4096, 512)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["dense", "s0", "s0x"])
def test_plan_kernel_equals_plain(name, train, dev):
    ps, staged, _ds, _st2, _n = _scanners(name, dev, train)
    before = K1.launches
    for seg, halo in GEOMS:
        got = K1.plan_scan(staged, ps.tables, seg_bytes=seg, halo_bytes=halo)
        want = K1.plan_scan_plain(staged, ps.tables, seg_bytes=seg,
                                  halo_bytes=halo)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[0].sum()) > 0
    prev = None
    for shift in (0, 1, 0):
        got = K1.plan_scan(staged, ps.tables, emit="count", shift=shift,
                           prev_total=prev)
        want = K1.plan_scan_plain(staged, ps.tables, emit="count",
                                  shift=shift, prev_total=prev)
        assert int(got) == int(want)
        prev = got
    torch.cuda.synchronize()
    assert K1.launches == before + len(GEOMS) + 3


@pytest.mark.parametrize("name", ["dense", "s0x"])
def test_depth_kernel_equals_plain_and_plan(name, dev):
    ps, pstaged, ds, staged, n = _scanners(name, dev, False)
    before = K2.launches
    for seg, halo in GEOMS + [(100, 3)]:
        got = K2.depth_scan(staged, ds.tables, input_size=n, seg_bytes=seg,
                            halo_bytes=halo)
        want = K2.depth_scan_plain(staged, ds.tables, input_size=n,
                                   seg_bytes=seg, halo_bytes=halo)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if seg & (seg - 1) == 0:  # the plan kernel takes these too
            plan_bits = K1.plan_scan(pstaged, ps.tables, seg_bytes=seg,
                                     halo_bytes=halo)[1]
            assert torch.equal(got[1][:n], plan_bits[:n])
    got = K2.depth_scan(staged, ds.tables, input_size=n, emit="count",
                        shift=1)
    assert int(got) == int(K2.depth_scan_plain(staged, ds.tables,
                                               input_size=n, emit="count",
                                               shift=1))
    assert K2.launches == before + len(GEOMS) + 2


def test_wrappers_refuse_bad_inputs(dev):
    ps, staged, ds, dstaged, n = _scanners("dense", dev, False)
    with pytest.raises(ValueError):
        K1.plan_scan(staged.to(torch.int64), ps.tables)
    with pytest.raises(ValueError):
        K1.plan_scan(staged, ps.tables, seg_bytes=100)
    with pytest.raises(ValueError):
        K2.depth_scan(dstaged[:, :64], ds.tables, input_size=n)


def _shards(name, dev, shards):
    words, data = _dictionary(name)
    cfg = PfacConfig(width=4096, num_shards=shards)
    compiled = compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)], cfg)
    ms = padded_steps(compiled.max_pat_len)
    padded = to_device_bytes(pad_input(data, 1024, ms), dev)
    return compiled, padded, len(data), ms


@pytest.mark.parametrize("name", ["dense", "s0"])
def test_pair_kernel_equals_plain_and_plan(name, dev):
    compiled, padded, n, ms = _shards(name, dev, 1)
    sh = compiled.shards[0]
    sc = K3.PairShardScanner(sh, device=dev)
    staged = sc.stage(padded, n, ms)
    before = K3.launches
    for dead_exit in (sc.tables.dead_exit, False):
        sc.tables.dead_exit = dead_exit  # both walks: with and without exit
        got = K3.pair_scan(staged, sc.tables)
        want = K3.pair_scan_plain(staged, sc.tables)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[0].sum()) > 0
        for shift in (0, 1, 5):
            assert int(K3.pair_scan(staged, sc.tables, emit="count",
                                    shift=shift)) == \
                int(K3.pair_scan_plain(staged, sc.tables, emit="count",
                                       shift=shift))
    ps = K1.PlanShardScanner(sh, device=dev)
    plan_bits = K1.plan_scan(ps.stage(padded, n, ms), ps.tables)[1]
    assert torch.equal(got[1][:n], plan_bits[:n])
    torch.cuda.synchronize()
    assert K3.launches == before + 8


@pytest.mark.parametrize("name", ["dense", "s0x"])
def test_phf_kernels_equal_plain(name, dev):
    compiled, padded, n, ms = _shards(name, dev, 3)
    multi = K4.MultiShardScanner(compiled.shards, device=dev)
    singles = [K4.PallasShardScanner(sh, device=dev)
               for sh in compiled.shards]
    before, before_multi = K4.launches, K4.launches_multi
    kw = dict(input_size=n, max_steps=ms)
    for seg, halo in GEOMS + [(100, 3)]:
        g = dict(seg_bytes=seg, halo_bytes=halo, **kw)
        got = K4.phf_scan_multi(padded, multi.tables, **g)
        want = K4.phf_scan_multi_plain(padded, multi.tables, **g)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[0].sum()) > 0
        for s, one in enumerate(singles):
            c, b = K4.phf_scan(padded, one.tables, **g)
            cp, bp = K4.phf_scan_plain(padded, one.tables, **g)
            assert torch.equal(c, cp) and torch.equal(b, bp)
            assert torch.equal(b, got[1][s])
        assert int(K4.phf_scan_multi(padded, multi.tables, emit="count",
                                     shift=3, **g)) == \
            int(K4.phf_scan_multi_plain(padded, multi.tables, emit="count",
                                        shift=3, **g))
    for one in singles:
        assert int(K4.phf_scan(padded, one.tables, emit="count", shift=1,
                               **kw)) == \
            int(K4.phf_scan_plain(padded, one.tables, emit="count", shift=1,
                                  **kw))
    # without the early exit the walk gives the same bits
    multi.tables.dead_exit = False
    got2 = K4.phf_scan_multi(padded, multi.tables, **kw)
    want2 = K4.phf_scan_multi_plain(padded, multi.tables, **kw)
    assert torch.equal(got2[1], want2[1])
    torch.cuda.synchronize()
    n_geoms = len(GEOMS) + 1
    assert K4.launches == before + 3 * n_geoms + 3
    assert K4.launches_multi == before_multi + 2 * n_geoms + 1


def test_new_wrappers_refuse_bad_inputs(dev):
    compiled, padded, n, ms = _shards("dense", dev, 1)
    sh = compiled.shards[0]
    pair = K3.PairShardScanner(sh, device=dev)
    staged = pair.stage(padded, n, ms)
    with pytest.raises(ValueError):
        K3.pair_scan(staged.to(torch.int64), pair.tables)
    with pytest.raises(ValueError):
        K3.pair_scan(staged[:, :64], pair.tables)
    cpu_tables = K3.PairShardScanner(sh, device="cpu").tables
    with pytest.raises(ValueError):
        K3.pair_scan(staged, cpu_tables)  # tables on another device
    phf = K4.PallasShardScanner(sh, device=dev)
    kw = dict(input_size=n, max_steps=ms)
    with pytest.raises(ValueError):
        K4.phf_scan(padded.to(torch.int32), phf.tables, **kw)
    with pytest.raises(ValueError):
        K4.phf_scan(padded[:-1], phf.tables, **kw)
    with pytest.raises(ValueError):
        K4.phf_scan(padded, phf.tables, input_size=n, max_steps=40)
    with pytest.raises(ValueError):
        K4.phf_scan(padded, K4.PallasShardScanner(sh, device="cpu").tables,
                    **kw)


@pytest.mark.parametrize("engine", ["turbo", "jnp"])
@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_torch_engines_on_cuda_equal_oracle(trunc, engine, dev):
    words, data = _dictionary("dense")
    cfg = PfacConfig(width=256, num_shards=2, truncation=trunc,
                     segment_bytes=512, halo_bytes=8)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    m = Matcher(compile_patterns(pats, cfg), cfg, engine=engine)
    data = data[:20000]
    got = [tuple(x) for x in m.match(data)]
    assert got == match_oracle(pats, data, cfg)
    assert int(m.count_matches(data).sum()) == len(got)


def test_count_scanners_on_cuda_agree(dev):
    compiled, padded, n, ms = _shards("dense", dev, 1)
    sh = compiled.shards[0]
    best = engine_select.best_count_scanner(sh, ms)
    assert isinstance(best, K1.PlanCountScan)
    want = int(best(padded, n, 1))
    for make in (K3.pair_count_scanner, K2.depth_count_scanner,
                 K4.pallas_count_scanner, engine_select.xla_count_scanner):
        assert int(make(sh, ms, device=dev)(padded, n, 1)) == want


def test_matcher_multi_and_pair_routes_on_cuda(dev, monkeypatch):
    from phfpfac_tpu_torch.compile.pair import PairUnsupported
    from phfpfac_tpu_torch.parallel import matcher as M

    words, data = _dictionary("dense")
    data = data[:20000]
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    cfg = PfacConfig(width=256, num_shards=3, truncation="none")
    want = match_oracle(pats, data, cfg)

    def refuse(*a, **k):
        raise PairUnsupported("refused for the test")

    monkeypatch.setattr(M, "PlanShardScanner", refuse)
    before = K3.launches
    m = Matcher(compile_patterns(pats, cfg), cfg)
    assert [tuple(x) for x in m.match_chunked(data, chunk_bytes=4096)] == want
    assert K3.launches > before
    monkeypatch.setattr(Matcher, "_shard_scanner_one",
                        lambda self, shard, pt=None: None)
    before = K4.launches_multi
    m = Matcher(compile_patterns(pats, cfg), cfg)
    assert [tuple(x) for x in m.match_chunked(data, chunk_bytes=4096)] == want
    assert K4.launches_multi > before


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_matcher_on_cuda_equals_oracle(trunc, dev):
    words, data = _dictionary("dense")
    cfg = PfacConfig(width=256, num_shards=4, truncation=trunc,
                     segment_bytes=512, halo_bytes=8)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    m = Matcher(compile_patterns(pats, cfg), cfg)
    assert m.device.type == "cuda"
    data = data[:20000]
    got = [tuple(x) for x in m.match_chunked(data, chunk_bytes=4096)]
    assert got == match_oracle(pats, data, cfg)


# ---- the compacted plan scan: K1' (plan_scan_compact_a) and K6 (planb_scan)

def _sorted_survivors(surv, cap):
    pos, disp, count = surv
    n = min(int(count), cap)
    order = torch.argsort(pos[:n])
    return pos[:n][order], disp[:n][order]


def _fit_cap(count: int) -> int:
    return (count // K1.COMPACT_BLOCK + 1) * K1.COMPACT_BLOCK


@pytest.mark.parametrize("emit", ["bitmap", "count"])
@pytest.mark.parametrize("name", ["dense", "s0", "s0x"])
def test_compacted_kernels_equal_plain(name, emit, dev):
    """K1' alone, K6 alone on the plain version's survivors, and the
    pair, at a cap a little above the survivor count; segment cuts small
    enough that walkers die of the cut on both sides of the compaction
    cut."""
    ps, staged, _ds, _st2, _n = _scanners(name, dev, True)
    t = ps.tables
    n_steps = len(t.spec)
    assert n_steps >= 2
    a0, b0 = K1.launches_compact_a, K1.launches_compact_b
    runs = 0
    for cut in sorted({1, max(1, n_steps // 2), n_steps - 1}):
        for seg, halo in GEOMS:
            kw = dict(cut=cut, emit=emit, seg_bytes=seg, halo_bytes=halo,
                      shift=1)
            _res, all_surv = K1.plan_scan_compact_a_plain(
                staged, t, cap=1 << 30, **kw)
            count = int(all_surv[2])
            cap = _fit_cap(count)
            want_res, want_surv = K1.plan_scan_compact_a_plain(
                staged, t, cap=cap, **kw)
            res, surv = K1.plan_scan_compact_a(staged, t, cap=cap, **kw)
            assert int(surv[2]) == count and surv[0].numel() >= count
            if emit == "bitmap":
                assert torch.equal(res[0], want_res[0])
                assert torch.equal(res[1], want_res[1])
            else:
                assert int(res) == int(want_res)
            gp, gd = _sorted_survivors(surv, cap)
            wp, wd = _sorted_survivors(want_surv, cap)
            assert torch.equal(gp, wp) and torch.equal(gd, wd)
            # K6 on the plain version's survivors, padded to cap
            pad = torch.zeros(cap - wp.numel(), dtype=torch.int32,
                              device=dev)
            fed = (torch.cat([want_surv[0], pad]),
                   torch.cat([want_surv[1], pad]), want_surv[2])
            K1.planb_scan(staged, t, res, fed, cap=cap, **kw)
            K1.planb_scan_plain(staged, t, want_res, want_surv, cap=cap,
                                **kw)
            whole = K1.plan_scan(staged, t, emit=emit, seg_bytes=seg,
                                 halo_bytes=halo, shift=1)
            if emit == "bitmap":
                assert torch.equal(res[0], want_res[0])
                assert torch.equal(res[1], want_res[1])
                assert torch.equal(res[1], whole[1])
            else:
                assert int(res) == int(want_res) == int(whole)
            # the pair through its own wrapper, unordered slots and all
            got = K1.plan_scan_compact(staged, t, cap=cap, **kw)
            assert int(got[-1]) == count
            if emit == "bitmap":
                assert torch.equal(got[0], whole[0])
                assert torch.equal(got[1], whole[1])
            else:
                assert int(got[0]) == int(whole)
            runs += 1
    torch.cuda.synchronize()
    assert K1.launches_compact_a == a0 + 2 * runs
    assert K1.launches_compact_b == b0 + 2 * runs


def _clone(res):
    return tuple(x.clone() for x in res) if isinstance(res, tuple) \
        else res.clone()


def _k6_equals_plain(staged, t, res, surv, **kw):
    """K6 and its plain version on copies of phase A's result ``res``:
    the same merged result, bit for bit."""
    got, want = _clone(res), _clone(res)
    K1.planb_scan(staged, t, got, surv, **kw)
    K1.planb_scan_plain(staged, t, want, surv, **kw)
    if isinstance(got, tuple):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert int(got) == int(want)


def _fed(pos, disp, cap, count=None):
    """Survivor buffers of ``cap`` entries holding ``pos`` / ``disp``
    first, and their count (the entries' number unless given)."""
    pad = torch.zeros(max(0, cap - pos.numel()), dtype=torch.int32,
                      device=pos.device)
    n = pos.numel() if count is None else count
    return (torch.cat([pos, pad]), torch.cat([disp, pad]),
            torch.tensor(n, dtype=torch.int32, device=pos.device))


@pytest.mark.parametrize("seg", [(0, 0), (4096, 512)])
@pytest.mark.parametrize("emit", ["bitmap", "count"])
def test_planb_kernel_at_every_survivor_count(emit, seg, dev):
    """K6 against its plain version on phase A's result and survivors:
    none, one, the window's last ones (their windows read up to pos + 31,
    past the input into the staged spare tile), cap = count, cap = 8 x
    count, count > cap, and in count mode a chain that reads each last
    total; the survivors of a window where most walk to the last step."""
    ps, staged = _deep_window(dev, tail=True)
    t = ps.tables
    n_pos = staged.numel() - 1024
    kw = dict(cut=2, emit=emit, seg_bytes=seg[0], halo_bytes=seg[1],
              shift=1)
    res, (pos, disp, count) = K1.plan_scan_compact_a_plain(
        staged, t, cap=n_pos, **kw)
    n = int(count)
    assert n > 64 and int(pos[-1]) >= n_pos - 32
    b0 = K1.launches_compact_b
    block = K1.COMPACT_BLOCK
    cases = [(pos[:0], disp[:0], block), (pos[:1], disp[:1], block),
             (pos[-32:], disp[-32:], block), (pos, disp, n),
             (pos, disp, 8 * n)]
    for p, d, cap in cases:
        _k6_equals_plain(staged, t, res, _fed(p, d, cap), cap=cap, **kw)
    # count > cap: the buffers hold the first cap, the count is the true
    cap = n // 3
    _k6_equals_plain(staged, t, res, _fed(pos[:cap], disp[:cap], cap, n),
                     cap=cap, **kw)
    calls = len(cases) + 1
    if emit == "count":
        surv = _fed(pos, disp, n)
        got = [res.clone() for _ in range(3)]
        want = [res.clone() for _ in range(3)]
        for k in range(3):  # each scan's shift parity from the last total
            K1.planb_scan(staged, t, got[k], surv, cap=n,
                          prev_total=got[k - 1] if k else None, **kw)
            K1.planb_scan_plain(staged, t, want[k], surv, cap=n,
                                prev_total=want[k - 1] if k else None, **kw)
            assert int(got[k]) == int(want[k])
        calls += 3
    torch.cuda.synchronize()
    assert K1.launches_compact_b == b0 + calls


def test_compacted_chain_reads_the_previous_total(dev):
    ps, staged, _ds, _st2, _n = _scanners("dense", dev, True)
    t = ps.tables
    cut = max(1, len(t.spec) // 2)
    for prev in (4, 7):
        p = torch.tensor([prev], dtype=torch.int64, device=dev)
        for shift in (0, 1):
            got, count = K1.plan_scan_compact(
                staged, t, cut=cut, cap=65536, emit="count", shift=shift,
                prev_total=p)
            want = K1.plan_scan_plain(staged, t, emit="count", shift=shift,
                                      prev_total=p)
            assert int(got) == int(want) and int(count) <= 65536


def test_compacted_overflow_is_reported_and_rescanned(dev):
    """A cap far below the survivors: the count is the true one, the
    wrapper's result is incomplete, the scanner's is not."""
    words, data = _dictionary("dense")
    data = data * 8
    cfg = PfacConfig(width=4096, num_shards=1, truncation="none")
    sh = compile_patterns([Pattern(i + 1, w) for i, w in enumerate(words)],
                          cfg).shards[0]
    ms = padded_steps(sh.max_pat_len)
    padded = to_device_bytes(pad_input(data, 1024, ms), dev)
    cap = K1.COMPACT_BLOCK
    sc = K1.PlanShardScanner(sh, device=dev, train=data[:8192],
                             compact=(1, cap))
    staged = sc.stage(padded, len(data), ms)
    _c, bits, count = K1.plan_scan_compact(staged, sc.tables, cut=1, cap=cap)
    _r, surv = K1.plan_scan_compact_a_plain(staged, sc.tables, cut=1,
                                            cap=1 << 30)
    assert int(count) == int(surv[2]) > 2 * cap
    whole = K1.plan_scan(staged, sc.tables)
    assert not torch.equal(bits, whole[1])
    before = K1.overflow_rescans
    cnt, bits = sc.scan(padded, len(data), cfg, ms)
    assert K1.overflow_rescans == before + 1
    assert torch.equal(bits, whole[1]) and torch.equal(cnt, whole[0])
    cs = K1.PlanCountScan(sh, ms, device=dev, train=data[:8192],
                          compact=(1, cap))
    cs(padded, len(data), 0)
    assert cs.check_overflow() and not cs.check_overflow()
    with pytest.raises(ValueError):
        K1.planb_scan(staged, sc.tables, whole,
                      (surv[0][:100], surv[1][:100], surv[2]), cut=1,
                      cap=cap)


def test_matcher_compacts_on_cuda_with_the_opt_in(dev, monkeypatch):
    words, data = _dictionary("dense")
    cfg = PfacConfig(width=256, num_shards=2, truncation="segment",
                     segment_bytes=512, halo_bytes=8)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    compiled = compile_patterns(pats, cfg)
    want = match_oracle(pats, data, cfg)
    monkeypatch.setenv(K1.AUTO_OPT_IN, "1")
    a0, b0 = K1.launches_compact_a, K1.launches_compact_b
    m = Matcher(compiled, cfg, train=data[:8192])
    assert [tuple(x) for x in m.match(data)] == want
    assert K1.launches_compact_a == a0 + 2
    assert K1.launches_compact_b == b0 + 2
    staged = m.stage_for_chunked(data, chunk_bytes=8192)
    assert staged.device.type == "cuda"
    got = m.match_chunked(data, chunk_bytes=8192, device_data=staged)
    assert [tuple(x) for x in got] == want


# ---- the tile kernel's geometry: tile edges, mesh-cell views, deep lists ---

def _plan_scanner(words, data, dev, train=None):
    """(plan scanner, staged stream) of ``words`` over ``data``."""
    cfg = PfacConfig(width=4096, num_shards=1)
    sh = compile_patterns([Pattern(i + 1, w) for i, w in enumerate(words)],
                          cfg).shards[0]
    ms = padded_steps(sh.max_pat_len)
    ps = K1.PlanShardScanner(sh, device=dev, train=train)
    padded = to_device_bytes(pad_input(data, 1024, ms), dev)
    return ps, ps.stage(padded, len(data), ms)


def _held_to_plain(staged, t, geoms):
    """Every mode of K1 on ``staged`` against the plain version: bitmap
    at each (seg, halo), count with a shift, a chain of 8.  -> launches."""
    calls = 0
    for seg, halo in geoms:
        got = K1.plan_scan(staged, t, seg_bytes=seg, halo_bytes=halo)
        want = K1.plan_scan_plain(staged, t, seg_bytes=seg, halo_bytes=halo)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        calls += 1
    assert int(K1.plan_scan(staged, t, emit="count", shift=1)) == \
        int(K1.plan_scan_plain(staged, t, emit="count", shift=1))
    calls += 1
    prev = want_prev = None
    for _ in range(8):  # a chain: each shift parity from the last total
        prev = K1.plan_scan(staged, t, emit="count", prev_total=prev)
        want_prev = K1.plan_scan_plain(staged, t, emit="count",
                                       prev_total=want_prev)
        assert int(prev) == int(want_prev)
        calls += 1
    return calls


@pytest.mark.parametrize("n_pos", [K1.PLAN_TILE, K1.PLAN_TILE + 1024,
                                   1 << 16])
@pytest.mark.parametrize("name", ["dense", "s0", "s0x"])
def test_tile_kernel_equals_plain_at_every_tile_geometry(name, n_pos, dev):
    """One tile, a partial last tile, many tiles; and a mesh cell's view
    of the staged stream at an offset (parallel/mesh_pallas.py
    _cell_window: a block of positions plus its 1,024-position halo)."""
    words, data = _dictionary(name)
    ps, staged = _plan_scanner(words, data[:n_pos], dev)
    assert staged.numel() - 1024 == n_pos
    before = K1.launches
    geoms = [(0, 0), (64, 0), (4096, 512)]
    calls = _held_to_plain(staged, ps.tables, geoms)
    if n_pos >= 4 * K1.PLAN_TILE:
        block = 2 * K1.PLAN_TILE
        cell = staged.reshape(-1)[block:2 * block + 1024]
        assert cell.data_ptr() % 16 == 0
        calls += _held_to_plain(cell, ps.tables, geoms)
    torch.cuda.synchronize()
    assert K1.launches == before + calls  # one launch per call


def _deep_window(dev, tail=False):
    """All 32 rotations of one 32 B pattern over that pattern repeated,
    then random text: in the first half every walker lives through every
    step, so the packed lists stay full for 31 rounds.  With ``tail`` the
    text ends with the pattern twice, at the end of a whole number of
    staging tiles, so walkers live at the window's last positions."""
    rng = np.random.default_rng(5)
    pat = bytes(rng.integers(97, 123, 32, dtype=np.uint8))
    words = list(dict.fromkeys(pat[i:] + pat[:i] for i in range(32)))
    words += [bytes(rng.integers(97, 123, int(rng.integers(2, 9)),
                                 dtype=np.uint8)) for _ in range(300)]
    data = pat * 1024 + bytes(rng.integers(97, 123, 1 << 15, dtype=np.uint8))
    if tail:
        data = data[:-64] + pat * 2
    return _plan_scanner(words, data, dev)


def test_tile_kernel_on_a_window_of_deep_walkers(dev):
    ps, staged = _deep_window(dev)
    t = ps.tables
    assert len(t.spec) >= 8
    before = K1.launches
    calls = _held_to_plain(staged, t, [(0, 0), (4096, 512), (64, 0)])
    bits = K1.plan_scan(staged, t)[1]
    calls += 1
    assert int(((bits[:1 << 15] >> 31) & 1).sum()) == (1 << 15) - 31
    torch.cuda.synchronize()
    assert K1.launches == before + calls


@pytest.mark.parametrize("deep", [False, True])
def test_compacted_survivors_as_sets_with_and_without_overflow(deep, dev):
    """K1′'s survivors against the plain version's: the same sorted set
    at a cap that holds them; at a cap that overflows, the true count and
    ``cap`` distinct members of that set."""
    if deep:
        ps, staged = _deep_window(dev)
    else:
        ps, staged, _ds, _st2, _n = _scanners("dense", dev, True)
    t = ps.tables
    before = K1.launches_compact_a
    for cut in sorted({1, max(1, len(t.spec) // 2)}):
        for seg, halo in ((0, 0), (4096, 512)):
            kw = dict(cut=cut, seg_bytes=seg, halo_bytes=halo)
            want, wsurv = K1.plan_scan_compact_a_plain(staged, t, cap=1 << 30,
                                                       **kw)
            count = int(wsurv[2])
            assert count >= 3
            wp, wd = _sorted_survivors(wsurv, count)
            for cap in (_fit_cap(count), count // 3):
                got, surv = K1.plan_scan_compact_a(staged, t, cap=cap, **kw)
                assert torch.equal(got[1], want[1])
                assert int(surv[2]) == count
                gp, gd = _sorted_survivors(surv, cap)
                if cap >= count:
                    assert torch.equal(gp, wp) and torch.equal(gd, wd)
                else:
                    assert gp.numel() == cap
                    assert torch.unique(gp).numel() == cap
                    at = torch.searchsorted(wp, gp)
                    assert torch.equal(wp[at], gp) and torch.equal(wd[at], gd)
    torch.cuda.synchronize()
    assert K1.launches_compact_a > before


def test_plan_kernel_refuses_a_misaligned_staged_view(dev):
    ps, staged, _ds, _st2, _n = _scanners("dense", dev, False)
    flat = staged.reshape(-1)
    view = flat[1:flat.numel() - 1023]
    assert view.data_ptr() % 16
    before = K1.launches
    with pytest.raises(ValueError, match="aligned"):
        K1.plan_scan(view, ps.tables)
    with pytest.raises(ValueError, match="aligned"):
        K1.plan_scan_compact_a(view, ps.tables, cut=1, cap=8192)
    assert K1.launches == before


# ---- the probes: P1 (probe_gather) and P2 (probe_compact, probe_copy) ------

@pytest.mark.parametrize("arm", ["i32", "i16", "i8", "packed", "alu"])
def test_gather_probe_equals_plain(arm, dev):
    from phfpfac_tpu_torch.probes import gather

    rng = np.random.default_rng(1)
    host = gather.make_table(rng, arm, 1 << 16)
    table = None if host is None else torch.from_numpy(host).to(dev)
    idx = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, 1 << 15).astype(np.int32)).to(dev)
    for k in gather.KS:
        for mul in (1, gather.SCATTER):
            before = gather.launches
            got = gather.probe_gather(table, idx, arm=arm, reps=7, k=k,
                                      mul=mul)
            assert gather.launches == before + 1
            want = gather.probe_gather_plain(table, idx, arm=arm, reps=7,
                                             k=k, mul=mul)
            assert torch.equal(got, want), (arm, k, mul)
    with pytest.raises(ValueError):
        gather.probe_gather(table, idx[:-1], arm=arm, reps=1, k=2)


@pytest.mark.parametrize("m", [1, 2, 6, 8])
def test_compact_probe_equals_plain(m, dev):
    from phfpfac_tpu_torch.probes import compact

    rng = np.random.default_rng(m)
    for density in (0.0, 0.04, 0.7, 1.0):
        disp = torch.from_numpy(
            compact.make_disp(rng, 64 * compact.TILE, density)).to(dev)
        before = compact.launches, compact.launches_copy
        for fn, plain in ((compact.probe_compact,
                           compact.probe_compact_plain),
                          (compact.probe_copy, compact.probe_copy_plain)):
            got, want = fn(disp, m), plain(disp, m)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (fn.__name__, density)
        assert (compact.launches, compact.launches_copy) == (
            before[0] + 1, before[1] + 1)
        out, count = compact.probe_compact_atomic(disp, m)
        want, wcount = compact.probe_compact_atomic_plain(disp, m)
        n = int(count)
        assert n == int(wcount)
        # tiles arrive in any order: the same values, as a multiset
        assert torch.equal(torch.sort(out[:n]).values,
                           torch.sort(want[:n]).values)


@pytest.mark.parametrize("m", [1, 2, 6])
def test_compact_probe_at_tile_and_warp_edges(m, dev):
    """P2 where only each tile's last lane is live (its planes run off
    the tile), where only the lanes about each warp's edge are (their
    planes come from the next warp's words), all lanes and none, over
    more tiles than the card holds blocks (the persistent loop); and the
    wrappers refuse a view that is not 16-byte aligned."""
    from phfpfac_tpu_torch.probes import compact

    T, tiles = compact.TILE, 3000
    rng = np.random.default_rng(m)
    vals = rng.integers(1, 1 << 13, tiles * T).astype(np.int32)
    lanes = np.arange(tiles * T) % T
    at_edges = np.isin(lanes % 128, (0, 1, 2, 125, 126, 127)) | \
        (lanes >= T - 8)
    hosts = (np.where(lanes == T - 1, vals, 0), np.where(at_edges, vals, 0),
             vals, np.zeros_like(vals))
    for host in hosts:
        disp = torch.from_numpy(host.astype(np.int32)).to(dev)
        for fn, plain in ((compact.probe_compact,
                           compact.probe_compact_plain),
                          (compact.probe_copy, compact.probe_copy_plain)):
            got, want = fn(disp, m), plain(disp, m)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), fn.__name__
        assert all(torch.equal(g, w) for g, w in zip(
            compact.sorted_live(*compact.probe_compact_atomic(disp, m)),
            compact.sorted_live(*compact.probe_compact_atomic_plain(disp,
                                                                    m))))
    flat = torch.zeros(2 * T + 4, dtype=torch.int32, device=dev)
    view = flat[1:1 + 2 * T]
    assert view.data_ptr() % 16
    for fn in (compact.probe_compact, compact.probe_copy,
               compact.probe_compact_atomic):
        with pytest.raises(ValueError, match="aligned"):
            fn(view, m)


def test_probe_sweeps_hold_every_timed_shape_to_its_plain_version(dev):
    from phfpfac_tpu_torch.probes import compact, gather

    seen = []

    def check(got, want, what):
        gather.expect_equal(got, want, what)
        seen.append(what)

    kw = dict(walkers=1 << 16, table_bytes=(4096, 1 << 20), ks=(1, 8),
              timed=1)
    rows = list(gather.sweep(dev, check=check, **kw))
    assert len(rows) == len(seen) == 4 * 2 * 2 + 2
    # the check sees the kernel's own output: a wrong one ends the sweep
    with pytest.raises(RuntimeError, match="kernel != plain"):
        next(gather.sweep(dev, arms=("i32",), **dict(
            kw, check=lambda got, want, what: gather.expect_equal(
                got + 1, want, what))))
    seen.clear()
    rows = list(compact.sweep(
        dev, lanes=64 * compact.TILE, timed=1,
        check=lambda got, want, what: (
            compact.expect_equal(got, want, what), seen.append(what))))
    assert len(rows) == len(compact.SWEEP_PLANES)
    assert len(seen) == 3 * len(rows)


# ---- the mesh on one card: every cell on cuda:0 -----------------------------

@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_mesh_of_four_cells_on_one_card_equals_matcher(trunc, dev):
    from phfpfac_tpu_torch.parallel.distributed import MultiHostMatcher
    from phfpfac_tpu_torch.parallel.mesh import DistributedMatcher, make_mesh
    from phfpfac_tpu_torch.parallel.mesh_pallas import (
        PallasMeshMatcher,
        PlanMeshMatcher,
    )

    words, data = _dictionary("dense")
    cfg = PfacConfig(width=256, num_shards=2, truncation=trunc,
                     segment_bytes=2048, halo_bytes=16)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    comp = compile_patterns(pats, cfg)
    want = Matcher(comp, cfg).match(data)
    assert [tuple(x) for x in want] == match_oracle(pats, data, cfg)
    cells = ["cuda:0"] * 4
    mesh = make_mesh(2, 2, cells)
    K1.launches = K1.launches_compact_a = K1.launches_compact_b = 0
    pm = PlanMeshMatcher(comp, cfg, mesh, train=data[:8192])
    assert pm.stacked is not None
    assert np.array_equal(pm.match(data), want)
    assert K1.launches == 4  # one launch per cell
    packed = PlanMeshMatcher(comp, cfg, mesh, train=data[:8192],
                             compact=(1, 8192))
    assert np.array_equal(packed.match(data), want)
    assert K1.launches_compact_a == K1.launches_compact_b == 4
    assert np.array_equal(DistributedMatcher(comp, cfg, mesh).match(data),
                          want)
    mh = MultiHostMatcher(comp, cfg, devices=cells)
    assert np.array_equal(mh.match(data), want) and mh.last_engine == "plan"
    if trunc == "none":
        K2.launches = 0
        assert np.array_equal(PallasMeshMatcher(comp, cfg, mesh).match(data),
                              want)
        assert K2.launches == 4


# ---- K2 and K3 on warp tiles: tile edges, deep lists, dead_exit off,
# mesh-cell views -------------------------------------------------------------

DEPTH_GEOMS = [(0, 0), (64, 0), (100, 3), (6144, 512), (4096, 512)]


def _walk_scanners(words, data, dev):
    """(depth scanner, its staged bytes, pair scanner, its staged pairs,
    input_size) of ``words`` over ``data``; the pair scanner is None where
    the pair tables refuse the alphabet."""
    from phfpfac_tpu_torch.compile.pair import PairUnsupported

    cfg = PfacConfig(width=4096, num_shards=1)
    sh = compile_patterns([Pattern(i + 1, w) for i, w in enumerate(words)],
                          cfg).shards[0]
    ms = padded_steps(sh.max_pat_len)
    padded = to_device_bytes(pad_input(data, 1024, ms), dev)
    ds = K2.DepthShardScanner(sh, device=dev)
    try:
        ps = K3.PairShardScanner(sh, device=dev)
    except PairUnsupported:
        return ds, ds.stage(padded, len(data), ms), None, None, len(data)
    return (ds, ds.stage(padded, len(data), ms), ps,
            ps.stage(padded, len(data), ms), len(data))


def _depth_held_to_plain(staged, t, n, geoms):
    """Every mode of K2 on ``staged``, with the tables' dead_exit and with
    it forced off, against the plain version: bitmap at each (seg, halo),
    count with a shift, a chain of 8.  -> launches."""
    calls = 0
    for tt in (t, dataclasses.replace(t, dead_exit=False)):
        for seg, halo in geoms:
            kw = dict(input_size=n, seg_bytes=seg, halo_bytes=halo)
            got = K2.depth_scan(staged, tt, **kw)
            want = K2.depth_scan_plain(staged, tt, **kw)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            calls += 1
        for shift in (0, 1):
            assert int(K2.depth_scan(staged, tt, input_size=n, emit="count",
                                     shift=shift)) == \
                int(K2.depth_scan_plain(staged, tt, input_size=n,
                                        emit="count", shift=shift))
            calls += 1
        prev = want_prev = None
        for _ in range(8):  # a chain: each shift parity from the last total
            prev = K2.depth_scan(staged, tt, input_size=n, emit="count",
                                 prev_total=prev)
            want_prev = K2.depth_scan_plain(staged, tt, input_size=n,
                                            emit="count",
                                            prev_total=want_prev)
            assert int(prev) == int(want_prev)
            calls += 1
    return calls


def _pair_held_to_plain(staged, t):
    """K3 bitmap and count (shifts 0, 1, 5), with the tables' dead_exit
    and with it forced off, against the plain version.  -> launches."""
    calls = 0
    for tt in (t, dataclasses.replace(t, dead_exit=False)):
        got = K3.pair_scan(staged, tt)
        want = K3.pair_scan_plain(staged, tt)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        calls += 1
        for shift in (0, 1, 5):
            assert int(K3.pair_scan(staged, tt, emit="count",
                                    shift=shift)) == \
                int(K3.pair_scan_plain(staged, tt, emit="count",
                                       shift=shift))
            calls += 1
    return calls


@pytest.mark.parametrize("n_pos", [1024, 2048 + 1024, 5 * 2048 + 256 * 4,
                                   1 << 16])
@pytest.mark.parametrize("name", ["dense", "s0", "s0x"])
def test_walk_kernels_equal_plain_at_every_tile_geometry(name, n_pos, dev):
    """Half a block tile, a block tile and a half, five and a half, many
    block tiles: K2 at every segment geometry (6,144 and 100 + 3 among
    them), K3 where the pair tables take the alphabet."""
    words, data = _dictionary(name)
    ds, dst, ps, pst, n = _walk_scanners(words, data[:n_pos], dev)
    assert dst.numel() - 1024 == n_pos
    before2, before3 = K2.launches, K3.launches
    calls2 = _depth_held_to_plain(dst, ds.tables, n, DEPTH_GEOMS)
    calls3 = 0
    if ps is not None:
        calls3 = _pair_held_to_plain(pst, ps.tables)
    assert (ps is None) == (name == "s0x")
    torch.cuda.synchronize()
    assert K2.launches == before2 + calls2  # one launch per call
    assert K3.launches == before3 + calls3


def _deep_tiles():
    """A 32-byte pattern (and its 32 rotations) over 8 KiB of that
    pattern repeated, where every walker lives through every step, then
    random text with the pattern planted once in every warp tile of 256
    positions, at a random offset: a full list for 31 rounds, then one
    deep walker a tile."""
    rng = np.random.default_rng(6)
    pat = bytes(rng.integers(97, 123, 32, dtype=np.uint8))
    words = list(dict.fromkeys(pat[i:] + pat[:i] for i in range(32)))
    words += [bytes(rng.integers(97, 123, int(rng.integers(2, 9)),
                                 dtype=np.uint8)) for _ in range(300)]
    data = bytearray(pat * 256 +
                     bytes(rng.integers(97, 123, 1 << 16, dtype=np.uint8)))
    plants = 0
    for t0 in range(8192, len(data) - 256, 256):
        at = t0 + int(rng.integers(0, 256 - 32))
        data[at:at + 32] = pat
        plants += 1
    return words, bytes(data), plants


def test_walk_kernels_on_deep_lists(dev):
    words, data, plants = _deep_tiles()
    ds, dst, ps, pst, n = _walk_scanners(words, data, dev)
    assert ds.tables.n_steps == 32 and ps.tables.n_pair_steps == 16
    before2, before3 = K2.launches, K3.launches
    calls2 = _depth_held_to_plain(dst, ds.tables, n, DEPTH_GEOMS)
    calls3 = _pair_held_to_plain(pst, ps.tables)
    deep = 8192 - 31 + plants  # starts of a 32-byte match
    for bits in (K2.depth_scan(dst, ds.tables, input_size=n)[1],
                 K3.pair_scan(pst, ps.tables)[1]):
        assert int(((bits[:n] >> 31) & 1).sum()) >= deep
    torch.cuda.synchronize()
    assert K2.launches == before2 + calls2 + 1
    assert K3.launches == before3 + calls3 + 1


@pytest.mark.parametrize("name", ["dense", "s0x"])
def test_walk_kernels_on_mesh_cell_views(name, dev):
    """K2 on PallasMeshMatcher's cell views of one staged stream
    (parallel/mesh_pallas.py _cell_window: a block of positions plus its
    1,024-position halo, at an offset), and K3 on row views of its staged
    stream at an offset: each view against the plain version."""
    from phfpfac_tpu_torch.parallel.mesh_pallas import _cell_window

    words, data = _dictionary(name)
    ds, dst, ps, pst, n = _walk_scanners(words, data, dev)
    n_pos = dst.numel() - 1024
    block = n_pos // 4
    before2, before3 = K2.launches, K3.launches
    calls2 = calls3 = 0
    for d in range(4):
        cell = _cell_window(dst, d, block, dev)
        assert cell.data_ptr() % 16 == 0 and cell.numel() == block + 1024
        calls2 += _depth_held_to_plain(cell, ds.tables, 2**31 - 1,
                                       [(0, 0), (6144, 512)])
    if ps is not None:
        for rows in (8, 8 * 17):
            calls3 += _pair_held_to_plain(pst[rows:], ps.tables)
    torch.cuda.synchronize()
    assert K2.launches == before2 + calls2
    assert K3.launches == before3 + calls3


def test_walk_kernels_refuse_a_misaligned_staged_view(dev):
    words, data = _dictionary("dense")
    ds, dst, ps, pst, n = _walk_scanners(words, data, dev)
    flat = dst.reshape(-1)
    view = flat[1:flat.numel() - 1023]
    assert view.data_ptr() % 16
    before2, before3 = K2.launches, K3.launches
    with pytest.raises(ValueError, match="aligned"):
        K2.depth_scan(view, ds.tables, input_size=n)
    pflat = pst.reshape(-1)
    pview = pflat[1:1 + 128 * 40].reshape(40, 128)
    with pytest.raises(ValueError, match="aligned"):
        K3.pair_scan(pview, ps.tables)
    assert K2.launches == before2 and K3.launches == before3


PHF_GEOMS = [(0, 0), (100, 3), (4096, 512), (6144, 512)]


def _phf_tables(words, dev, shards, width=4096):
    """(K5's tables over every shard, K4's tables per shard, the padded
    step count) of ``words`` in ``shards`` shards."""
    compiled = compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)],
        PfacConfig(width=width, num_shards=shards))
    pts = [K4.PallasTables(sh) for sh in compiled.shards]
    return (K4.PhfKernelTables.from_tables(pts, dev),
            [K4.PhfKernelTables.from_tables([pt], dev) for pt in pts],
            padded_steps(compiled.max_pat_len))


def _phf_forms(t):
    """The tables as proved, with dead_exit forced off, and with two-word
    list entries where one word was proved."""
    forms = [t, dataclasses.replace(t, dead_exit=False)]
    if t.one_word:
        forms.append(dataclasses.replace(t, one_word=False))
    return forms


def _phf_held_to_plain(data, multi, singles, n, ms, geoms):
    """K5 and K4 in bitmap mode at each (seg, halo) and in count mode
    (shifts 0, 1, 5), in every form of the tables, against the plain
    versions; K5's rows equal K4's bitmaps.  -> (K4, K5) launches."""
    k4 = k5 = 0
    kw = dict(input_size=n, max_steps=ms)
    for mt in _phf_forms(multi):
        for seg, halo in geoms:
            g = dict(seg_bytes=seg, halo_bytes=halo, **kw)
            got = K4.phf_scan_multi(data, mt, **g)
            want = K4.phf_scan_multi_plain(data, mt, **g)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            k5 += 1
            if mt is multi:
                for s, one in enumerate(singles):
                    c, b = K4.phf_scan(data, one, **g)
                    cp, bp = K4.phf_scan_plain(data, one, **g)
                    assert torch.equal(c, cp) and torch.equal(b, bp)
                    assert torch.equal(b, got[1][s])
                    k4 += 1
        for shift in (0, 1, 5):
            assert int(K4.phf_scan_multi(data, mt, emit="count", shift=shift,
                                         **kw)) == \
                int(K4.phf_scan_multi_plain(data, mt, emit="count",
                                            shift=shift, **kw))
            k5 += 1
    for one in singles[:1]:
        for ot in _phf_forms(one):
            assert int(K4.phf_scan(data, ot, emit="count", shift=1,
                                   **kw)) == \
                int(K4.phf_scan_plain(data, ot, emit="count", shift=1,
                                      **kw))
            k4 += 1
    return k4, k5


@pytest.mark.parametrize("n_pos", [1024, 2048 + 1024, 5 * 2048 + 256 * 4,
                                   1 << 16])
@pytest.mark.parametrize("name", ["dense", "s0x"])
def test_phf_tiles_equal_plain_at_every_tile_geometry(name, n_pos, dev):
    """Half a block tile, a block tile and a half, five and a half, many
    block tiles; 3 shards, at every segment geometry and exact."""
    words, data = _dictionary(name)
    multi, singles, ms = _phf_tables(words, dev, 3)
    padded = to_device_bytes(pad_input(data[:n_pos], 1024, ms), dev)
    assert padded.numel() - ms == n_pos
    before, before_multi = K4.launches, K4.launches_multi
    k4, k5 = _phf_held_to_plain(padded, multi, singles, n_pos, ms,
                                PHF_GEOMS)
    torch.cuda.synchronize()
    assert K4.launches == before + k4  # one launch per call
    assert K4.launches_multi == before_multi + k5


@pytest.mark.parametrize("k", [1, 3, 7, 13])
def test_phf_tiles_on_views_at_odd_byte_offsets(k, dev):
    """A window that starts k bytes past a 16-byte boundary (as
    match_chunked's views of a staged corpus can), with other bytes
    after it in the same buffer: every mode against the plain version on
    the same bytes."""
    words, data = _dictionary("dense")
    multi, singles, ms = _phf_tables(words, dev, 3)
    padded = to_device_bytes(pad_input(data, 1024, ms), dev)
    rng = np.random.default_rng(k)
    buf = torch.from_numpy(rng.integers(0, 256, padded.numel() + 64,
                                        dtype=np.uint8)).to(dev)
    view = buf[k:k + padded.numel()]
    view.copy_(padded)
    assert view.data_ptr() % 16 == k
    before, before_multi = K4.launches, K4.launches_multi
    k4, k5 = _phf_held_to_plain(view, multi, singles, len(data), ms,
                                PHF_GEOMS)
    # the same answers as on the aligned copy
    got = K4.phf_scan_multi(view, multi, input_size=len(data), max_steps=ms)
    want = K4.phf_scan_multi(padded, multi, input_size=len(data),
                             max_steps=ms)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert K4.launches == before + k4
    assert K4.launches_multi == before_multi + k5 + 2


@pytest.mark.parametrize("shards", [1, 64])
def test_phf_tiles_with_one_and_64_shards(shards, dev):
    words, data = _dictionary("dense")
    multi, singles, ms = _phf_tables(words, dev, shards)
    assert multi.n_shards == shards
    padded = to_device_bytes(pad_input(data, 1024, ms), dev)
    before_multi = K4.launches_multi
    _k4, k5 = _phf_held_to_plain(padded, multi, singles[:3], len(data), ms,
                                 [(0, 0), (4096, 512)])
    torch.cuda.synchronize()
    assert K4.launches_multi == before_multi + k5


def _long_words():
    """Patterns of 2-120 bytes over a small alphabet, and text with each
    of the longest planted: walks of up to 120 steps."""
    rng = np.random.default_rng(8)
    alpha = np.frombuffer(b"abcdef", np.uint8)
    words = list(dict.fromkeys(
        bytes(alpha[rng.integers(0, 6, int(rng.integers(2, 12)))])
        for _ in range(400)))
    words += [bytes(alpha[rng.integers(0, 6, int(m))])
              for m in (60, 97, 120)]
    data = bytearray(alpha[rng.integers(0, 6, 1 << 15)])
    for i, at in enumerate(range(100, len(data) - 200, 997)):
        w = words[-1 - i % 3]
        data[at:at + len(w)] = w
    return words, bytes(data)


def test_phf_tiles_count_mode_at_128_steps(dev):
    """Count mode at its 128-step limit (the 128-byte halo), exact and
    under cuts, with walks as deep as 120 steps, in every form of the
    tables."""
    words, data = _long_words()
    multi, singles, ms = _phf_tables(words, dev, 2)
    assert ms <= 128
    padded = to_device_bytes(pad_input(data, 1024, 128), dev)
    before, before_multi = K4.launches, K4.launches_multi
    calls4 = calls5 = 0
    for seg, halo in [(0, 0), (100, 3), (4096, 512), (6144, 512)]:
        for mt in _phf_forms(multi):
            for shift in (0, 1):
                kw = dict(input_size=len(data), max_steps=128, emit="count",
                          seg_bytes=seg, halo_bytes=halo, shift=shift)
                want = int(K4.phf_scan_multi_plain(padded, mt, **kw))
                assert int(K4.phf_scan_multi(padded, mt, **kw)) == want > 0
                calls5 += 1
        kw = dict(input_size=len(data), max_steps=128, emit="count",
                  seg_bytes=seg, halo_bytes=halo)
        for one in singles:
            assert int(K4.phf_scan(padded, one, **kw)) == \
                int(K4.phf_scan_plain(padded, one, **kw))
            calls4 += 1
    torch.cuda.synchronize()
    assert K4.launches == before + calls4
    assert K4.launches_multi == before_multi + calls5


def test_phf_tiles_on_deep_lists(dev):
    """32-byte patterns over their own repeats (every walker lives
    through every step: full lists for 31 rounds), then one deep walker
    a warp tile; two-word entries (a 256-wide table) and one-word."""
    words, data, _plants = _deep_tiles()
    for width in (256, 4096):
        multi, singles, ms = _phf_tables(words, dev, 2, width=width)
        assert ms == 32
        padded = to_device_bytes(pad_input(data, 1024, ms), dev)
        _phf_held_to_plain(padded, multi, singles, len(data), ms,
                           PHF_GEOMS)
        bits = K4.phf_scan_multi(padded, multi, input_size=len(data),
                                 max_steps=ms)[1]
        assert int(((bits[:, :len(data)] >> 31) & 1).sum()) >= 8192 - 31


# ---- the ordered decode behind K1 ------------------------------------------

def test_chunked_words_take_the_ordered_decode(dev):
    """``match_chunked`` on the card, K1 in each of 4 shards of a word
    dictionary (the CLI's cut, chunks whose edges words cross): the
    ordered decode writes the oracle's rows, once a request."""
    from torch.profiler import ProfilerActivity, profile

    from phfpfac_tpu_torch.utils import profile as P

    rng = np.random.default_rng(15)
    letters = np.frombuffer(b"etaoinshrdlucmfwypvbgkqjxz", dtype=np.uint8)
    freq = 1.0 / np.arange(1, len(letters) + 1)
    words = list(dict.fromkeys(
        bytes(rng.choice(letters, int(rng.integers(2, 11)),
                         p=freq / freq.sum()))
        for _ in range(3000)))
    text = b" ".join(words[int(i)] for i in
                     rng.integers(0, len(words), 40_000))[:256 << 10]
    cfg = PfacConfig(width=4096, num_shards=4, truncation="segment",
                     segment_bytes=4096, halo_bytes=512)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    m = Matcher(compile_patterns(pats, cfg), cfg, device=dev)
    chunk = 64 << 10
    m.match_chunked(text, chunk_bytes=chunk)  # builds the tables
    assert all(isinstance(s, K1.PlanShardScanner) for s in m._get_scanners())
    before = P.snapshot()
    K1.launches = 0
    with profile(activities=[ProfilerActivity.CPU]):
        got = m.match_chunked(text, chunk_bytes=chunk)
        torch.cuda.synchronize()
    counters = P.difference(before, P.snapshot())["counters"]
    assert K1.launches == 4 * 4  # one a shard and chunk
    assert counters["merge.ordered"] == 1 and "merge.argsort" not in counters
    want = np.asarray(match_oracle(pats, text, cfg), np.int64)
    np.testing.assert_array_equal(got, want)
    assert len(want) > len(text) // 4
