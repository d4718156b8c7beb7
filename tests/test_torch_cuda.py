"""CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA GPU and skips without one.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs, compared exactly (tolerance 0).
"""

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
