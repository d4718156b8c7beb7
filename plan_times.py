"""Times the hand-written kernels of the checkout this file sits in, per
16 MiB chunk, each on its route's shape: K1 (``plan_scan``), K1′
(``plan_scan_compact_a``) and K6 (``planb_scan``) on ``chip_smoke.py``'s
two dictionaries (the 4 shards of the first ``match_chunked`` window of a
64 MiB corpus made by ``chip_smoke.py``'s generators from seed 0); K2
(``depth_scan``) on the depth path (clamav5k's 4 shards, a 6,144 B
segment); K3 (``pair_scan``) on the pair path (lower50k's 4 shards, exact
mode, 16 MiB); K5 (``phf_scan_multi``, one launch over clamav5k's 4
shards) and K4 (``phf_scan``, one launch a shard) on the phf path
(clamav5k's first 16 MiB window, the CLI's 4,096 + 512 B cut); P2
(``probe_compact``) at its sweep's 32 Mi lanes.  Needs one CUDA GPU:

    python3 plan_times.py                     # every kernel
    python3 plan_times.py phf_scan depth_scan  # only these

It times K1 in bitmap mode under the CLI's segment cut, in count mode and
as a chain of 8 count scans; K1′ at ``chip_smoke``'s cut in bitmap and
count mode; K6 at that cut and cap on K1′'s survivors in bitmap mode
under the cut and exact, in count mode and as a chain of 8, with the pair
and K1 beside it; K2 in bitmap mode under the depth path's cut and exact,
in count mode, as a chain of 8 and with ``dead_exit`` forced off; K3 in
bitmap and count mode and with ``dead_exit`` off; K4 and K5 in bitmap
mode under the cut and exact, in count mode and with ``dead_exit`` off;
P2's copy, pack and atomic pack at 1, 2 and 6 planes, beside
``disp[disp != 0]``.  And each walk's split, through the same wrapper on
reduced tables or inputs: **no walk** (a first table of misses and no
steps: the staged read, one probe and the cnt / bits writes; for K4 and
K5 an s0 of DEAD), **prologue** (no steps; K4 and K5: one step) and, for
K2-K5, **step 1** (the first step only); for K6 **no survivors** (a
count of 0), **cap = count**, **cap = 8 x count** and **one step** after
the cut.  Every timed shape is first held to its plain version (exact).
K4's, K5's, K6's and P2's shapes, and K1's, K1′'s, K2's and K3's whole
walks in each mode, are also timed by the profiler's device time of their
kernels (``utils/profile.py::trace``), the field ``*_device_ms`` beside
each ``cuda_ms`` time.  It also prints what ``nvcc
-Xptxas -v`` says of each timed kernel's source (registers, spills,
shared memory per instantiation), and one JSON line.

It uses nothing but ``chip_smoke.py`` and the package beside it, so a copy
of it placed in another checkout (an earlier commit unpacked with ``git
archive`` into a git-ignored directory) times that checkout's kernels the
same way; run the two in turns, A B B A, in one session on the card.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402
from phfpfac_tpu_torch import _build, compile_dictionary  # noqa: E402
from phfpfac_tpu_torch.ops import depth as K2  # noqa: E402
from phfpfac_tpu_torch.ops import pair as K3  # noqa: E402
from phfpfac_tpu_torch.ops import plan as K1  # noqa: E402
from phfpfac_tpu_torch.ops import scan as K4  # noqa: E402
from phfpfac_tpu_torch.ops.common import padded_steps  # noqa: E402
from phfpfac_tpu_torch.ops.staging import TILE  # noqa: E402
from phfpfac_tpu_torch.parallel.matcher import Matcher  # noqa: E402
from phfpfac_tpu_torch.utils.config import PfacConfig  # noqa: E402
from phfpfac_tpu_torch.utils.profile import cuda_ms, trace  # noqa: E402


KERNELS = ("plan_scan", "planb_scan", "depth_scan", "pair_scan", "phf_scan",
           "probe_compact")
DEPTH_SEG = 6144  # the depth path's segment: K1 takes powers of two only


def ptxas_report(name: str) -> list[str]:
    """What ``nvcc -Xptxas -v`` says of this checkout's ``csrc/<name>.cu``."""
    src = os.path.join(HERE, "phfpfac_tpu_torch", "csrc", f"{name}.cu")
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), src],
            capture_output=True, text=True)
    return [line.strip() for line in (out.stdout + out.stderr).splitlines()
            if "Used" in line or "spill" in line or "Compiling" in line]


def same(got, want, what):
    for g, w in zip(got, want):
        cs.check(torch.equal(g.to(torch.int64), w.to(torch.int64)),
                 f"{what}: kernel != plain")


def time_shard(sc, window: bytes, device) -> dict:
    """Every timing of one plan shard over ``window``."""
    st, _n = cs.scan_inputs(sc, window, device)
    t, n_pos = sc.tables, st.numel() - TILE
    seg = dict(seg_bytes=cs.SEG, halo_bytes=cs.HALO)
    same(K1.plan_scan(st, t, **seg), K1.plan_scan_plain(st, t, **seg),
         "bitmap")
    same([K1.plan_scan(st, t, emit="count")],
         [K1.plan_scan_plain(st, t, emit="count")], "count")

    def chain(scan=K1.plan_scan):
        prev = None
        for _ in range(cs.CHAIN_K):
            prev = scan(st, t, emit="count", prev_total=prev)
        return prev

    same([chain()], [chain(K1.plan_scan_plain)], "chain")
    _how, cut, cap, _why = cs.choose_compact(sc.pt, n_pos)
    kw = dict(cut=cut, cap=cap, **seg)
    got, surv = K1.plan_scan_compact_a(st, t, **kw)
    want, wsurv = K1.plan_scan_compact_a_plain(st, t, **kw)
    same([*got, *cs.sorted_survivors(surv, cap)],
         [*want, *cs.sorted_survivors(wsurv, cap)], f"K1' at cut {cut}")
    prologue = dataclasses.replace(sc.pt, steps=())
    no_walk = dataclasses.replace(
        prologue, p0_banks=np.full_like(sc.pt.p0_banks, -1))
    reduced = {what: K1.PlanKernelTables.from_plan(pt, device)
               for what, pt in (("prologue", prologue), ("no_walk", no_walk))}
    for what, tt in reduced.items():
        same(K1.plan_scan(st, tt, **seg), K1.plan_scan_plain(st, tt, **seg),
             what)
    tb = cs.table_bytes(t)
    dev_chain = device_ms(chain, "plan_scan")
    return dict(
        ms=cuda_ms(lambda: K1.plan_scan(st, t, **seg)),
        device_ms=device_ms(lambda: K1.plan_scan(st, t, **seg), "plan_scan"),
        count_ms=cuda_ms(lambda: K1.plan_scan(st, t, emit="count")),
        count_device_ms=device_ms(lambda: K1.plan_scan(st, t, emit="count"),
                                  "plan_scan"),
        chain_ms_per_scan=cuda_ms(chain) / cs.CHAIN_K,
        chain_device_ms_per_scan=dev_chain and dev_chain / cs.CHAIN_K,
        a_ms=cuda_ms(lambda: K1.plan_scan_compact_a(st, t, **kw)),
        a_device_ms=device_ms(lambda: K1.plan_scan_compact_a(st, t, **kw),
                              "plan_scan"),
        count_a_ms=cuda_ms(lambda: K1.plan_scan_compact_a(
            st, t, cut=cut, cap=cap, emit="count")),
        prologue_ms=cuda_ms(
            lambda: K1.plan_scan(st, reduced["prologue"], **seg)),
        no_walk_ms=cuda_ms(
            lambda: K1.plan_scan(st, reduced["no_walk"], **seg)),
        bound_ms=cs.bound_ms(n_pos, tb, True),
        count_bound_ms=cs.bound_ms(n_pos, tb, False),
        n_pos=n_pos, survivors=int(surv[2]), shards=1)


def deep_bound_ms(st, t, surv, cut, cap, seg) -> float:
    """K6's bytes bound on this data: 8 B of (pos, disp) a survivor, one
    int32 a window it reads, and a word of bits and of cnt read and
    written where it ends with deep bits (count mode: none)."""
    reads, hits = cs.deep_work(st, t, surv, cut, cap, seg)
    n = min(int(surv[2]), cap)
    return (8 * n + 4 * reads + 16 * hits) / cs.HBM_BYTES_PER_S * 1e3


def time_planb(sc, window: bytes, device) -> dict:
    """K6 on one plan shard at ``choose_compact``'s (cut, cap), on phase
    A's own survivors: bitmap mode under the CLI's cut and exact, count
    mode, a chain of count scans each reading the last total; the split
    (no survivors, cap = count, cap = 8 x count, one step after the cut);
    the pair and K1 beside it.  Every shape is first held to
    ``planb_scan_plain`` on the same inputs, bit for bit."""
    st, _n = cs.scan_inputs(sc, window, device)
    t, n_pos = sc.tables, st.numel() - TILE
    _how, cut, cap, _why = cs.choose_compact(sc.pt, n_pos)
    seg = dict(seg_bytes=cs.SEG, halo_bytes=cs.HALO)
    res, surv = K1.plan_scan_compact_a(st, t, cut=cut, cap=cap, **seg)
    eres, esurv = K1.plan_scan_compact_a(st, t, cut=cut, cap=cap)
    cres, csurv = K1.plan_scan_compact_a(st, t, cut=cut, cap=cap,
                                         emit="count", shift=1)
    count = int(surv[2])
    cs.check(0 < count <= cap, f"K6: {count} survivors at cap {cap}")
    big = 8 * count

    def padded(x):
        return torch.cat([x, x.new_zeros(max(0, big - x.numel()))])

    one = K1.PlanKernelTables.from_plan(
        dataclasses.replace(sc.pt, steps=sc.pt.steps[:cut + 1]), device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    wide = (padded(surv[0]), padded(surv[1]), surv[2])
    shapes = {  # name -> (tables, result, survivors, keyword arguments)
        "": (t, res, surv, dict(cap=cap, **seg)),
        "exact_": (t, eres, esurv, dict(cap=cap)),
        "count_": (t, cres, csurv, dict(cap=cap, emit="count", shift=1)),
        "zero_": (t, res, (surv[0], surv[1], zero), dict(cap=cap, **seg)),
        "cap_eq_": (t, res, surv, dict(cap=count, **seg)),
        "cap_8x_": (t, res, wide, dict(cap=big, **seg)),
        "one_step_": (one, res, surv, dict(cap=cap, **seg)),
    }

    def clone(r):
        return tuple(x.clone() for x in r) if isinstance(r, tuple) \
            else r.clone()

    out = {}
    for what, (tt, r, sv, kw) in shapes.items():
        got, want = clone(r), clone(r)
        K1.planb_scan(st, tt, got, sv, cut=cut, **kw)
        K1.planb_scan_plain(st, tt, want, sv, cut=cut, **kw)
        same(got if isinstance(got, tuple) else [got],
             want if isinstance(want, tuple) else [want],
             f"K6 {what or 'bitmap'}")

        def run(tt=tt, r=r, sv=sv, kw=kw):
            K1.planb_scan(st, tt, r, sv, cut=cut, **kw)

        out[f"{what}ms"] = cuda_ms(run)
        out[f"{what}device_ms"] = device_ms(run, "planb_scan")

    def chain(scan=K1.planb_scan, totals=None):
        totals = totals or [cres.clone() for _ in range(cs.CHAIN_K)]
        for k in range(cs.CHAIN_K):
            scan(st, t, totals[k], csurv, cut=cut, cap=cap, emit="count",
                 shift=1, prev_total=totals[k - 1] if k else None)
        return totals[-1]

    same([chain()], [chain(K1.planb_scan_plain)], "K6 chain")
    totals = [cres.clone() for _ in range(cs.CHAIN_K)]
    out["chain_ms_per_scan"] = cuda_ms(
        lambda: chain(totals=totals)) / cs.CHAIN_K
    dev_chain = device_ms(lambda: chain(totals=totals), "planb_scan")
    out["chain_device_ms_per_scan"] = dev_chain and dev_chain / cs.CHAIN_K
    kw = dict(cut=cut, cap=cap, **seg)
    out.update(
        pair_ms=cuda_ms(lambda: K1.plan_scan_compact(st, t, **kw)),
        pair_device_ms=device_ms(lambda: K1.plan_scan_compact(st, t, **kw),
                                 "plan"),
        a_ms=cuda_ms(lambda: K1.plan_scan_compact_a(st, t, **kw)),
        k1_ms=cuda_ms(lambda: K1.plan_scan(st, t, **seg)),
        k1_device_ms=device_ms(lambda: K1.plan_scan(st, t, **seg),
                               "plan_scan_kernel"),
        bound_ms=deep_bound_ms(st, t, surv, cut, cap, cs.SEG),
        exact_bound_ms=deep_bound_ms(st, t, esurv, cut, cap, 0),
        n_pos=n_pos, cut=cut, cap=cap, survivors=count,
        exact_survivors=int(esurv[2]), count_survivors=int(csurv[2]),
        steps_after_cut=len(t.spec) - cut, shards=1)
    return out


def time_probe_compact(device) -> dict:
    """P2 at the probe sweep's shape (32 Mi lanes, density 0.04) for 1, 2
    and 6 planes: copy only, the per-tile pack and the atomic pack, by
    ``cuda_ms`` and by the profiler's device time, beside its bytes bound
    and ``disp[disp != 0]``.  Each held to its plain version first."""
    from phfpfac_tpu_torch.probes import compact

    lanes = compact.SWEEP_LANES
    disp = torch.from_numpy(compact.make_disp(np.random.default_rng(0),
                                              lanes)).to(device)
    out = dict(lanes=lanes, density=compact.SWEEP_DENSITY,
               bound_ms=(8 * lanes + 4 * (lanes // compact.TILE))
               / cs.HBM_BYTES_PER_S * 1e3)
    for m in compact.SWEEP_PLANES:
        for what, fn, plain in (
                ("copy", compact.probe_copy, compact.probe_copy_plain),
                ("pack", compact.probe_compact, compact.probe_compact_plain),
                ("atomic", compact.probe_compact_atomic,
                 compact.probe_compact_atomic_plain)):
            got, want = fn(disp, m), plain(disp, m)
            if what == "atomic":  # tiles in any order: as a multiset
                got, want = compact.sorted_live(*got), \
                    compact.sorted_live(*want)
            same(got, want, f"P2 {what} m={m}")
            out[f"{what}_m{m}_ms"] = cuda_ms(lambda: fn(disp, m))
            out[f"{what}_m{m}_device_ms"] = device_ms(lambda: fn(disp, m),
                                                      "probe_compact")
    out["library_ms"] = cuda_ms(lambda: disp[disp != 0])
    return out


def reduced_depth(dt, device):
    """K2's split: the tables with no steps, with the first step only, and
    with no steps and an s0 of misses."""
    def keep(n):
        return dataclasses.replace(dt, n_steps=1 + n, offs=dt.offs[:n],
                                   nbs=dt.nbs[:n], k0s=dt.k0s[:n])

    no_walk = dataclasses.replace(keep(0),
                                  s0_banks=np.full_like(dt.s0_banks, -1))
    return {what: K2.DepthKernelTables.from_depth(d, device)
            for what, d in (("prologue", keep(0)), ("step1", keep(1)),
                            ("no_walk", no_walk))}


def time_depth(sc, window: bytes, device) -> dict:
    """Every timing of one depth shard over ``window``."""
    st, n = cs.scan_inputs(sc, window, device)
    t, n_pos = sc.tables, st.numel() - TILE
    off = dataclasses.replace(t, dead_exit=False)
    seg = dict(input_size=n, seg_bytes=DEPTH_SEG, halo_bytes=cs.HALO)
    exact = dict(input_size=n)
    reduced = reduced_depth(sc.dt, device)
    for what, tt, kw in (("bitmap", t, seg), ("exact", t, exact),
                         ("dead_exit off", off, seg),
                         *((w, tt, seg) for w, tt in reduced.items())):
        same(K2.depth_scan(st, tt, **kw), K2.depth_scan_plain(st, tt, **kw),
             f"K2 {what}")
    same([K2.depth_scan(st, t, emit="count", **exact)],
         [K2.depth_scan_plain(st, t, emit="count", **exact)], "K2 count")

    def chain(scan=K2.depth_scan):
        prev = None
        for _ in range(cs.CHAIN_K):
            prev = scan(st, t, emit="count", prev_total=prev, **exact)
        return prev

    same([chain()], [chain(K2.depth_scan_plain)], "K2 chain")
    tb = cs.table_bytes(t)
    dev_chain = device_ms(chain, "depth_scan")
    return dict(
        ms=cuda_ms(lambda: K2.depth_scan(st, t, **seg)),
        device_ms=device_ms(lambda: K2.depth_scan(st, t, **seg),
                            "depth_scan"),
        exact_ms=cuda_ms(lambda: K2.depth_scan(st, t, **exact)),
        exact_device_ms=device_ms(lambda: K2.depth_scan(st, t, **exact),
                                  "depth_scan"),
        count_ms=cuda_ms(lambda: K2.depth_scan(st, t, emit="count",
                                               **exact)),
        count_device_ms=device_ms(
            lambda: K2.depth_scan(st, t, emit="count", **exact),
            "depth_scan"),
        chain_ms_per_scan=cuda_ms(chain) / cs.CHAIN_K,
        chain_device_ms_per_scan=dev_chain and dev_chain / cs.CHAIN_K,
        dead_exit_off_ms=cuda_ms(lambda: K2.depth_scan(st, off, **seg)),
        dead_exit_off_device_ms=device_ms(
            lambda: K2.depth_scan(st, off, **seg), "depth_scan"),
        **{f"{what}_ms": cuda_ms(lambda tt=tt: K2.depth_scan(st, tt, **seg))
           for what, tt in reduced.items()},
        exact_no_walk_ms=cuda_ms(
            lambda: K2.depth_scan(st, reduced["no_walk"], **exact)),
        bound_ms=cs.bound_ms(n_pos, tb, True),
        count_bound_ms=cs.bound_ms(n_pos, tb, False),
        n_pos=n_pos, shards=1, dead_exit=int(t.dead_exit))


def reduced_pair(pt, device):
    """K3's split, as K2's: no steps, the first pair step only, and no
    steps over a p0 of misses."""
    def keep(n):
        return dataclasses.replace(
            pt, n_pair_steps=1 + n, p_offs=pt.p_offs[:n], p_nbs=pt.p_nbs[:n],
            p_k0s=pt.p_k0s[:n], s_offs=pt.s_offs[:n], s_nbs=pt.s_nbs[:n],
            s_k0s=pt.s_k0s[:n], s_nibbles=tuple(pt.s_nibbles[:n]))

    no_walk = dataclasses.replace(keep(0),
                                  p0_banks=np.full_like(pt.p0_banks, -1))
    return {what: K3.PairKernelTables.from_pair(p, device)
            for what, p in (("prologue", keep(0)), ("step1", keep(1)),
                            ("no_walk", no_walk))}


def time_pair(sc, window: bytes, device) -> dict:
    """Every timing of one pair shard over ``window`` (exact mode)."""
    st, _n = cs.scan_inputs(sc, window, device)
    t, n_pos = sc.tables, st.numel() - TILE
    off = dataclasses.replace(t, dead_exit=False)
    reduced = reduced_pair(sc.pt, device)
    for what, tt in (("bitmap", t), ("dead_exit off", off),
                     *reduced.items()):
        same(K3.pair_scan(st, tt), K3.pair_scan_plain(st, tt), f"K3 {what}")
    same([K3.pair_scan(st, t, emit="count", shift=1)],
         [K3.pair_scan_plain(st, t, emit="count", shift=1)], "K3 count")
    tb = cs.table_bytes(t)
    return dict(
        ms=cuda_ms(lambda: K3.pair_scan(st, t)),
        device_ms=device_ms(lambda: K3.pair_scan(st, t), "pair_scan"),
        count_ms=cuda_ms(lambda: K3.pair_scan(st, t, emit="count", shift=1)),
        count_device_ms=device_ms(
            lambda: K3.pair_scan(st, t, emit="count", shift=1), "pair_scan"),
        dead_exit_off_ms=cuda_ms(lambda: K3.pair_scan(st, off)),
        dead_exit_off_device_ms=device_ms(lambda: K3.pair_scan(st, off),
                                          "pair_scan"),
        **{f"{what}_ms": cuda_ms(lambda tt=tt: K3.pair_scan(st, tt))
           for what, tt in reduced.items()},
        bound_ms=cs.bound_ms(n_pos, tb, True),
        count_bound_ms=cs.bound_ms(n_pos, tb, False),
        n_pos=n_pos, shards=1, dead_exit=int(t.dead_exit))


def device_ms(fn, name: str, reps: int = 5, tries: int = 3):
    """Mean device time of the kernels whose name holds ``name`` that
    ``fn`` launches, in ms, from a ``torch.profiler`` trace of ``reps``
    calls after a warm-up, traced again (up to ``tries`` times) where a
    trace shows no device time for them; None if none does.  (A copy of
    ``chip_smoke.py::device_ms``, so that this file times checkouts made
    before it.)"""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with trace() as mt:
            for _ in range(reps):
                fn()
        secs = sum(v for k, v in mt.device_seconds_by_name().items()
                   if name in k)
        if secs:
            return 1e3 * secs / reps
    return None


def reduced_phf(pts, device):
    """K4's and K5's no-walk tables: s0 all DEAD, so every walker dies
    before its first step (the prologue and step 1 shapes are the
    tables as they are at one and two steps)."""
    dead = []
    for pt in pts:
        q = copy.copy(pt)
        q.s0 = np.full_like(pt.s0, pt.dead)
        dead.append(q)
    return dead


def time_phf(compiled, window: bytes, device) -> dict:
    """K5 over every shard (one launch) and K4 summed over the shards, on
    the phf path's window: every mode and the split, by ``cuda_ms`` and
    by the profiler's device time."""
    pts = [K4.PallasTables(sh) for sh in compiled.shards]
    ms = padded_steps(compiled.max_pat_len)
    data = cs.padded_window(window, ms, device)
    n, n_pos = len(window), data.numel() - ms
    seg = dict(seg_bytes=cs.SEG, halo_bytes=cs.HALO)
    no_walk = reduced_phf(pts, device)
    out = {}
    for key, kernel, plain, groups in (
            ("phf_scan_multi/clamav5k", K4.phf_scan_multi,
             K4.phf_scan_multi_plain, [pts]),
            ("phf_scan/clamav5k", K4.phf_scan, K4.phf_scan_plain,
             [[pt] for pt in pts])):
        total: dict = {}
        for group in groups:
            t = K4.PhfKernelTables.from_tables(group, device)
            dead = K4.PhfKernelTables.from_tables(
                [no_walk[pts.index(pt)] for pt in group], device)
            off = dataclasses.replace(t, dead_exit=False)
            shapes = {  # name -> (data, tables, keyword arguments)
                "": (data, t, dict(max_steps=ms, **seg)),
                "exact_": (data, t, dict(max_steps=ms)),
                "count_": (data, t, dict(max_steps=ms, emit="count")),
                "dead_exit_off_": (data, off, dict(max_steps=ms, **seg)),
                "no_walk_": (data, dead, dict(max_steps=ms, **seg)),
                "prologue_": (data[:n_pos + 1], t,
                              dict(max_steps=1, **seg)),
                "step1_": (data[:n_pos + 2], t, dict(max_steps=2, **seg)),
            }
            part = {}
            for what, (d, tt, kw) in shapes.items():
                got = kernel(d, tt, input_size=n, **kw)
                want = plain(d, tt, input_size=n, **kw)
                same(got if isinstance(got, tuple) else [got],
                     want if isinstance(want, tuple) else [want],
                     f"{key} {what or 'bitmap'}")

                def run(d=d, tt=tt, kw=kw):
                    return kernel(d, tt, input_size=n, **kw)

                part[f"{what}ms"] = cuda_ms(run)
                part[f"{what}device_ms"] = device_ms(run, "phf_scan")
            tb = cs.table_bytes(t)
            rows = t.n_shards if kernel is K4.phf_scan_multi else 1
            part["bound_ms"] = cs.bound_ms(n_pos, tb, True, read_b=1,
                                           bitmap_rows=rows)
            part["count_bound_ms"] = cs.bound_ms(n_pos, tb, False, read_b=1)
            part["one_word"] = getattr(t, "one_word", None)  # older checkouts: none
            part["dead_exit"] = int(t.dead_exit)
            part["launches"] = 1
            add(total, part)
        total["n_pos"] = n_pos
        total["max_steps"] = ms
        out[key] = total
    return out


def add(total: dict, part: dict) -> None:
    """Sum ``part`` into ``total`` key by key; None (not measured)
    stays None."""
    for k, v in part.items():
        have = total.get(k, 0)
        total[k] = None if v is None or have is None else have + v


def main() -> int:
    if not torch.cuda.is_available():
        print("plan_times times CUDA kernels: no CUDA device",
              file=sys.stderr)
        return 1
    want = set(sys.argv[1:]) or set(KERNELS)
    if want - set(KERNELS):
        print(f"plan_times: unknown kernels {sorted(want - set(KERNELS))}; "
              f"choose from {KERNELS}", file=sys.stderr)
        return 2
    kernels = [k for k in KERNELS if k in want]
    device = torch.device("cuda")
    plan = {"plan_scan", "planb_scan"} & want  # K6 runs on K1′'s output
    _build.build_all(sorted(set(kernels) | ({"plan_scan"} if plan else set())))
    rng = np.random.default_rng(0)
    out = dict(root=HERE, nvidia_smi=cs.nvidia_smi(),
               ptxas={k: ptxas_report(k) for k in kernels})
    printable = np.arange(32, 127, dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        for name, make, alphabet, escapes in (
            ("ascii50k", cs.make_ascii50k, printable, False),
            ("clamav5k", lambda _rng: cs.make_signatures(5000, seed=7), None,
             True),
        ):
            # the generators run whatever is timed, so that every
            # selection sees the same corpora
            pats = make(rng)
            corpus, _planted = cs.make_corpus(rng, pats, 64 * cs.MIB,
                                              alphabet)
            if name == "ascii50k" and not plan:
                continue
            files = cs.write_inputs(tmp, name, pats, corpus, escapes)
            cfg = PfacConfig(width=4096, num_shards=4, truncation="segment")
            compiled = compile_dictionary(files[0], cfg, escapes=escapes)
            if plan:
                matcher = Matcher(compiled, cfg, device=device,
                                  train=corpus[:cs.MIB])
                for kernel, timed in (("plan_scan", time_shard),
                                      ("planb_scan", time_planb)):
                    if kernel not in want:
                        continue
                    total: dict = {}
                    for _kind, sc in cs.shard_kernels(matcher):
                        if isinstance(sc, K1.PlanShardScanner):
                            add(total, timed(sc, corpus[:cs.CHUNK], device))
                    out[name if kernel == "plan_scan"
                        else f"planb_scan/{name}"] = total
                del matcher
            if name == "clamav5k" and "depth_scan" in want:
                # the depth path: K1 refuses 6,144 B
                total = {}
                for sh in compiled.shards:
                    add(total, time_depth(K2.DepthShardScanner(
                        sh, device=device), corpus[:cs.CHUNK], device))
                out["depth_scan/clamav5k"] = total
            if name == "clamav5k" and "phf_scan" in want:
                out.update(time_phf(compiled, corpus[:cs.CHUNK], device))
            del compiled, corpus
            torch.cuda.empty_cache()
        if "pair_scan" in want:
            # the pair path: lower50k (chip_smoke's generators, seed 0 +
            # 1), exact mode, its 16 MiB corpus
            rng2 = np.random.default_rng(1)
            pats = cs.make_stem_patterns(rng2, cs.LOWER)
            corpus, _planted = cs.make_corpus(rng2, pats, cs.CHUNK,
                                              cs.LOWER,
                                              plants=cs.PLANTS // 4)
            files = cs.write_inputs(tmp, "lower50k", pats, corpus, False)
            compiled = compile_dictionary(
                files[0], PfacConfig(width=4096, num_shards=4,
                                     truncation="none"))
            total = {}
            for sh in compiled.shards:
                add(total, time_pair(K3.PairShardScanner(sh, device=device),
                                     corpus, device))
            out["pair_scan/lower50k"] = total
    if "probe_compact" in want:
        out["probe_compact"] = time_probe_compact(device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
