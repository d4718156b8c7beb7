"""Chip smoke test of the PyTorch/CUDA port (phfpfac_tpu_torch).

Run on a machine with one CUDA GPU, from the repository root:

    python3 chip_smoke.py [--seed 0] [--mib 64]

It builds the CUDA kernels from ``phfpfac_tpu_torch/csrc``, holds each
against its plain torch version on the card, drives the gphf CLI main
path (``phfpfac_tpu_torch.cli.main``) over two dictionaries at the size
users run, checks the output, times the kernels and prints one JSON
line per phase.  The last line is ``{"ok": true, "device": {...}}``;
any failed check raises and exits non-zero.  Without a GPU, or without
the package beside it, it exits non-zero and prints no result.

Inputs are generated from ``--seed`` with numpy in a temporary
directory:

* ascii50k: 50,000 distinct printable-ASCII patterns of 4-32 B with
  shared prefixes, plus 3 patterns of 40-64 B (the long-tail split and
  its host literal search), over printable text;
* clamav5k: 5,000 binary signatures of 8-32 B (sigma 256: the s0x
  prologue and split steps), written as \\xNN escapes, over random bytes.

Both run with streamnum 1 (4 shards) and width 4096; each corpus holds
100,000 planted dictionary patterns.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

DEVICE = "cuda"
MIB = 1 << 20
CHUNK = 16 * MIB  # the CLI's match_chunked window
SEG, HALO = 4096, 512  # the CLI's default segment cut
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PLANTS = 100_000
CHAIN_K = 8
NO_LIBRARY = ("no single PyTorch call computes the automaton walk "
              "(a data-dependent chain of table gathers)")


def check(ok, what: str) -> None:
    """A failed check ends the run (not ``assert``: it must survive -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


MAX_ERR = {"plan_scan": 0, "depth_scan": 0}  # kernel vs plain, this run


def agree(kernel: str, got, want, what: str) -> None:
    """Hold a kernel's int32 outputs to its plain version's (exact):
    records the largest absolute difference, fails on any."""
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    MAX_ERR[kernel] = max(MAX_ERR[kernel], err)
    check(err == 0, f"{what}: kernel != plain (max abs err {err})")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


# ---- inputs ------------------------------------------------------------------

def make_ascii50k(rng) -> list[bytes]:
    """50,000 distinct printable-ASCII patterns of 4-32 B grown from
    5,000 shared stems, plus 3 patterns of 40-64 B."""
    printable = np.arange(32, 127, dtype=np.uint8)
    stems = [bytes(rng.choice(printable, int(rng.integers(3, 11))))
             for _ in range(5000)]
    pats: dict[bytes, None] = {}
    while len(pats) < 50_000:
        stem = stems[int(rng.integers(0, len(stems)))]
        n = int(rng.integers(max(4 - len(stem), 1), 33 - len(stem)))
        pats[stem + bytes(rng.choice(printable, n))] = None
    out = list(pats)
    for _ in range(3):
        out.append(bytes(rng.choice(printable, int(rng.integers(40, 65)))))
    return out


def make_signatures(n_sigs: int, seed: int = 7) -> list[bytes]:
    """ClamAV-style byte signatures: 8-32 random bytes each (the same
    generator as bench/binary.py)."""
    rng = np.random.default_rng(seed)
    sigs = set()
    while len(sigs) < n_sigs:
        ln = int(rng.integers(8, 33))
        sigs.add(bytes(rng.integers(0, 256, ln, dtype=np.uint8)))
    return sorted(sigs)


def make_corpus(rng, pats, size, alphabet=None):
    """``size`` bytes with PLANTS dictionary patterns at known places;
    returns (corpus, planted (pos, 1-based id) pairs)."""
    if alphabet is None:
        buf = rng.integers(0, 256, size, dtype=np.uint8)
    else:
        buf = rng.choice(alphabet, size)
    slot = size // PLANTS
    ids = rng.integers(0, len(pats), PLANTS)
    ids[: min(3, PLANTS)] = np.arange(len(pats) - 3, len(pats))  # long ones
    planted = []
    for k, i in enumerate(ids):
        p = pats[int(i)]
        pos = k * slot + int(rng.integers(0, slot - len(p)))
        buf[pos: pos + len(p)] = np.frombuffer(p, np.uint8)
        planted.append((pos, int(i) + 1))
    return buf.tobytes(), planted


def write_inputs(tmp, name, pats, corpus, escapes):
    pat_file = os.path.join(tmp, f"{name}.pat")
    with open(pat_file, "wb") as f:
        for p in pats:
            f.write("".join(f"\\x{b:02x}" for b in p).encode()
                    if escapes else p)
            f.write(b"\n")
    in_file = os.path.join(tmp, f"{name}.in")
    with open(in_file, "wb") as f:
        f.write(corpus + b"\n")  # the CLI scans filesize - 1 bytes
    return pat_file, in_file


_LINE = re.compile(rb"At position +(\d+), match pattern (\d+)")


def read_output(path) -> np.ndarray:
    with open(path, "rb") as f:
        return np.asarray(_LINE.findall(f.read()), np.int64).reshape(-1, 2)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---- timing ------------------------------------------------------------------

def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_pos: int, table_bytes: int, bitmap: bool) -> float:
    """Least time for the bytes the scan must move: 4 B of staged
    stream read per position, the tables read once, and (bitmap mode)
    4 B of counts plus 4 B of bitmap written per position."""
    per_pos = 12 if bitmap else 4
    return (per_pos * n_pos + table_bytes) / HBM_BYTES_PER_S * 1e3


# ---- phases ------------------------------------------------------------------

def shard_kernels(matcher):
    """Per shard of the main path: (kind, bitmap scanner); a split
    shard's scanner is its short part's."""
    return [
        ("split", e[1][1]) if isinstance(e, tuple)  # long-pattern split
        else (type(e).__name__, e)
        for e in matcher._get_scanners()
    ]


def scan_inputs(scanner, window: bytes, device):
    """(staged stream, input_size) of one window for ``scanner``."""
    from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
    from phfpfac_tpu_torch.ops.staging import to_device_bytes

    ms = padded_steps(scanner.shard.max_pat_len)
    data = to_device_bytes(pad_input(window, 1024, ms), device)
    return scanner.stage(data, len(window), ms), len(window)


def kernel_parity(name, kinds, window, device):
    """K1 against its plain version on the card, on every shard the
    main path gives it; returns per-shard records for the later phases."""
    from phfpfac_tpu_torch.ops import plan as K1

    recs = []
    for si, (_kind, sc) in enumerate(kinds):
        staged, n = scan_inputs(sc, window, device)
        rec = dict(shard=si, scanner=sc, staged=staged, n=n)
        if isinstance(sc, K1.PlanShardScanner):
            t = sc.tables
            for seg in (SEG, 0):
                got = K1.plan_scan(staged, t, seg_bytes=seg, halo_bytes=HALO)
                want = K1.plan_scan_plain(staged, t, seg_bytes=seg,
                                          halo_bytes=HALO)
                agree("plan_scan", got, want,
                      f"{name} shard {si}: plan bitmap (seg={seg})")
                if seg:
                    rec["plan_bits"] = got[1]
                    rec["matches"] = int(got[0][:n].sum())
            agree("plan_scan", [K1.plan_scan(staged, t, emit="count")],
                  [K1.plan_scan_plain(staged, t, emit="count")],
                  f"{name} shard {si}: plan count")
        recs.append(rec)
    return recs


def depth_parity(name, compiled, recs, window, device):
    """K2 on every shard, held to its plain version and to K1's bitmap."""
    from phfpfac_tpu_torch.ops import depth as K2

    out = []
    for rec, sh in zip(recs, compiled.shards):
        ds = K2.DepthShardScanner(sh, device=device)
        staged, n = scan_inputs(ds, window, device)
        t = ds.tables
        got = K2.depth_scan(staged, t, input_size=n, seg_bytes=SEG,
                            halo_bytes=HALO)
        want = K2.depth_scan_plain(staged, t, input_size=n, seg_bytes=SEG,
                                   halo_bytes=HALO)
        agree("depth_scan", got, want,
              f"{name} shard {rec['shard']}: depth bitmap")
        check(torch.equal(got[1][:n], rec["plan_bits"][:n]),
              f"{name} shard {rec['shard']}: depth bitmap != plan bitmap")
        agree("depth_scan",
              [K2.depth_scan(staged, t, input_size=n, emit="count")],
              [K2.depth_scan_plain(staged, t, input_size=n, emit="count")],
              f"{name} shard {rec['shard']}: depth count")
        out.append(dict(shard=rec["shard"], scanner=ds, staged=staged, n=n))
    return out


def plain_match_count(kinds, matcher, corpus, input_size, device):
    """Output lines the main path must write: per shard, the popcount of
    the plain version's segment-cut bitmap over the whole corpus, plus
    the host literal matches of a split shard's long tail."""
    from phfpfac_tpu_torch.ops import depth as K2
    from phfpfac_tpu_torch.ops import plan as K1

    total = 0
    for (kind, sc), entry in zip(kinds, matcher._get_scanners()):
        staged, _ = scan_inputs(sc, corpus[:input_size], device)
        if isinstance(sc, K1.PlanShardScanner):
            cnt, _bits = K1.plan_scan_plain(staged, sc.tables, seg_bytes=SEG,
                                            halo_bytes=HALO)
        else:
            cnt, _bits = K2.depth_scan_plain(staged, sc.tables,
                                             input_size=input_size,
                                             seg_bytes=SEG, halo_bytes=HALO)
        total += int(cnt[:input_size].sum())
        del staged, cnt, _bits
        if kind == "split":
            total += len(matcher._host_literal_one(corpus, input_size,
                                                   entry[1][3]))
    return total


def profile_match(matcher, corpus, input_size) -> dict:
    """Where one match phase's time goes: a torch.profiler trace of
    ``match_chunked``; device busy time by kernel name over the wall
    time (None where the trace shows no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        matcher.match_chunked(corpus, input_size=input_size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        # device-side events only: kernels, memcpys, memsets
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)", "anon")
            if name.startswith("void "):  # a kernel: drop its arguments
                name = re.sub(r"\(.*", "", name)[:60]
            by_name[name] = (by_name.get(name, 0.0)
                             + e.self_device_time_total / 1e6)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_seconds=wall,
                device_busy_seconds=busy if busy else None,
                idle_share=1 - busy / wall if busy else None,
                top_device_seconds=dict(top))


def run_cli(args):
    from phfpfac_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    check(cli_main([str(a) for a in args] + ["--device", DEVICE]) == 0,
          "the CLI exited non-zero")
    return time.perf_counter() - t0


def time_kernels(recs, depth_recs):
    """Per 16 MiB chunk (summed over the 4 shards): kernel and plain
    times, bitmap mode with the segment cut and count mode, and k=8
    chained count scans."""
    from phfpfac_tpu_torch.ops import depth as K2
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.staging import TILE

    def per_chunk(items, kernel, plain, extra):
        r = dict(ms=0.0, plain_ms=0.0, count_ms=0.0, count_plain_ms=0.0,
                 chain_ms_per_scan=0.0, bound_ms=0.0, count_bound_ms=0.0,
                 n_pos=0)
        for it in items:
            st, t = it["staged"], it["scanner"].tables
            kw = extra(it)
            n_pos = st.numel() - TILE
            tb = sum(x.numel() * 4 for x in vars(t).values()
                     if isinstance(x, torch.Tensor))
            r["ms"] += cuda_ms(lambda: kernel(st, t, seg_bytes=SEG,
                                              halo_bytes=HALO, **kw))
            r["plain_ms"] += cuda_ms(lambda: plain(st, t, seg_bytes=SEG,
                                                   halo_bytes=HALO, **kw),
                                     reps=2)
            r["count_ms"] += cuda_ms(lambda: kernel(st, t, emit="count",
                                                    **kw))
            r["count_plain_ms"] += cuda_ms(
                lambda: plain(st, t, emit="count", **kw), reps=2)

            def chain():
                prev = None
                for _ in range(CHAIN_K):
                    prev = kernel(st, t, emit="count", prev_total=prev, **kw)
                return prev

            r["chain_ms_per_scan"] += cuda_ms(chain) / CHAIN_K
            r["bound_ms"] += bound_ms(n_pos, tb, True)
            r["count_bound_ms"] += bound_ms(n_pos, tb, False)
            r["n_pos"] += n_pos
        return r

    plan_items = [r for r in recs
                  if isinstance(r["scanner"], K1.PlanShardScanner)]
    k1 = per_chunk(plan_items, K1.plan_scan, K1.plan_scan_plain,
                   lambda it: {})
    k2 = per_chunk(depth_recs, K2.depth_scan, K2.depth_scan_plain,
                   lambda it: {"input_size": it["n"]})
    return k1, k2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=64,
                    help="main-path corpus size per dictionary")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from phfpfac_tpu_torch import _build, compile_dictionary
    from phfpfac_tpu_torch.frontend.patterns import Pattern
    from phfpfac_tpu_torch.ops import depth as K2
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.oracle.ac import match_oracle
    from phfpfac_tpu_torch.parallel.matcher import Matcher
    from phfpfac_tpu_torch.parallel.merge import render_result_file
    from phfpfac_tpu_torch.utils.config import PfacConfig

    device = torch.device(DEVICE)

    # ---- 0. device ----
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- 1. build ----
    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources=list(_build.SOURCES))

    rng = np.random.default_rng(args.seed)
    size = args.mib * MIB
    dicts = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 2. dictionaries ----
        printable = np.arange(32, 127, dtype=np.uint8)
        for name, pats, alphabet, escapes in (
            ("ascii50k", make_ascii50k(rng), printable, False),
            ("clamav5k", make_signatures(5000, seed=7), None, True),
        ):
            corpus, planted = make_corpus(rng, pats, size, alphabet)
            files = write_inputs(tmp, name, pats, corpus, escapes)
            cfg = PfacConfig(width=4096, num_shards=4, truncation="segment")
            t0 = time.perf_counter()
            compiled = compile_dictionary(files[0], cfg, escapes=escapes)
            t1 = time.perf_counter()
            # the CLI trains the plan layout on its first chunk's head
            matcher = Matcher(compiled, cfg, device=device,
                              train=corpus[:MIB])
            kinds = shard_kernels(matcher)
            t2 = time.perf_counter()
            dicts[name] = dict(pats=pats, corpus=corpus, planted=planted,
                               files=files, escapes=escapes, cfg=cfg,
                               compiled=compiled, matcher=matcher,
                               kinds=kinds)
            emit("dictionary", name=name, patterns=len(pats),
                 compile_seconds=t1 - t0, kernel_tables_seconds=t2 - t1,
                 shards=[dict(states=sh.state_num,
                              finals=sh.final_state_num,
                              max_pat_len=sh.max_pat_len, kernel=k[0])
                         for sh, k in zip(compiled.shards, kinds)])

        # ---- 3. kernel parity on the card ----
        for name, d in dicts.items():
            window = d["corpus"][:CHUNK]
            d["recs"] = kernel_parity(name, d["kinds"], window, device)
            emit("parity", dictionary=name, kernel="plan_scan",
                 modes=["bitmap+segment", "bitmap+exact", "count"],
                 equal=True, matches=[r.get("matches") for r in d["recs"]])
        clam = dicts["clamav5k"]
        clam["depth_recs"] = depth_parity(
            "clamav5k", clam["compiled"], clam["recs"],
            clam["corpus"][:CHUNK], device)
        emit("parity", dictionary="clamav5k", kernel="depth_scan",
             modes=["bitmap+segment", "count"], equal=True,
             equal_to_plan_bitmap=True)

        # ---- 4. main path: the gphf CLI ----
        launches = {}
        for name, d in dicts.items():
            pat_file, in_file = d["files"]
            out = os.path.join(tmp, f"{name}.out")
            flags = ["--escapes"] if d["escapes"] else []
            K1.launches = K2.launches = 0
            secs = run_cli([pat_file, 1, 4096, in_file, "-o", out,
                            "--quiet", *flags])
            launches[name] = dict(plan_scan=K1.launches,
                                  depth_scan=K2.launches)
            check(K1.launches > 0, f"{name}: the plan kernel never ran")
            got = read_output(out)
            got_set = set(map(tuple, got.tolist()))
            missing = [p for p in d["planted"] if p not in got_set]
            check(not missing,
                  f"{name}: planted matches missing {missing[:5]}")
            input_size = len(d["corpus"])
            want_lines = plain_match_count(d["kinds"], d["matcher"],
                                           d["corpus"], input_size, device)
            check(len(got) == want_lines,
                  f"{name}: {len(got)} output lines, plain bitmaps say "
                  f"{want_lines}")
            d["cli_seconds"] = secs
            # the match phase alone, on the tables built in phase 2
            t0 = time.perf_counter()
            d["matcher"].match_chunked(d["corpus"], input_size=input_size)
            torch.cuda.synchronize()
            d["match_seconds"] = time.perf_counter() - t0
            emit("main_path", dictionary=name, corpus_bytes=input_size,
                 seconds=secs, gb_per_s=input_size / secs / 1e9,
                 match_seconds=d["match_seconds"],
                 match_gb_per_s=input_size / d["match_seconds"] / 1e9,
                 output_lines=len(got), planted_found=len(d["planted"]),
                 launches=launches[name])
            emit("match_trace", dictionary=name,
                 **profile_match(d["matcher"], d["corpus"], input_size))

            # a small file, byte-identical to the oracle
            small = d["corpus"][: 256 * 1024]
            s_in = os.path.join(tmp, f"{name}.small")
            with open(s_in, "wb") as f:
                f.write(small + b"\n")
            s_out = os.path.join(tmp, f"{name}.small.out")
            run_cli([pat_file, 1, 4096, s_in, "-o", s_out, "--quiet",
                     *flags])
            pats = [Pattern(i + 1, p) for i, p in enumerate(d["pats"])]
            want = np.asarray(match_oracle(pats, small, d["cfg"]),
                              np.int64).reshape(-1, 2)
            with open(s_out) as f:
                check(f.read() == render_result_file(want),
                      f"{name}: 256 KiB output differs from the oracle")
            emit("oracle", dictionary=name, bytes=len(small),
                 matches=len(want), identical=True)

        # the depth kernel's path: a segment geometry the plan kernel
        # does not take (not a power of two) routes every shard to K2
        window = clam["corpus"][:CHUNK]
        cfg = PfacConfig(width=4096, num_shards=4, truncation="segment",
                         segment_bytes=6144, halo_bytes=HALO)
        dm = Matcher(clam["compiled"], cfg, device=device)
        K1.launches = K2.launches = 0
        t0 = time.perf_counter()
        got = dm.match_chunked(window)
        secs = time.perf_counter() - t0
        launches["depth_path"] = dict(plan_scan=K1.launches,
                                      depth_scan=K2.launches)
        check(K2.launches > 0, "the depth kernel never ran on its path")
        want_lines = 0
        for sc in dm._get_scanners():
            check(isinstance(sc, K2.DepthShardScanner),
                  "the depth path took another kernel")
            staged, n = scan_inputs(sc, window, device)
            cnt, _ = K2.depth_scan_plain(staged, sc.tables, input_size=n,
                                         seg_bytes=6144, halo_bytes=HALO)
            want_lines += int(cnt[:n].sum())
        check(len(got) == want_lines, "depth path != plain bitmaps")
        emit("depth_path", dictionary="clamav5k", corpus_bytes=len(window),
             segment_bytes=6144, seconds=secs, matches=len(got),
             launches=launches["depth_path"])

    # ---- 5. times ----
    k1, _ = time_kernels(dicts["ascii50k"]["recs"], [])
    k1c, k2 = time_kernels(clam["recs"], clam["depth_recs"])
    for label, r in (("plan_scan/ascii50k", k1), ("plan_scan/clamav5k", k1c),
                     ("depth_scan/clamav5k", k2)):
        emit("times", kernel=label, per="16 MiB chunk, 4 shards", **r)
    for name, d in dicts.items():
        emit("times", kernel="cli", dictionary=name,
             seconds=d["cli_seconds"],
             gb_per_s=len(d["corpus"]) / d["cli_seconds"] / 1e9)

    # ---- 6. kernels ----
    kernels = [
        dict(name="plan_scan", route="cuda",
             source="phfpfac_tpu_torch/csrc/plan_scan.cu",
             replaces="phfpfac_tpu/ops/pallas_plan.py:729",
             launches=launches["ascii50k"]["plan_scan"],
             max_abs_err=MAX_ERR["plan_scan"], ms=k1["ms"],
             plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by="bytes", library_ms=None,
             library_note=NO_LIBRARY,
             detail={"ascii50k": k1, "clamav5k": k1c,
                     "launches": launches}),
        dict(name="depth_scan", route="cuda",
             source="phfpfac_tpu_torch/csrc/depth_scan.cu",
             replaces="phfpfac_tpu/ops/pallas_depth.py:113",
             launches=launches["depth_path"]["depth_scan"],
             max_abs_err=MAX_ERR["depth_scan"], ms=k2["ms"],
             plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by="bytes", library_ms=None,
             library_note=NO_LIBRARY, detail={"clamav5k": k2}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
