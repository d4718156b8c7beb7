"""Times the plan kernels of the checkout this file sits in: K1
(``plan_scan``) and K1′ (``plan_scan_compact_a``) on ``chip_smoke.py``'s
two dictionaries, per 16 MiB chunk: the 4 shards of the first
``match_chunked`` window of a 64 MiB corpus made by ``chip_smoke.py``'s
generators from seed 0.  Needs one CUDA GPU:

    python3 plan_times.py

It times K1 in bitmap mode under the CLI's segment cut, in count mode and
as a chain of 8 count scans; K1′ at ``chip_smoke``'s cut in bitmap and
count mode; and K1's split, through the same wrapper on reduced tables:
**no walk** (a p0 of misses and no steps: the staged read, one probe and
the cnt / bits writes) and **prologue** (no steps).  Every timed shape is
first held to its plain version (exact).  It also prints what ``nvcc
-Xptxas -v`` says of ``csrc/plan_scan.cu`` (registers, spills, shared
memory per instantiation), and one JSON line.

It uses nothing but ``chip_smoke.py`` and the package beside it, so a copy
of it placed in another checkout (an earlier commit unpacked with ``git
archive`` into a git-ignored directory) times that checkout's kernels the
same way; run the two in turns, A B B A, in one session on the card.
"""

from __future__ import annotations

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
from phfpfac_tpu_torch.ops import plan as K1  # noqa: E402
from phfpfac_tpu_torch.ops.staging import TILE  # noqa: E402
from phfpfac_tpu_torch.parallel.matcher import Matcher  # noqa: E402
from phfpfac_tpu_torch.utils.config import PfacConfig  # noqa: E402
from phfpfac_tpu_torch.utils.profile import cuda_ms  # noqa: E402


def ptxas_report() -> list[str]:
    """What ``nvcc -Xptxas -v`` says of this checkout's plan kernel."""
    src = os.path.join(HERE, "phfpfac_tpu_torch", "csrc", "plan_scan.cu")
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
    return dict(
        ms=cuda_ms(lambda: K1.plan_scan(st, t, **seg)),
        count_ms=cuda_ms(lambda: K1.plan_scan(st, t, emit="count")),
        chain_ms_per_scan=cuda_ms(chain) / cs.CHAIN_K,
        a_ms=cuda_ms(lambda: K1.plan_scan_compact_a(st, t, **kw)),
        count_a_ms=cuda_ms(lambda: K1.plan_scan_compact_a(
            st, t, cut=cut, cap=cap, emit="count")),
        prologue_ms=cuda_ms(
            lambda: K1.plan_scan(st, reduced["prologue"], **seg)),
        no_walk_ms=cuda_ms(
            lambda: K1.plan_scan(st, reduced["no_walk"], **seg)),
        bound_ms=cs.bound_ms(n_pos, tb, True),
        count_bound_ms=cs.bound_ms(n_pos, tb, False),
        n_pos=n_pos, survivors=int(surv[2]), shards=1)


def main() -> int:
    if not torch.cuda.is_available():
        print("plan_times times CUDA kernels: no CUDA device",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    _build.build_all(("plan_scan",))
    rng = np.random.default_rng(0)
    out = dict(root=HERE, nvidia_smi=cs.nvidia_smi(), ptxas=ptxas_report())
    printable = np.arange(32, 127, dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        for name, pats, alphabet, escapes in (
            ("ascii50k", cs.make_ascii50k(rng), printable, False),
            ("clamav5k", cs.make_signatures(5000, seed=7), None, True),
        ):
            corpus, _planted = cs.make_corpus(rng, pats, 64 * cs.MIB,
                                              alphabet)
            files = cs.write_inputs(tmp, name, pats, corpus, escapes)
            cfg = PfacConfig(width=4096, num_shards=4, truncation="segment")
            compiled = compile_dictionary(files[0], cfg, escapes=escapes)
            matcher = Matcher(compiled, cfg, device=device,
                              train=corpus[:cs.MIB])
            total: dict = {}
            for _kind, sc in cs.shard_kernels(matcher):
                if isinstance(sc, K1.PlanShardScanner):
                    for k, v in time_shard(sc, corpus[:cs.CHUNK],
                                           device).items():
                        total[k] = total.get(k, 0) + v
            out[name] = total
            del matcher, compiled, corpus
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
