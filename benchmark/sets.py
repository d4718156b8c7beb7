"""Runs of one cell in sets, and the spread of each metric: what a bound is
set from.

    python3 benchmark/sets.py --workload <cell> --seeds 11,12,13
                              [--sets 2] [--seconds S] [--trace 0|1]
                              [--log DIR]

Runs ``run.py`` once a seed, one process after another, ``--sets`` times
over the same seeds (default: ``run_seconds`` of ``BENCHMARK.json``).
Each run's result line is printed as it comes, with its exit code and
wall seconds; with ``--log`` each run's standard output and error are
kept there.  Then, for each metric and set: the values, the median and
the spread, the distance between the first and third quartile as
``statistics.quantiles(values, n=4)`` gives them, over the median; and
five times the wider of the sets' spreads.  The last line is one JSON
object with all of it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one(workload: str, seed: int, seconds, trace: int, log: str | None,
        tag: str) -> dict:
    cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"),
           "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    wall = time.perf_counter() - t0
    if log:
        os.makedirs(log, exist_ok=True)
        for ext, text in (("out", p.stdout), ("err", p.stderr)):
            with open(os.path.join(log, f"{tag}.{ext}"), "w") as f:
                f.write(text)
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    if result is None:
        sys.stderr.write(p.stderr[-3000:])
    return dict(seed=seed, rc=p.returncode, wall_s=wall, result=result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--log", default=None)
    a = ap.parse_args(argv)
    if a.seconds is None:
        with open(ROOT / "BENCHMARK.json") as f:
            a.seconds = json.load(f)["run_seconds"]
    seeds = [int(s) for s in a.seeds.split(",")]
    runs = []
    for k in range(a.sets):
        for i, s in enumerate(seeds):
            r = one(a.workload, s, a.seconds, a.trace, a.log,
                    f"{a.workload}.t{a.trace}.set{k}.{i}.{s}")
            r["set"] = k
            runs.append(r)
            print(json.dumps(r), flush=True)
    summary = {}
    names = sorted({m for r in runs if r["result"]
                    for m in r["result"]["metrics"]})
    for m in names:
        per = []
        for k in range(a.sets):
            v = [r["result"]["metrics"][m]["value"] for r in runs
                 if r["set"] == k and r["result"]
                 and m in r["result"]["metrics"]]
            per.append(dict(values=v, median=statistics.median(v)
                            if v else None, spread=spread(v)))
        spreads = [p["spread"] for p in per if p["spread"] is not None]
        summary[m] = dict(sets=per, widest=max(spreads) if spreads else None,
                          five_times=5 * max(spreads) if spreads else None)
    print(json.dumps(dict(
        workload=a.workload, seconds=a.seconds, trace=a.trace,
        runs=len(runs), correct=sum(bool(r["result"]
                                         and r["result"]["correct"])
                                    for r in runs),
        rcs=[r["rc"] for r in runs], metrics=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
