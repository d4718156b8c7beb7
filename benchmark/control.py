"""The controls of ``correct``: the plain reference put in the program's
place with one of the configuration's guarantees broken, held to the same
comparison.  A sound comparison reads each of them as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

The configurations state no precision, so each control breaks a
guarantee, at the step that would tempt a change to the result path:

* ``order``: the rows of each position by pattern id, not by length (a
  merge that sorts by the cheaper key);
* ``overlap``: the occurrences that cross a chunk's end left out (chunks
  scanned without the read-overlap that makes every occurrence come
  exactly once); for traffic that names its ``chunk_bytes``.

Each control runs at the cell's own size on its own inputs (the same
generators and seeds as ``run.py``), over as many answers as a run of
``--answers`` requests checks: the rows that the cell's loop
(``loops/<kind>.py``) names as the reference's.  It needs no card and runs
nothing of the program.  Prints one JSON line a control and seed: the
numbers and ``correct``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, spec  # noqa: E402
from benchmark.gen import inputs  # noqa: E402


def by_id(want: np.ndarray) -> np.ndarray:
    return want[np.lexsort((want[:, 1], want[:, 0]))]


def no_overlap(want: np.ndarray, chunk: int) -> np.ndarray:
    start, end = want[:, 0], want[:, 0] + want[:, 2] - 1
    return want[start // chunk == end // chunk]


def wants(cell: spec.Cell, seed: int, answers: int):
    """(the reference's rows of each answer a run checks, the chunk the
    program scans them in, or None)."""
    config, traffic, root = cell.config, cell.traffic, cell.root
    pats, words = inputs.dictionary(config, root)
    corpus, _planted = inputs.corpus(config, traffic, pats, words, seed, root)
    loop = spec.loop(traffic["loop"], root)
    ref = spec.reference(config, root)(pats)
    want = loop.reference(ref, config, traffic, corpus)
    return [want(loop.key(traffic, len(corpus), k))
            for k in range(answers)], traffic.get("chunk_bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--answers", type=int, default=3)
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        ws, chunk = wants(cell, seed, a.answers)
        controls = dict(order=by_id)
        if chunk:
            controls["overlap"] = lambda w: no_overlap(w, chunk)
        for name, fn in controls.items():
            numbers, _n, failed = check.check(
                (fn(w)[:, :2], w, True) for w in ws)
            print(json.dumps(dict(workload=a.workload, seed=seed,
                                  control=name, numbers=numbers,
                                  failed=failed,
                                  correct=check.correct(numbers))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
