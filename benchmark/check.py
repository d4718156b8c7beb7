"""The comparison that decides ``correct``: the program's rows against the
plain reference's, row for row.

Three numbers, summed over every answer a run checks, each with the limit
0 (an exact comparison):

* ``missing``: rows the reference has and the program does not (as
  multisets of (position, pattern id));
* ``extra``: rows the program has and the reference does not;
* ``misplaced``: places in the sequence where the two differ, plus the
  difference of their lengths: rows out of the upstream's order count here
  when the sets agree.
"""

from __future__ import annotations

import numpy as np

LIMITS = dict(missing=0, extra=0, misplaced=0)


def _keys(rows: np.ndarray) -> np.ndarray:
    return rows[:, 0].astype(np.int64) * (1 << 32) + rows[:, 1]


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """``got`` (position, id) rows against ``want`` (position, id, ...)."""
    got = np.asarray(got).reshape(-1, 2)
    want = np.asarray(want)[:, :2]
    if got.shape == want.shape and np.array_equal(got, want):
        return dict(missing=0, extra=0, misplaced=0)
    got, want = got.astype(np.int64), want.astype(np.int64)
    a, ca = np.unique(_keys(got), return_counts=True)
    b, cb = np.unique(_keys(want), return_counts=True)
    _common, ia, ib = np.intersect1d(a, b, assume_unique=True,
                                     return_indices=True)
    both = int(np.minimum(ca[ia], cb[ib]).sum())
    n = min(len(got), len(want))
    differ = int((got[:n] != want[:n]).any(axis=1).sum())
    return dict(missing=len(want) - both, extra=len(got) - both,
                misplaced=differ + abs(len(got) - len(want)))


def check(answers) -> tuple[dict, int, int]:
    """(the numbers summed, answers counted, counted answers that failed)
    over ``answers``: (got, want, counted) triples, the program's rows of
    one answer, the reference's, and whether the answer counts (the
    warm-up's and the serial pass's are checked, not counted)."""
    total = dict.fromkeys(LIMITS, 0)
    attempted = failed = 0
    for got, want, counted in answers:
        numbers = compare(got, want)
        for k, v in numbers.items():
            total[k] += v
        attempted += counted
        failed += counted and any(numbers.values())
    return total, attempted, failed


def correct(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())


def lines(numbers: dict) -> list[str]:
    """Each number compared beside its limit, one a line."""
    return [f"{k} {numbers[k]} (limit {lim})" for k, lim in LIMITS.items()]


def compared(numbers: dict) -> dict:
    """The result line's record of the same."""
    return {k: dict(value=numbers[k], limit=lim)
            for k, lim in LIMITS.items()}
