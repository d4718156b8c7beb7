"""The comparison that decides ``correct`` fails what it has to fail: the
controls (the reference with a guarantee broken, in the program's place),
and a run with the timed path broken underneath.  Each test drives the
rest of a run as the benchmark does, on the CPU at a size a test holds:
the look for a card is skipped and the kernels' plain versions run."""

import numpy as np
import pytest

from benchmark import check, control, run, spec

CELLS = ("englishdic.text", "bigenglishdic.text", "englishdic.invoke")


def small(name):
    return run.shrink(spec.cell(name), run.REHEARSAL)


def go(name, seconds=1.0, trace=False):
    r = run.Run(small(name), seed=2**31 + 5, seconds=seconds, trace=trace,
                device="cpu")
    return r.go(), r


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out, r = go(name)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "compared"
    assert {m["name"] for m in r.cell.end_to_end} == set(out["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_controls_fail(name):
    cell = small(name)
    wants, chunk = control.wants(cell, 2**31 + 5, 3)
    broken = [control.by_id] + ([lambda w: control.no_overlap(w, chunk)]
                                if chunk else [])
    readings = []
    for fn in broken:
        numbers, _n, _failed = check.check(
            (fn(w)[:, :2], w, True) for w in wants)
        readings.append(check.correct(numbers))
    # the order control fails on every cell; the overlap control only
    # where an occurrence crosses a chunk's end, as at the cells' size
    assert readings[0] is False and not all(readings), (name, readings)


def stale(p, monkeypatch):
    """A step that returns its state unchanged: every answer after the
    first is the one before it."""
    M = p.Matcher
    real_chunked = M.match_chunked
    last = {}

    def match_chunked(self, *a, **kw):
        rows = real_chunked(self, *a, **kw)
        out = last.get("rows", rows)
        last["rows"] = rows
        return out

    monkeypatch.setattr(M, "match_chunked", match_chunked)


def half(p, monkeypatch):
    """Half of the batch left out, where rows are made: every other row
    of each ``decode_hits`` call (a shard's, or on the ordered path a
    chunk's)."""
    import phfpfac_tpu_torch.parallel.matcher as mm

    real = mm.decode_hits

    def decode(*a, **kw):
        return real(*a, **kw)[::2]

    monkeypatch.setattr(mm, "decode_hits", decode)


def altered(p, monkeypatch):
    """An answer altered where it is produced: the decode's first match of
    every call one byte later."""
    import phfpfac_tpu_torch.parallel.matcher as mm

    real = mm.decode_hits

    def decode(*a, **kw):
        out = real(*a, **kw)
        if len(out):
            out = np.array(out)
            out[0, 0] += 1
        return out

    monkeypatch.setattr(mm, "decode_hits", decode)


@pytest.mark.parametrize("fault", [stale, half, altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    from benchmark.loops import port

    fault(port(), monkeypatch)
    out, _r = go(name)
    assert not out["correct"], (name, fault.__name__, out["compared"])
    assert out["failed"] > 0
