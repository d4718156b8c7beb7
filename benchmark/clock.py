"""Stage timers swapped into the port's own functions, by name.

Frozen copies of ``chip_e2e.py``'s ``STAGES``, ``stats``, ``TimedCorpus``,
``StageClock``, ``patched`` and ``stage_wrappers``: ``match_chunked``'s
stages timed in place, in the package's own code (a rename there fails
``benchmark/tests/test_bench_wrapped.py``).  Kept here so that
a change to that script never changes what the benchmark measures.
The timers read the host's clock; the scan's device time comes from the
trace (``trace.py``), so the CUDA events of the original are left out.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

STAGES = ("window", "upload", "stage", "k1", "verify", "fetch", "decode",
          "host_tail", "merge")


def stats(samples) -> dict:
    """Median, quartiles and count of ``samples`` (seconds); from 100
    samples on, the highest whole percentile with at least ten samples
    beyond it."""
    a = np.asarray([s for s in samples if s is not None], np.float64)
    if not a.size:
        return dict(n=0, median=None, q1=None, q3=None)
    out = dict(n=int(a.size), median=float(np.median(a)),
               q1=float(np.percentile(a, 25)),
               q3=float(np.percentile(a, 75)))
    if a.size >= 100:
        pct = int(np.floor(100 * (1 - 10 / a.size)))
        out.update(tail_pct=pct, tail=float(np.percentile(a, pct)))
    return out


class TimedCorpus(bytes):
    """The corpus, whose slices start the ``window`` stage of ``clock``:
    ``match_chunked`` copies each chunk's window out of it with
    ``bytes(data[base:wend])`` (a slice of a ``bytes`` subclass is a
    plain ``bytes``, so the rest of the chunk loop sees what it would)."""

    clock = None

    def __getitem__(self, key):
        c = self.clock
        if c is not None and isinstance(key, slice):
            c.reached["window"] = c.reached.get("window", 0) + 1
            if not c.depth and c.window_t0 is None:
                c.barrier()
                c.window_t0 = time.perf_counter()
        return super().__getitem__(key)


class StageClock:
    """What the stage wrappers record: host seconds and calls by stage,
    calls by wrapped name.  ``sync``: each stage is bracketed
    by synchronisations (the serial run); otherwise it is only marked by
    a ``record_function`` range (the traced run)."""

    def __init__(self, card: bool, sync: bool):
        self.card, self.sync = card, sync
        self.seconds = dict.fromkeys(STAGES, 0.0)
        self.calls = dict.fromkeys(STAGES, 0)
        self.reached = {}
        self.depth = 0  # > 0 inside a stage: nested calls are its own
        self.window_t0 = None

    def barrier(self) -> None:
        if self.sync and self.card:
            torch.cuda.synchronize()

    def wrap(self, stage: str, name: str, fn):
        def timed(*a, **kw):
            self.reached[name] = self.reached.get(name, 0) + 1
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            try:
                self.barrier()
                t0 = time.perf_counter()
                with torch.profiler.record_function(f"stage:{stage}"):
                    r = fn(*a, **kw)
                self.barrier()
                self.seconds[stage] += time.perf_counter() - t0
                self.calls[stage] += 1
                return r
            finally:
                self.depth -= 1
        return timed


@contextlib.contextmanager
def patched(items):
    """Each (owner, name, value) set inside the block, then restored
    (or removed where the owner had no such attribute)."""
    missing = object()
    saved = [(o, k, o.__dict__.get(k, missing)) for o, k, _ in items]
    try:
        for o, k, v in items:
            setattr(o, k, v)
        yield
    finally:
        for o, k, old in reversed(saved):
            if old is missing:
                delattr(o, k)
            else:
                setattr(o, k, old)


@contextlib.contextmanager
def stage_wrappers(clock: StageClock):
    """``match_chunked``'s stages timed in place, in the package's own
    code: the functions it reaches swapped for timed versions, restored
    after.  The window copy (``matcher.py``'s ``bytes(data[...])`` and
    zero pad) runs from the slice of a ``TimedCorpus`` to
    ``_dispatch``'s entry."""
    from phfpfac_tpu_torch.ops import plan as plan_mod
    from phfpfac_tpu_torch.parallel import matcher as matcher_mod

    M, PSS = matcher_mod.Matcher, plan_mod.PlanShardScanner
    real_dispatch, real_async = M._dispatch, PSS.scan_async

    def dispatch(self, *a, **kw):
        clock.reached["_dispatch"] = clock.reached.get("_dispatch", 0) + 1
        if clock.window_t0 is not None:
            clock.barrier()
            clock.seconds["window"] += time.perf_counter() - clock.window_t0
            clock.calls["window"] += 1
            clock.window_t0 = None
        return real_dispatch(self, *a, **kw)

    def scan_async(self, *a, **kw):
        clock.reached["scan_async"] = clock.reached.get("scan_async", 0) + 1
        cnt, bits, verify = real_async(self, *a, **kw)
        return cnt, bits, clock.wrap("verify", "verify", verify)

    w = clock.wrap
    items = [
        (M, "_dispatch", dispatch),
        (matcher_mod, "pad_input",
         w("upload", "pad_input", matcher_mod.pad_input)),
        (matcher_mod, "to_device_bytes",
         w("upload", "to_device_bytes", matcher_mod.to_device_bytes)),
        (PSS, "stage", w("stage", "stage", PSS.stage)),
        (plan_mod, "plan_scan",
         w("k1", "plan_scan", plan_mod.plan_scan)),
        (PSS, "scan_async", scan_async),
        (matcher_mod, "fetch_hit_bits",
         w("fetch", "fetch_hit_bits", matcher_mod.fetch_hit_bits)),
        (matcher_mod, "decode_hits",
         w("decode", "decode_hits", matcher_mod.decode_hits)),
        (M, "_host_literal_one",
         w("host_tail", "_host_literal_one", M._host_literal_one)),
        (matcher_mod, "merge_flat_matches",
         w("merge", "merge_flat_matches", matcher_mod.merge_flat_matches)),
    ]
    with patched(items):
        yield clock
