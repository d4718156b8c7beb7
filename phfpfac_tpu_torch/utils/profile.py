"""Device timing and tracing: CUDA-event kernel times, the program's own
spans and counters, and the ``torch.profiler`` trace behind the CLI's
``--profile DIR`` (the JAX package's ``jax.profiler.trace``).

Spans and counters record only while a ``torch.profiler`` capture is
active (one check of ``torch.autograd._profiler_enabled()`` a call);
otherwise ``span`` returns one shared null context and ``count`` returns
at once.  A span enters ``torch.profiler.record_function(name)``, so it
lies on the profiler's timeline beside the kernels and copies, and adds
its host seconds and one call to per-name totals that ``snapshot()``
returns.  Program spans are named ``stage:<area>.<step>`` and are leaves:
the code closes one before it calls into another, and a span opened
while another is open in the same thread records nothing (its time
stays with the open one; counters still count).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time

import torch

_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()  # .open: a span of this thread is open
_spans: dict[str, list] = {}  # name -> [seconds, calls]
_counters: dict[str, int] = {}


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if getattr(_local, "open", False):
            return self  # inside another span: its time, not ours
        _local.open = True
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._rf is None:
            return False
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        self._rf = None
        _local.open = False
        with _lock:
            tot = _spans.get(self.name)
            if tot is None:
                _spans[self.name] = [dt, 1]
            else:
                tot[0] += dt
                tot[1] += 1
        return False


def span(name: str):
    """A context that records ``name`` while a capture is active."""
    if not _enabled():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a capture is active."""
    if not _enabled():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def _no_step(_name: str) -> None:
    pass


@contextlib.contextmanager
def steps():
    """Consecutive spans over one function's phases: the block gets a
    function ``step(name)`` that closes the open span and opens ``name``;
    the block's end closes the last."""
    if not _enabled():
        yield _no_step
        return
    cur = []

    def step(name: str) -> None:
        if cur:
            cur.pop().__exit__(None, None, None)
        s = _Span(name)
        s.__enter__()
        cur.append(s)

    try:
        yield step
    finally:
        if cur:
            cur.pop().__exit__(None, None, None)


def snapshot() -> dict:
    """A copy of the totals: ``{"spans": {name: [seconds, calls]},
    "counters": {name: n}}``."""
    with _lock:
        return {"spans": {k: list(v) for k, v in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    """Clear every span total and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()


def difference(before: dict, after: dict) -> dict:
    """What was recorded between two snapshots (names with calls or
    counts in between)."""
    spans = {}
    for k, (sec, calls) in after["spans"].items():
        s0, c0 = before["spans"].get(k, (0.0, 0))
        if calls > c0:
            spans[k] = [sec - s0, calls - c0]
    counters = {k: n - before["counters"].get(k, 0)
                for k, n in after["counters"].items()
                if n > before["counters"].get(k, 0)}
    return {"spans": spans, "counters": counters}


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after one warm-up
    call)."""
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


DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_name(name: str) -> str:
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = re.sub(r"\(.*", "", name)[:60]
    return name


def _is_device_op(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    try:
        return e.activity_type() in DEVICE_KINDS
    except AttributeError:  # older profilers: no activity type
        return not e.is_user_annotation()


class MatchTrace:
    """What ``trace`` recorded: the profiler, the wall seconds of the
    traced block, the program's spans and counters recorded in it
    (``program``, as ``snapshot()`` gives them) and, once it has ended,
    the files it exported."""

    def __init__(self):
        self.prof = None
        self.wall_seconds = None
        self.program = None
        self.path = None
        self.spans_path = None

    def device_events(self) -> list:
        """(start ns, end ns, name) of every kernel, copy and set in the
        profiler's raw events; a kernel's name without its arguments."""
        return [(e.start_ns(), e.start_ns() + e.duration_ns(),
                 _device_name(e.name()))
                for e in self.prof.profiler.kineto_results.events()
                if _is_device_op(e)]

    def device_seconds_by_name(self) -> dict:
        """Device-side seconds (kernels, copies, sets) by name."""
        out = {}
        for s, e, name in self.device_events():
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
        return out

    def device_busy_seconds(self) -> float:
        """The union of every kernel's, copy's and set's interval."""
        busy = reach = 0
        for s, e, _n in sorted(self.device_events()):
            busy += max(0, e - max(s, reach))
            reach = max(reach, e)
        return busy / 1e9

    def summary(self, top: int = 6) -> dict:
        """Device busy seconds (the union of the device's intervals) over
        the wall seconds, and the ``top`` names by device time (None where
        the trace shows no device time)."""
        by_name = self.device_seconds_by_name()
        busy = self.device_busy_seconds()
        first = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return dict(wall_seconds=self.wall_seconds,
                    device_busy_seconds=busy if busy else None,
                    idle_share=(1 - busy / self.wall_seconds) if busy
                    else None,
                    top_device_seconds=dict(first))


@contextlib.contextmanager
def trace(out_dir=None, *, device="cuda"):
    """Trace the block with ``torch.profiler``: CPU and CUDA activities
    on a CUDA device, CPU alone on the CPU.  The block's device work is
    waited for before the trace ends.  With ``out_dir`` the Chrome trace
    is exported there as ``match_<pid>.trace.json`` and the program's
    spans and counters as ``match_<pid>.spans.json``.  Yields a
    ``MatchTrace``."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    mt = MatchTrace()
    before = snapshot()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield mt
        if on_card:
            torch.cuda.synchronize()
        mt.wall_seconds = time.perf_counter() - t0
    mt.prof = prof
    mt.program = difference(before, snapshot())
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.join(out_dir, f"match_{os.getpid()}")
        mt.path = base + ".trace.json"
        prof.export_chrome_trace(mt.path)
        mt.spans_path = base + ".spans.json"
        with open(mt.spans_path, "w") as f:
            json.dump(dict(mt.program, wall_seconds=mt.wall_seconds), f,
                      indent=1, sort_keys=True)
