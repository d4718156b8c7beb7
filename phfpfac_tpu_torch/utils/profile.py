"""Device timing and tracing: CUDA-event kernel times and the
``torch.profiler`` trace behind the CLI's ``--profile DIR`` (the JAX
package's ``jax.profiler.trace``)."""

from __future__ import annotations

import contextlib
import os
import re
import time

import torch


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


class MatchTrace:
    """What ``trace`` recorded: the profiler, the wall seconds of the
    traced block and, once it has ended, the file it exported."""

    def __init__(self):
        self.prof = None
        self.wall_seconds = None
        self.path = None

    def device_seconds_by_name(self) -> dict:
        """Device-side seconds (kernels, memcpys, memsets) by name; a
        kernel's name without its arguments."""
        by_name = {}
        for e in self.prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.key.replace("(anonymous namespace)", "anon")
                if name.startswith("void "):
                    name = re.sub(r"\(.*", "", name)[:60]
                by_name[name] = (by_name.get(name, 0.0)
                                 + e.self_device_time_total / 1e6)
        return by_name

    def summary(self, top: int = 6) -> dict:
        """Device busy seconds over the wall seconds, and the ``top``
        names by device time (None where the trace shows no device
        time)."""
        by_name = self.device_seconds_by_name()
        busy = sum(by_name.values())
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
    is exported there as ``match_<pid>.trace.json``.  Yields a
    ``MatchTrace``."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    mt = MatchTrace()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield mt
        if on_card:
            torch.cuda.synchronize()
        mt.wall_seconds = time.perf_counter() - t0
    mt.prof = prof
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        mt.path = os.path.join(out_dir, f"match_{os.getpid()}.trace.json")
        prof.export_chrome_trace(mt.path)
