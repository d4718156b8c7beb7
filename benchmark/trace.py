"""``torch.profiler`` over the measured window, reduced to what the metrics
and the breakdown read: the device's busy time (the union of its
kernels, copies and sets), the window's length, device time by operation,
idle time by what the host was doing (the innermost ``stage:`` or
``bench:`` range open at the middle of each idle gap), and the scan
kernels' launches and device seconds; and the scan launches the program
counts itself."""

from __future__ import annotations

import contextlib
import dataclasses
import re
import sys

import numpy as np
import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench:window"  # the range around the measured window
HOST_RANGES = ("stage:", "bench:")
SCAN_KERNEL = "_scan_kernel"  # every scan kernel of the port's csrc/
SCAN_OPS = "phfpfac_tpu_torch.ops."  # the modules that launch them


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list  # [name, seconds], longest first
    idle_gaps: list  # [what the host was doing, seconds], longest first
    scan_kernels: int  # scan-kernel launches inside the window
    scan_s: float  # their device seconds, summed

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def scan_launches() -> int:
    """The scan-kernel launches the program has counted so far: the sum
    of every ``launches*`` counter of the loaded modules of
    ``phfpfac_tpu_torch.ops``, one a launch of a kernel named
    ``*SCAN_KERNEL*`` (the CPU's plain scans count none)."""
    return sum(v for name, mod in list(sys.modules.items())
               if name.startswith(SCAN_OPS)
               for k, v in vars(mod).items()
               if k.startswith("launches") and type(v) is int)


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    return re.sub(r"[(<].*", "", name)[:60]


def _kind(e):
    try:
        return e.activity_type()
    except AttributeError:  # older profilers: no activity type
        return None


def _is_device_op(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = _kind(e)
    if kind is not None:
        return kind in DEVICE_KINDS
    return not e.is_user_annotation()


def _union(starts, ends):
    """Merged intervals of [starts, ends), sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    return s[first], np.maximum.reduceat(e, first) if len(first) else e[:0]


def reduce(events, top: int = 10) -> Trace:
    """The ``Trace`` of a profile's raw events (``kineto_results``)."""
    window = [e for e in events if e.name() == WINDOW
              and e.device_type() == torch.autograd.DeviceType.CPU]
    if not window:
        raise RuntimeError("the trace holds no measured window")
    t0 = window[0].start_ns()
    t1 = t0 + window[0].duration_ns()
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in events if _is_device_op(e)]
    names = [short_name(n) for _s, _e, n in dev]
    by_name = {}
    for (s, e, _n), name in zip(dev, names):
        by_name[name] = by_name.get(name, 0) + (e - s)
    starts = np.clip(np.asarray([d[0] for d in dev], np.int64), t0, t1)
    ends = np.clip(np.asarray([d[1] for d in dev], np.int64), t0, t1)
    scan = np.asarray([SCAN_KERNEL in n for _s, _e, n in dev], bool) & \
        (ends > starts)
    us, ue = _union(starts, ends)
    busy = int((ue - us).sum())
    # the idle gaps inside the window, labelled by the host's ranges
    gs = np.concatenate([[t0], ue])
    ge = np.concatenate([us, [t1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mid = (gs + ge) // 2
    label = np.full(len(mid), -1)
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events
            if e.device_type() == torch.autograd.DeviceType.CPU
            and e.name().startswith(HOST_RANGES) and e.name() != WINDOW]
    host.sort(key=lambda h: -(h[1] - h[0]))  # outer first, inner wins
    host_names = sorted({h[2] for h in host})
    index = {n: i for i, n in enumerate(host_names)}
    for s, e, n in host:
        lo, hi = np.searchsorted(mid, [s, e])
        label[lo:hi] = index[n]
    idle = {}
    for lab, d in zip(label.tolist(), (ge - gs).tolist()):
        key = host_names[lab] if lab >= 0 else "host:unmarked"
        idle[key] = idle.get(key, 0) + d
    return Trace(
        window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9,
        device_ops=[[k, v / 1e9] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[k, v / 1e9] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
        scan_kernels=int(scan.sum()),
        scan_s=float((ends - starts)[scan].sum()) / 1e9)


@contextlib.contextmanager
def capture(on_card: bool):
    """Profile the block (CPU and CUDA activities); yields a dict that
    holds the ``Trace`` under ``"trace"`` once the block has ended.  The
    block marks its measured window with ``window()``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    out = {}
    with profile(activities=acts) as prof:
        yield out
        if on_card:
            torch.cuda.synchronize()
    out["trace"] = reduce(prof.profiler.kineto_results.events())


def window():
    """The range that marks the measured window inside ``capture``."""
    return torch.profiler.record_function(WINDOW)


def bench_range(name: str):
    return torch.profiler.record_function(f"bench:{name}")
