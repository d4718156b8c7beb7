"""The benchmark of ``phfpfac_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n>
                             --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with a CUDA card.  The cell is
found by name in ``BENCHMARK.json``; its configuration, traffic mix and
metrics in files of their own (``spec.py``).  The run generates its
inputs from ``--seed``, builds the program's state and warms up (the
set-up), measures a closed loop for ``--seconds`` (``loops/``), and
then holds every answer the program gave to the plain reference that
the configuration names (``reference/<name>.py``, default ``ac``;
``check.py``).  With ``--trace 1`` the window runs under
``torch.profiler`` and the stage timers, the program's own count of its
scan launches is read before and after it, a chunked cell times one
request more a stage at a time, and the cell's per-layer metrics are
printed in place of its end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``breakdown``), and last ``compared``, each number compared beside
its limit; the last lines of standard error give the same numbers.  The
run exits non-zero and prints no result without a CUDA card, when the
program is missing, or when ``jax``, ``jaxlib``, ``flax`` or
``phfpfac_tpu`` has been loaded.  ``--rehearse`` runs the whole path on
the CPU at a size a test can hold (the kernels' plain versions).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, clock, spec, work  # noqa: E402
from benchmark import trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "phfpfac_tpu")
KIB = 1 << 10
# --rehearse: every size cut so that the CPU runs a cell in seconds; the
# dictionary's sizes are its kind's own (``REHEARSAL`` of its module)
REHEARSAL = dict(traffic=dict(corpus_bytes=256 * KIB, chunk_bytes=64 * KIB,
                              input_bytes=32 * KIB))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def shrink(cell: spec.Cell, sizes: dict) -> spec.Cell:
    cell = copy.deepcopy(cell)
    d = cell.config["dictionary"]
    d.update(spec.dictionary(d["kind"], cell.root).REHEARSAL)
    d.update(sizes.get("dictionary", {}))
    for k, v in sizes.get("traffic", {}).items():
        if k in cell.traffic:
            cell.traffic[k] = v
    return cell


def card_info() -> dict:
    import torch

    info = dict(name=torch.cuda.get_device_name(0), torch=torch.__version__,
                cuda=torch.version.cuda)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
        info["nvidia_smi"] = out.splitlines()[0] if out else None
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = None
    return info


def note(**kw) -> None:
    print(json.dumps(kw), file=sys.stderr, flush=True)


class Run:
    """One run of one cell: what its loop recorded, the trace, and what
    the metrics' readers read."""

    def __init__(self, cell: spec.Cell, *, seed: int, seconds: float,
                 trace: bool, device: str, t0: float = T0):
        import torch

        self.torch = torch
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace_on = trace
        self.device = torch.device(device)
        self.card = self.device.type == "cuda"
        self.t0 = t0
        self.trace = None  # the window's Trace, with --trace 1
        # scan-kernel launches the program counted in the traced window
        self.launches = None
        self.setup_s = None
        self.states = None  # of the dictionary's whole trie

    def sync(self) -> None:
        if self.card:
            self.torch.cuda.synchronize()

    def go(self, root: Path = ROOT) -> dict:
        torch = self.torch
        with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
            self.tmp = tmp
            kind = self.cell.traffic["loop"]
            loop = self.loop = spec.loop(kind, root)(self)
            if self.card:
                torch.cuda.reset_peak_memory_stats()
            loop.setup()
            self.sync()
            self.setup_s = time.perf_counter() - self.t0
            note(phase="setup", setup_s=self.setup_s, seed=self.seed,
                 patterns=len(loop.pats), corpus_bytes=len(loop.corpus),
                 planted=len(loop.planted))
            if self.trace_on:
                with tr.capture(self.card) as cap, \
                        clock.stage_wrappers(clock.StageClock(
                            self.card, sync=False)):
                    launched = tr.scan_launches()
                    with tr.window():
                        loop.window(self.seconds)
                        self.sync()
                    self.launches = tr.scan_launches() - launched
                self.trace = cap["trace"]
                if self.card and not self.trace.scan_kernels:
                    raise RuntimeError(
                        "the trace shows no scan kernel: the capture lost "
                        "the device's work, and its idle share is unknown")
                loop.serial()
            else:
                loop.window(self.seconds)
            self.sync()
            note(phase="window", **loop.summary(), **(dict(
                scan_kernels=self.trace.scan_kernels,
                scan_launches=self.launches,
                scan_device_s=self.trace.scan_s) if self.trace else {}))
            peak = torch.cuda.max_memory_allocated() if self.card else 0
            loop.release()
            gc.collect()
            if self.card:
                torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ac = spec.reference(self.cell.config, root)(loop.pats)
        numbers, attempted, failed = check.check(loop.answers(ac))
        self.states = work.trie_states(loop.pats)
        note(phase="reference", seconds=time.perf_counter() - t_ref,
             states=self.states, answers=attempted,
             serial=loop.serial_stages)
        entries = self.cell.per_layer if self.trace_on \
            else self.cell.end_to_end
        metrics = {}
        for m in entries:
            v = spec.reader(m["name"], root)(self)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        device = dict(
            platform="gpu" if self.card else "cpu",
            kind=torch.cuda.get_device_name(0) if self.card else "cpu",
            count=self.cell.chips if self.card else 0,
            memory_peak_bytes=int(peak))
        out = dict(correct=check.correct(numbers), attempted=attempted,
                   failed=failed, metrics=metrics, device=device)
        if self.trace_on:
            device.update(busy_s=self.trace.busy_s,
                          window_s=self.trace.window_s)
            out["breakdown"] = dict(device_ops=self.trace.device_ops,
                                    idle_gaps=self.trace.idle_gaps)
        out["card"] = card_info() if self.card else None
        out["compared"] = check.compared(numbers)
        self.numbers = numbers
        return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="on the CPU, at a size a test can hold")
    return p.parse_args(argv)


def main(argv=None, root: Path = ROOT) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload, root)
    device = "cuda"
    if args.rehearse:
        cell, device = shrink(cell, REHEARSAL), "cpu"
    else:
        import torch

        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); "
                  "none is here", file=sys.stderr)
            return 2
    run = Run(cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=device)
    out = run.go(root)
    found = forbidden_modules()
    if found:
        print(f"loaded, and forbidden: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for line in check.lines(run.numbers):
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
