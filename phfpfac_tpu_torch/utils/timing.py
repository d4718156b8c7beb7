"""Structured phase timing.

The reference prints a phase report with omp_get_wtime /
clock_gettime / cudaEvent timings (main.cc:279-287): PFAC build,
hashtable build, device malloc, match, total.  We reproduce the same
phase taxonomy with a structured report object.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    """Collects named phase durations (seconds)."""

    phases: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        """Render a report mirroring the reference's taxonomy (main.cc:279-287)."""
        lines = ["/////////////////////////////////////////////"]
        order = [
            ("create_pfac", "1.Time for  create PFAC : {:.6f} seconds"),
            ("create_hashtable", "2.Time for  create Hashtable : {:.6f} seconds"),
            ("device_alloc", "3.Time for  device table upload: {:.6f} mseconds"),
            ("match", "4.Time for  match progress: {:.6f} mseconds"),
        ]
        total_ms = 0.0
        for key, fmt in order:
            if key in self.phases:
                val = self.phases[key]
                if "mseconds" in fmt:
                    val *= 1000.0
                    total_ms += val
                lines.append(fmt.format(val))
        lines.append(f"5.Total elapsed time: {total_ms:.6f} mseconds")
        for key, val in self.phases.items():
            if key not in {k for k, _ in order}:
                lines.append(f"   {key}: {val * 1000.0:.6f} ms")
        lines.append("matching process finshed")  # sic — reference main.cc:286
        lines.append("/////////////////////////////////////////////")
        return "\n".join(lines)
