"""``invoke``: one in-process gphf invocation a request, back to back:
compile the pattern file, build the matcher, match one input slice."""

from __future__ import annotations

import contextlib
import time

from benchmark import clock as clk
from benchmark.loops import Loop, Request, cut_args, port
from benchmark.trace import bench_range


class Invoke(Loop):
    kind = "invoke"

    @classmethod
    def key(cls, traffic, n, k):
        return k % (n // traffic["input_bytes"])

    @classmethod
    def reference(cls, ac, config, traffic, corpus):
        """The rows of each slice, found once a slice."""
        size, seen = traffic["input_bytes"], {}

        def want(slot):
            if slot not in seen:
                seen[slot] = ac.find(corpus[slot * size:(slot + 1) * size],
                                     **cut_args(config))
            return seen[slot]
        return want

    def setup(self):
        self.inputs()
        self.size = self.traffic["input_bytes"]
        self.uncounted.append(self.invocation(0))
        self.invocations = []  # the window's alone

    def invocation(self, k: int) -> Request:
        """One gphf run in the process: compile the pattern file, build
        the matcher (trained on the input's head at its first scan, as
        the CLI's is), match the input.  Nothing carries over but the
        built kernel libraries and native helper."""
        p = port()
        slot = self.key(self.traffic, self.n, k)
        data = self.corpus[slot * self.size:(slot + 1) * self.size]
        self.invocations.append(dict(tables_s=0.0))
        t0 = time.perf_counter()
        with self.range("compile"):
            compiled = self.compile()
        t1 = time.perf_counter()
        with self.range("match"):
            m = p.Matcher(compiled, self.cfg, device=self.run.device)
            rows = m.match_chunked(data, input_size=len(data))
        t2 = time.perf_counter()
        self.invocations[-1].update(compile_s=t1 - t0, match_s=t2 - t1)
        return Request(t0, t2, len(data), rows, key=slot)

    def window(self, seconds: float):
        start = time.perf_counter()
        k = 1
        with self.tables_clock():
            while not self.requests or \
                    self.requests[-1].t1 - start < seconds:
                self.requests.append(self.invocation(k))
                k += 1

    @contextlib.contextmanager
    def tables_clock(self):
        """In a traced run, host seconds of each matcher's scanner and
        plan-table build: every call of ``Matcher._get_pallas_scanner``
        (swapped in by name; after its first it returns what it built)."""
        if not self.run.trace_on:
            yield
            return
        M = port().Matcher
        real = M._get_pallas_scanner

        def timed(m, *a, **kw):
            t0 = time.perf_counter()
            with bench_range("tables"):
                out = real(m, *a, **kw)
            self.run.sync()
            self.invocations[-1]["tables_s"] += time.perf_counter() - t0
            return out

        with clk.patched([(M, "_get_pallas_scanner", timed)]):
            yield


LOOP = Invoke
