"""``chunked``: one client, request after request, each
``Matcher.match_chunked`` over the whole corpus read as a ring from a
new segment-aligned start."""

from __future__ import annotations

import time

from benchmark import clock as clk
from benchmark.loops import Loop, Request, cut_args, port
from benchmark.reference.ac import rotated

# request k reads the ring from (k * ROTATE) % n: distinct segment-aligned
# starts (1281 is odd, so for any corpus of a power-of-two number of
# segments the first n / 4096 requests all differ)
ROTATE = 1281 * 4096


class Chunked(Loop):
    kind = "chunked"

    @classmethod
    def key(cls, traffic, n, k):
        return (k * ROTATE) % n

    @classmethod
    def reference(cls, ac, config, traffic, corpus):
        """The ring's rows, read round its end and cut, once; a request's
        are them rotated to its start."""
        n = len(corpus)
        ring = ac.find(corpus + corpus[:ac.max_len - 1], starts_before=n,
                       **cut_args(config))
        return lambda shift: rotated(ring, n, shift, ac.max_len)

    def setup(self):
        self.inputs()
        p = port()
        self.chunk = self.traffic["chunk_bytes"]
        self.chunks = -(-self.n // self.chunk)
        self.compiled = self.compile()
        self.matcher = p.Matcher(self.compiled, self.cfg,
                                 device=self.run.device)
        # the warm-up request (shift 0) trains the plan layout on the
        # corpus's head, as the CLI's first chunk does, and builds
        self.uncounted.append(self.request(0))

    def data(self, k: int) -> tuple[bytes, int]:
        shift = self.key(self.traffic, self.n, k)
        return self.corpus[shift:] + self.corpus[:shift], shift

    def request(self, k: int) -> Request:
        """Request ``k``: the corpus read from its shift (the client's
        copy counts in its time), then ``match_chunked`` over all of it."""
        t0 = time.perf_counter()
        data, shift = self.data(k)
        with self.range("request"):
            rows = self.matcher.match_chunked(
                data, input_size=self.n, chunk_bytes=self.chunk)
        return Request(t0, time.perf_counter(), self.n, rows, key=shift)

    def window(self, seconds: float):
        start = time.perf_counter()
        k = 1
        while not self.requests or \
                self.requests[-1].t1 - start < seconds:
            self.requests.append(self.request(k))
            k += 1

    def serial(self):
        """One request more, serially (``max_outstanding=0``), a stage at
        a time under timers that synchronise."""
        k = len(self.requests) + 1
        data, shift = self.data(k)
        timed = clk.TimedCorpus(data)
        clock = timed.clock = clk.StageClock(self.run.card, sync=True)
        with clk.stage_wrappers(clock):
            self.run.sync()
            t0 = time.perf_counter()
            rows = self.matcher.match_chunked(
                timed, input_size=self.n, chunk_bytes=self.chunk,
                max_outstanding=0)
            self.run.sync()
            t1 = time.perf_counter()
        timed.clock = None
        self.uncounted.append(Request(t0, t1, self.n, rows, key=shift))
        self.serial_stages = dict(
            wall_s=t1 - t0, chunks=self.chunks,
            seconds=dict(clock.seconds), calls=dict(clock.calls),
            reached=dict(clock.reached), shards=self.config["num_shards"],
            rows=len(rows), corpus_bytes=self.n)

    def release(self):
        self.matcher = self.compiled = None


LOOP = Chunked
