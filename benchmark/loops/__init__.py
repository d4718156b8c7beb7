"""The closed loops a traffic mix names by its ``loop`` key, one file each
beside this one (``<kind>.py``, found by ``spec.loop``), each with one
client.  A loop's file holds one subclass of ``Loop`` as ``LOOP``.

Each loop builds the program's state in ``setup`` (and warms up the
shapes its traffic uses), runs the measured window in ``window``, times
its stages once more in ``serial`` in a traced run, and names what its
``k``-th request reads (``key``) and what the plain reference says that
request should answer (``reference``, from the configuration's plain
reference, ``spec.reference``): ``answers`` pairs every answer the
program gave with it, and ``control.py`` reads the same rows.  The
program is used only through its public entry points; stage timers are
swapped into its functions by name (``clock``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np

from benchmark import clock as clk
from benchmark.gen import inputs
from benchmark.trace import bench_range


@dataclasses.dataclass
class Request:
    t0: float
    t1: float
    nbytes: int
    rows: np.ndarray  # (position, pattern id), as the program answered
    key: int = 0  # what it read, as the loop's ``key`` names it


def port():
    """The program's public entry points."""
    import phfpfac_tpu_torch as p

    return p


def program_config(config: dict):
    """The program's configuration for a deployment: the CLI's, from
    ``gphf <dict> <streamnum> <width> <input>`` and its cut."""
    return port().PfacConfig(
        width=config["width"], num_shards=config["num_shards"],
        truncation=config["truncation"],
        segment_bytes=config["segment_bytes"],
        halo_bytes=config["halo_bytes"], match_slots=0)


def cut_args(config: dict) -> dict:
    return dict(segment=config["segment_bytes"]
                if config["truncation"] == "segment" else None,
                halo=config["halo_bytes"])


class Loop:
    kind = ""

    def __init__(self, run):
        self.run = run
        self.config = run.cell.config
        self.traffic = run.cell.traffic
        self.requests: list[Request] = []  # the window's, counted
        # checked, not counted: the warm-up, the serial pass
        self.uncounted: list[Request] = []
        self.invocations: list[dict] = []
        self.serial_stages = None

    @classmethod
    def key(cls, traffic: dict, n: int, k: int) -> int:
        """What request ``k`` reads of a corpus of ``n`` bytes."""
        raise NotImplementedError

    @classmethod
    def reference(cls, ac, config: dict, traffic: dict, corpus: bytes):
        """The function ``key -> rows`` the plain reference ``ac`` (built
        from the patterns, ``spec.reference``) answers."""
        raise NotImplementedError

    def range(self, name):
        return bench_range(name) if self.run.trace_on else \
            contextlib.nullcontext()

    def inputs(self):
        run = self.run
        root = run.cell.root
        self.pats, words = inputs.dictionary(self.config, root)
        self.corpus, self.planted = inputs.corpus(
            self.config, self.traffic, self.pats, words, run.seed, root)
        self.n = len(self.corpus)
        self.escapes = inputs.escaped(self.config)
        self.pat_file = inputs.pattern_file(
            self.pats, os.path.join(run.tmp, "patterns.txt"), self.escapes)
        self.cfg = program_config(self.config)

    def compile(self):
        """The program's compile of the pattern file, as the CLI reads it
        (with ``--escapes`` where the configuration's file has them)."""
        return port().compile_dictionary(self.pat_file, self.cfg,
                                         escapes=self.escapes)

    def serial(self):
        pass

    def summary(self) -> dict:
        """What the window did, for the run's log: the seconds of its
        requests, as ``stats`` gives them, and each request's."""
        secs = [r.t1 - r.t0 for r in self.requests]
        out = clk.stats(secs)
        out["seconds"] = [round(s, 4) for s in secs]
        out["rows"] = [len(r.rows) for r in self.requests[:3]]
        if self.invocations:
            out["invocations"] = [{k: round(v, 4) for k, v in i.items()}
                                  for i in self.invocations]
        return out

    def release(self):
        """Drop the program's state (before the reference runs)."""

    def answers(self, ac):
        """(parts, want, counted) of every answer the run gave."""
        want = self.reference(ac, self.config, self.traffic, self.corpus)
        for r, counted in [(r, False) for r in self.uncounted] + \
                [(r, True) for r in self.requests]:
            yield r.rows, want(r.key), counted
