"""End-to-end attribution of the PyTorch/CUDA port: where the time of
the CLI, the match phase, the stream and a cold start goes.  The port's
counterpart of ``bench/e2e.py``, ``bench/dense_diag.py``,
``bench/serve_stream.py`` and ``bench/coldstart.py``.

Run on a machine with a CUDA GPU, from the repository root:

    python3 chip_e2e.py [--arm e2e|stages|stream|coldstart|compact|
                               kernels|all]
                        [--dict ascii50k|clamav5k|both|english|big|full|
                                random|words] [--mib N]
                        [--reps 5] [--seed 0] [--patterns N]
                        [--device cuda|cpu]

The deployments come from ``chip_smoke.py``'s seeded generators, with
streamnum 1 (4 shards), width 4096 and the CLI's 4 KiB segment + 512 B
halo cut: ascii50k (50,003 printable patterns over text) and clamav5k
(5,000 byte signatures, ``--escapes``, over random bytes), 64 MiB each
(``--mib``) with 100,000 plants per 64 MiB.  ``--patterns`` scales the
dictionaries down (the CPU tests).

``--dict words`` runs ``bench.py``'s word-dictionary regimes instead, as
``bench.py`` and ``bench/e2e.py`` compile them: one shard, width 4096,
exact mode (``word_config``).  english: 7,977 English-like words over
128 MiB of text over the same words; big and full: 156,000 and 466,543
titles (``chip_smoke.py::make_titles``, 3 of them of 33-64 B) over
32 MiB of that text; random: english over 32 MiB of random bytes; each
with ``DENSITY`` plants.  Each prints its patterns, states, plan-table
bytes, route per shard, host build seconds and its calibration against
``bench.py``'s counts (``WORD_COUNTS``).  Their arms (``WORD_ARMS``):
``e2e`` (K1's count total equal to the rows, K1 alone, ``match``,
``match_chunked`` uploaded per chunk and device-resident, ``WORD_REPS``
timed runs; then the CLI as a process at streamnum 1, 4 shards under its
default cut, on the first ``CLI_CUT`` bytes where set, its file
byte-identical to the one-shard rows rendered), ``stages``, ``stream``
(big: 1 MiB feeds, exact mode), ``compact`` (K1' + K6 at the cut and cap
``resolve_compact`` gives with the opt-in, the survivors, overflows and
rescans; ``match_chunked`` and chained count scans both ways) and
``kernels`` (K1, K1' and K6 bit for bit against their plain versions on
the first 16 MiB window, K1's times, launches, bytes and gather bounds).
A word regime's rows are the one-shard matcher's, held to the oracle
windows and the plants; each of its lines carries its ``calibration``,
and a size cut forced by the time limit its ``reduced`` list.

Arms, each per deployment:

* ``e2e``: K1 alone in count mode over the staged corpus (chained
  ``PlanCountScan``), ``Matcher.match``, ``match_chunked`` uploading
  each 16 MiB chunk, and ``match_chunked`` over a corpus staged once,
  with GB/s; then the CLI's wall taken apart: ``python3 -m
  phfpfac_tpu_torch.cli`` in a subprocess and, in turns with it, a
  fresh process that calls what ``cli.main`` calls in its order, each
  step timed (import, compile, read, CUDA init, scanner and plan-table
  build, kernel-library load, match, render, write, exit), with the
  part of the CLI's wall left unaccounted.
* ``stages``: ``match_chunked`` once serially (``max_outstanding=0``)
  under timers that synchronise, swapped in for the functions it reaches
  (``STAGES``), seconds a chunk and share of the serial wall per stage;
  the pipelined wall (``max_outstanding=3``) and a ``torch.profiler``
  trace of it: device seconds by kernel name and by stage, idle share;
  a pinned-memory upload of one window as a yardstick.
* ``stream``: ``StreamMatcher.feed_async`` with ``DEPTH`` resolvers
  outstanding, seconds a feed, over 1 GiB (``--mib``, default 1,024)
  of clamav5k's traffic at 1 MiB and 16 MiB feeds, and
  ``match_chunked(device_data=)`` over the same GiB staged once; for
  ascii50k a quarter of that size of text in exact mode at 1 MiB feeds.
* ``coldstart``: the dictionary saved with the plan tables its scan
  built (``--save-tables``, format v3), then a fresh interpreter running
  this script with a private flag: import, ``CompiledDictionary.load``,
  CUDA init, kernel-library load, scanner build and the first 8 MiB
  result, which must equal the one before the save.

Every result is held to the CLI's own ``GPU_match_result.txt`` rows on
the same files (the stream: to ``match_chunked`` over the same bytes),
and those rows to ``oracle/ac.py`` on a 64 KiB window around every
16 MiB chunk boundary and the end, and to the planted patterns.

Output: the first line names the device (``torch.cuda.get_device_name``,
the count, ``nvidia-smi``'s name and power limit); one JSON line per arm
and deployment; the last line a summary with every arm's numbers and
``"ok"``.  A timing is ``{"n", "median", "q1", "q3"}`` in seconds, with
``"tail_pct"``/``"tail"`` (the highest whole percentile with at least
ten samples beyond it) from 100 samples on, each after a warm-up.  An
arm that fails prints its error in its line; the next arm runs; the exit
code is then 1.  Without a CUDA device (and without ``--device cpu``)
the script exits 1 at once.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # a cold-start child's clock starts here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402

KIB, MIB = 1 << 10, 1 << 20
CHUNK = cs.CHUNK  # match_chunked's window, the CLI's
FEEDS = (MIB, 16 * MIB)  # the host-fed stream's feed sizes
DEPTH = 3  # stream resolvers outstanding
WINDOW = 64 * KIB  # the oracle's window around each chunk boundary
FIRST = 8 * MIB  # a cold start's first result
CHAIN_K = cs.CHAIN_K  # chained count scans a sample
DENSITY = cs.PLANTS / (64 * MIB)  # plants a byte, chip_smoke.py's
PRINTABLE = np.arange(32, 127, dtype=np.uint8)
ARMS = ("e2e", "stages", "stream", "coldstart")
DICTS = ("ascii50k", "clamav5k")  # --dict both
WORDS = ("english", "big", "full", "random")  # --dict words
WORD_ONLY_ARMS = ("compact", "kernels")  # arms of the word regimes alone
# the word regimes as bench.py runs them: corpus MiB, and BENCH_r05.json's
# counts (patterns, states of the one shard, count-mode matches, bytes)
WORD_MIB = dict(english=128, big=32, full=32, random=32)
WORD_COUNTS = dict(english=(7_977, 23_951, 56_424_576, 128 * MIB),
                   big=(156_000, 456_902, 11_351_872, 32 * MIB),
                   full=(466_543, 1_420_614, 32_135_296, 32 * MIB),
                   random=(7_977, 23_951, 147_017, 32 * MIB))
STATE_TOLERANCE, DENSITY_FACTOR = 0.25, 1.5  # calibration, where aimed at
CLI_CUT = dict(full=16 * MIB)  # the CLI process runs on the first 16 MiB
WORD_ARMS = dict(english=("e2e", "stages", "compact", "kernels"),
                 big=("e2e", "stages", "stream", "compact", "kernels"),
                 full=("e2e", "stages", "compact", "kernels"),
                 random=("e2e", "stages", "compact"))
# the match phase's stages, in match_chunked's order a chunk
STAGES = ("window", "upload", "stage", "k1", "verify", "fetch", "decode",
          "host_tail", "merge")
# the CLI's steps (cli.py), in its order, timed in a process of their own
CLI_STEPS = ("import", "compile", "read", "cuda_init", "tables",
             "library_load", "match", "render", "write")


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


def med(st: dict):
    return st["median"]


def gb_per_s(n: int, st: dict):
    return n / st["median"] / 1e9 if st["median"] else None


def fail(what: str) -> None:
    """A failed check ends the arm (not ``assert``: it must survive -O)."""
    raise RuntimeError(f"chip_e2e check failed: {what}")


class Run:
    """One invocation: the device, the options, the deployments built so
    far, the directory the inputs are written to and what the script's
    own kernel build took."""

    def __init__(self, device, *, reps=5, mib=None, seed=0, patterns=None,
                 tmp=None):
        self.device = torch.device(device)
        self.card = self.device.type == "cuda"
        self.reps, self.mib, self.seed = reps, mib, seed
        self.patterns, self.tmp = patterns, tmp
        self.deployments = {}
        self.build = None

    def sync(self) -> None:
        if self.card:
            torch.cuda.synchronize()

    def seconds(self, fn) -> float:
        """Host-clock seconds of ``fn`` up to the end of its device work."""
        self.sync()
        t0 = time.perf_counter()
        fn()
        self.sync()
        return time.perf_counter() - t0

    def samples(self, fn, reps=None) -> list:
        """A warm-up call of ``fn``, then ``reps`` timed ones."""
        fn()
        return [self.seconds(fn) for _ in range(reps or self.reps)]

    def size(self, arm: str, name: str = "ascii50k") -> int:
        mib = self.mib
        if mib is None:
            mib = (WORD_MIB[name] if name in WORDS
                   else 1024 if arm == "stream" else 64)
        return int(mib * MIB)

    def deployment(self, name: str) -> "Deployment":
        if name not in self.deployments:
            self.deployments[name] = build_deployment(self, name)
        return self.deployments[name]

    def describe(self) -> dict:
        if not self.card:
            return dict(name="cpu", count=0, nvidia_smi=None,
                        torch=torch.__version__)
        return dict(name=torch.cuda.get_device_name(0),
                    count=torch.cuda.device_count(),
                    nvidia_smi=cs.nvidia_smi(), torch=torch.__version__,
                    cuda=torch.version.cuda)


# ---- deployments ------------------------------------------------------------

@dataclasses.dataclass
class Deployment:
    """A dictionary and its corpus, compiled and with its scanners built,
    and the answers every arm is held to."""

    name: str
    pats: list
    plen: np.ndarray  # pattern length by id (ids from 1)
    corpus: bytes
    planted: list
    files: tuple  # (pattern file, input file) as the CLI reads them
    escapes: bool  # patterns written as \xNN escapes (``--escapes``)
    cfg: object
    compiled: object
    matcher: object
    cli_rows: np.ndarray | None = None
    verified: bool = False  # cli_rows held to the oracle and the plants
    build: dict | None = None  # a word regime's host build, described
    check_seconds: dict = dataclasses.field(default_factory=dict)

    @property
    def flags(self) -> list:
        return ["--escapes"] if self.escapes else []


def cli_config(cls=None):
    """The CLI's config at streamnum 1, width 4096 and its default cut."""
    if cls is None:
        from phfpfac_tpu_torch.utils.config import PfacConfig as cls
    return cls(width=4096, num_shards=4, truncation="segment",
               match_slots=0)


def word_config(cls=None):
    """``bench.py``'s word regimes: one shard, width 4096, exact mode."""
    if cls is None:
        from phfpfac_tpu_torch.utils.config import PfacConfig as cls
    return cls(width=4096, num_shards=1, truncation="none", match_slots=0)


def generate(name: str, seed: int, size: int, patterns=None):
    """(patterns, corpus, planted (pos, id) pairs, CLI escapes) of a
    deployment, from ``chip_smoke.py``'s generators: ascii50k's stems
    over printable text, clamav5k's signatures over random bytes, or a
    word regime (english's words over their text, big's and full's
    titles over english's text, random: english over random bytes),
    ``DENSITY`` plants a byte."""
    rng = np.random.default_rng([seed, (*DICTS, *WORDS).index(name)])
    plants = max(1, round(size * DENSITY))
    if name in WORDS:
        words = cs.make_english_words(
            rng, patterns if patterns and name in ("english", "random")
            else WORD_COUNTS["english"][0])
        pats = (words if name in ("english", "random") else
                cs.make_titles(rng, patterns or WORD_COUNTS[name][0]))
        text = (None if name == "random"
                else cs.make_english_text(rng, words, size))
        corpus, planted = cs.make_corpus(rng, pats, size, plants=plants,
                                         base=text)
        return pats, corpus, planted, False
    if name == "ascii50k":
        pats = (cs.make_ascii50k(rng) if patterns is None else
                cs.make_stem_patterns(rng, PRINTABLE, count=patterns,
                                      n_long=3))
        corpus, planted = cs.make_corpus(rng, pats, size, PRINTABLE,
                                         plants=plants)
        return pats, corpus, planted, False
    pats = cs.make_signatures(5000 if patterns is None else patterns, seed=7)
    corpus, planted = cs.make_corpus(rng, pats, size, plants=plants)
    return pats, corpus, planted, True


def pattern_lengths(pats) -> np.ndarray:
    return np.asarray([0] + [len(p) for p in pats], np.int64)


def build_deployment(run: Run, name: str) -> Deployment:
    from phfpfac_tpu_torch.compile.tables import compile_dictionary
    from phfpfac_tpu_torch.parallel.matcher import Matcher

    t0 = time.perf_counter()
    pats, corpus, planted, escapes = generate(
        name, run.seed, run.size("e2e", name), run.patterns)
    files = cs.write_inputs(run.tmp, name, pats, corpus, escapes)
    cfg = word_config() if name in WORDS else cli_config()
    t1 = time.perf_counter()
    compiled = compile_dictionary(files[0], cfg, escapes=escapes)
    t2 = time.perf_counter()
    # the CLI trains the plan layout on the first chunk's head
    m = Matcher(compiled, cfg, device=run.device, train=train_of(corpus))
    m._get_pallas_scanner()
    run.sync()
    t3 = time.perf_counter()
    d = Deployment(name=name, pats=pats, plen=pattern_lengths(pats),
                   corpus=corpus, planted=planted, files=files,
                   escapes=escapes, cfg=cfg, compiled=compiled, matcher=m)
    if name in WORDS:
        d.build = describe_words(d, generate_seconds=t1 - t0,
                                 compile_seconds=t2 - t1,
                                 tables_seconds=t3 - t2)
    return d


def routes(m) -> list:
    """The route each shard of matcher ``m`` takes: plan, pair or depth
    (its bitmap kernel), split/<the short part's> (the long patterns to
    the host or the turbo engine), turbo (no kernel for the shard); or
    multi / turbo for the whole dictionary."""
    from phfpfac_tpu_torch.ops.depth import DepthShardScanner
    from phfpfac_tpu_torch.ops.pair import PairShardScanner
    from phfpfac_tpu_torch.ops.plan import PlanShardScanner

    def kind(e):
        for cls, k in ((PlanShardScanner, "plan"), (PairShardScanner, "pair"),
                       (DepthShardScanner, "depth")):
            if isinstance(e, cls):
                return k
        return type(e).__name__

    how, entries = m._get_pallas_scanner()
    if how != "depth":
        return [how] * len(m.compiled.shards)
    return ["turbo" if e is None else
            f"split/{kind(e[1][1])}" if isinstance(e, tuple) else kind(e)
            for e in entries]


def describe_words(d: Deployment, **seconds) -> dict:
    """A word regime's dictionary and tables, its host build split, and
    its calibration against ``bench.py``'s counts on the TPU record
    (``WORD_COUNTS``: states within ``STATE_TOLERANCE``, matches a byte
    within a factor ``DENSITY_FACTOR``; the matches once counted)."""
    sh = d.compiled.shards[0]
    planned = plan_entries(d, strict=False)
    pts = [e.pt for _s, e in planned]
    want_pats, want_states, want_matches, want_bytes = WORD_COUNTS[d.name]
    return dict(patterns=len(d.pats), long_patterns=int(
                    sum(len(p) > 32 for p in d.pats)),
                states=int(sh.state_num), finals=int(sh.final_state_num),
                max_pat_len=int(sh.max_pat_len), routes=routes(d.matcher),
                plan_table_bytes=sum(cs.table_bytes(e.tables)
                                     for _s, e in planned),
                plan_host_bytes=sum(int(v.nbytes) for pt in pts
                                    for v in vars(pt).values()
                                    if isinstance(v, np.ndarray)),
                plan_steps=[len(pt.steps) for pt in pts],
                code_bits=[int(pt.code_bits) for pt in pts],
                corpus_bytes=len(d.corpus), planted=len(d.planted),
                target=dict(patterns=want_pats, states=want_states,
                            matches_per_byte=want_matches / want_bytes),
                states_vs_target=sh.state_num / want_states - 1,
                **{k: float(v) for k, v in seconds.items()})


def train_of(data: bytes):
    """What ``Matcher._dispatch`` trains the plan layout on when it scans
    ``data`` first."""
    return bytes(data[:MIB]) if len(data) >= 4096 else None


def with_tables(d: Deployment):
    """The compiled dictionary with the plan tables its scan built, as
    the CLI's ``--save-tables`` writes it after a scan."""
    return dataclasses.replace(d.compiled,
                               plan_tables=d.matcher.built_plan_tables())


# ---- the answers ------------------------------------------------------------

def rows(a) -> np.ndarray:
    return np.asarray(a, np.int64).reshape(-1, 2)


def sorted_rows(a) -> np.ndarray:
    a = rows(a)
    return a[np.lexsort((a[:, 1], a[:, 0]))]


def within(got, plen, lo: int, hi: int, by_pos: bool = False) -> np.ndarray:
    """The rows that start at or after ``lo`` and end by ``hi``, shifted
    by ``-lo``: the oracle over ``data[lo:hi]`` where ``lo`` sits on a
    segment boundary (walks are position-local).  ``by_pos``: the rows
    are in position order (a result's), so the span is cut by search."""
    got = rows(got)
    if by_pos:
        got = got[np.searchsorted(got[:, 0], lo):
                  np.searchsorted(got[:, 0], hi)]
    p = got[:, 0]
    out = got[(p >= lo) & (p + plen[got[:, 1]] <= hi)].copy()
    out[:, 0] -= lo
    return out


def oracle_spans(pats, plen, data: bytes, cfg, spans) -> list:
    """``oracle/ac.py`` over each byte span ``[lo, hi)`` of ``data``
    (``lo`` on a segment boundary), in one call: the spans laid end to
    end, each from a segment boundary of the joined bytes, and each
    span's rows taken back with ``within`` (walks are position-local, so
    a span's rows do not depend on its neighbours)."""
    from phfpfac_tpu_torch.frontend.patterns import Pattern
    from phfpfac_tpu_torch.oracle.ac import match_oracle

    seg = cfg.segment_bytes if cfg.truncation == "segment" else 1
    parts, offs, at = [], [], 0
    for lo, hi in spans:
        offs.append(at)
        room = -(-(hi - lo) // seg) * seg
        parts += [data[lo:hi], bytes(room - (hi - lo))]
        at += room
    got = match_oracle([Pattern(i + 1, p) for i, p in enumerate(pats)],
                       b"".join(parts), cfg)
    return [within(got, plen, off, off + hi - lo)
            for off, (lo, hi) in zip(offs, spans)]


def found(got, want) -> np.ndarray:
    """Which (pos, id) rows of ``want`` are rows of ``got`` (in position
    order): each position's rows found by search, then compared a rank
    at a time (a position holds a few)."""
    p = got[:, 0]
    lo = np.searchsorted(p, want[:, 0], side="left")
    hi = np.searchsorted(p, want[:, 0], side="right")
    out = np.zeros(len(want), bool)
    for k in range(int((hi - lo).max(initial=0))):
        at = lo + k
        ok = at < hi
        out[ok] |= got[at[ok], 1] == want[ok, 1]
    return out


def hold_to_oracle(got, pats, plen, data: bytes, n: int, cfg, planted,
                   what: str, seconds: dict | None = None) -> int:
    """``got`` against ``oracle/ac.py`` on ``WINDOW`` bytes around every
    ``CHUNK`` boundary and the end, and against the plants; -> windows
    checked.  ``seconds`` gets the oracle's and the plants' times."""
    seconds = {} if seconds is None else seconds
    t0 = time.perf_counter()
    got = rows(got)
    seg = cfg.segment_bytes if cfg.truncation == "segment" else 1
    spans = []
    for b in list(range(CHUNK, n, CHUNK)) + [n]:
        lo = max(b - WINDOW // 2, 0) // seg * seg
        spans.append((lo, min(lo + WINDOW, n)))
    wants = oracle_spans(pats, plen, data, cfg, spans)
    seconds["oracle"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not (got[1:, 0] >= got[:-1, 0]).all():  # a result is in pos order
        got = got[np.argsort(got[:, 0], kind="stable")]
    for (lo, hi), want in zip(spans, wants):
        if not np.array_equal(within(got, plen, lo, hi, by_pos=True), want):
            fail(f"{what}: the oracle differs on [{lo}, {hi})")
    seconds["windows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lost = ~found(got, np.asarray(planted, np.int64).reshape(-1, 2))
    want = np.asarray(planted, np.int64).reshape(-1, 2)
    seconds["plants"] = time.perf_counter() - t0
    if lost.any():
        fail(f"{what}: {int(lost.sum())} planted matches missing, "
             f"first {want[lost][:3].tolist()}")
    return len(spans)


def cli_rows(run: Run, d: Deployment) -> np.ndarray:
    """The rows of the CLI's ``GPU_match_result.txt`` on the deployment's
    files (run in-process unless the e2e arm's subprocess wrote it),
    held once to the oracle windows and the plants."""
    if d.cli_rows is None and d.name in WORDS:
        # a word regime's answer: the one-shard matcher's, which the
        # CLI's file (4 shards) must equal byte for byte (``cli_file``)
        t0 = time.perf_counter()
        d.cli_rows = rows(d.matcher.match_chunked(
            d.corpus, input_size=len(d.corpus), chunk_bytes=CHUNK))
        d.check_seconds["first_match"] = time.perf_counter() - t0
    if d.cli_rows is None:
        from phfpfac_tpu_torch import cli

        out = os.path.join(run.tmp, f"{d.name}.cli.out")
        if cli.main([d.files[0], "1", "4096", d.files[1], "-o", out,
                     "--quiet", *d.flags, "--device", run.device.type]):
            fail(f"{d.name}: the CLI exited non-zero")
        d.cli_rows = cs.read_output(out)
    if not d.verified:
        hold_to_oracle(d.cli_rows, d.pats, d.plen, d.corpus, len(d.corpus),
                       d.cfg, d.planted, f"{d.name}: the CLI's file",
                       d.check_seconds)
        d.verified = True
    return d.cli_rows


def hold(run: Run, d: Deployment, got, what: str) -> None:
    """``got``, a result over the whole corpus, equal to the CLI's rows."""
    want = cli_rows(run, d)
    if not np.array_equal(rows(got), want):
        fail(f"{d.name} {what}: {len(rows(got))} rows != the CLI's "
             f"{len(want)}")


# ---- arm e2e ----------------------------------------------------------------

def plan_entries(d: Deployment, strict: bool = True):
    """(shard, PlanShardScanner) per shard of the main path; a split
    shard's is its short part's.  A shard on another route fails the
    arm (``strict``) or is left out."""
    from phfpfac_tpu_torch.ops.plan import PlanShardScanner

    out = []
    for shard, e in zip(d.compiled.shards, d.matcher._get_scanners()):
        if isinstance(e, tuple):
            shard, e = e[1][0], e[1][1]
        if not isinstance(e, PlanShardScanner):
            if strict:
                fail(f"{d.name}: a shard's scanner is {type(e).__name__}, "
                     "not K1")
            continue
        out.append((shard, e))
    return out


def scan_alone(run: Run, d: Deployment) -> dict:
    """K1 in count mode over the corpus staged once per shard (exact
    mode, ``PlanCountScan``), ``CHAIN_K`` chained scans a sample: seconds
    a scan of the corpus by ``cuda_ms`` and by the profiler's device
    time (on the CPU: the host clock)."""
    from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
    from phfpfac_tpu_torch.ops.plan import PlanCountScan

    n = len(d.corpus)
    max_steps = padded_steps(d.compiled.max_pat_len)
    padded = pad_input(d.corpus, 1024, max_steps)
    scans = []
    for shard, sc in plan_entries(d):
        c = PlanCountScan(shard, max_steps, device=run.device, pt=sc.pt)
        scans.append((c, c.prepare(padded, n)))

    def chain():
        return [c.scan_chain(st, n, 0, CHAIN_K) for c, st in scans]

    out = dict(shards=len(scans), chained=CHAIN_K)
    if run.card:
        out["cuda"] = stats([cs.cuda_ms(chain, reps=1) / CHAIN_K / 1e3
                             for _ in range(run.reps)])
        dev = [cs.device_ms(chain, "plan_scan", reps=1)
               for _ in range(run.reps)]
        out["device"] = stats([None if x is None else x / CHAIN_K / 1e3
                               for x in dev])
        out["gb_per_s"] = gb_per_s(n, out["cuda"])
        out["device_gb_per_s"] = (gb_per_s(n, out["device"])
                                  if out["device"]["n"] else None)
    else:
        out["host"] = stats([s / CHAIN_K for s in run.samples(chain)])
        out["gb_per_s"] = gb_per_s(n, out["host"])
    del scans
    return out


def run_child(cmd) -> tuple:
    """(wall seconds, last stdout line, stderr) of a fresh process; one
    that fails raises with the end of its standard error."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if r.returncode:
        fail(f"{cmd[1:3]} exited {r.returncode}: {r.stderr[-2000:]}")
    return wall, (r.stdout.strip().splitlines() or [""])[-1], r.stderr


def package_import_seconds(stderr: str):
    """The import of the package (torch inside it) in a process run with
    ``python3 -X importtime``: its top-level line's cumulative time."""
    for line in stderr.splitlines():
        f = line.split("|")
        if len(f) == 3 and f[2].rstrip() == " phfpfac_tpu_torch":
            return int(f[1]) / 1e6
    return None


def child(kind: str, spec: dict) -> list:
    """This script in a fresh interpreter, running ``kind``'s timed
    steps (``--child``)."""
    return [sys.executable, os.path.abspath(__file__), "--child",
            json.dumps(dict(spec, kind=kind))]


def split_child(spec: dict) -> dict:
    """The CLI's steps in a fresh process, in ``cli.main``'s order, each
    timed from the interpreter's first line (``CLI_STEPS``); CUDA init
    (the first tensor on the card) and the K1 library's load, which the
    CLI pays inside the table build and the first launch, on their own.
    Writes the result file."""
    from phfpfac_tpu_torch import _build, cli

    t = {"import": time.perf_counter() - T0}
    device = torch.device(spec["device"])
    card = device.type == "cuda"

    def lap(step, t0):
        if card and torch.cuda.is_initialized():  # a sync would start CUDA
            torch.cuda.synchronize()
        t[step] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    cfg = cli_config()
    compiled = cli.compile_dictionary(spec["patterns"], cfg,
                                      escapes=spec["escapes"])
    t0 = lap("compile", t0)
    with open(spec["input"], "rb") as f:
        data = f.read()
    n = max(len(data) - 1, 0)  # the CLI drops the last byte
    t0 = lap("read", t0)
    if card:
        torch.zeros(1, device=device)
        t0 = lap("cuda_init", t0)
    m = cli.Matcher(compiled, cfg, device=device)
    m._train = train_of(data)
    m._get_pallas_scanner()
    t0 = lap("tables", t0)
    if card:
        _build.load("plan_scan")
        t0 = lap("library_load", t0)
    got = m.match_chunked(data, input_size=n)
    t0 = lap("match", t0)
    text = cli.render_result_file(got)
    t0 = lap("render", t0)
    with open(spec["output"], "w") as f:
        f.write(text)
    lap("write", t0)
    return dict(seconds=t)


def cli_split(run: Run, d: Deployment) -> dict:
    """The CLI's wall taken apart: ``python3 -m phfpfac_tpu_torch.cli``
    in a subprocess (``-X importtime`` gives its import), and in turns
    with it a fresh process that calls what ``cli.main`` calls, in its
    order, each step timed (``split_child``); the split (with the fresh
    process's exit) against the subprocess's wall less interpreter start
    (``python3 -c pass``) and its own import, pair by pair."""
    pat_file, in_file = d.files
    sub_out = os.path.join(run.tmp, f"{d.name}.sub.out")
    cli_cmd = [sys.executable, "-X", "importtime", "-m",
               "phfpfac_tpu_torch.cli", pat_file, "1", "4096", in_file,
               "-o", sub_out, "--quiet", *d.flags, "--device",
               run.device.type]
    spec = dict(patterns=pat_file, input=in_file, escapes=d.escapes,
                device=run.device.type,
                output=os.path.join(run.tmp, f"{d.name}.split.out"))
    run_child(cli_cmd)  # the warm-up
    start = run.samples(lambda: run_child([sys.executable, "-c", "pass"]))
    walls, imports, inner, kids = [], [], [], []
    for _ in range(run.reps):
        wall, _line, err = run_child(cli_cmd)
        walls.append(wall)
        imports.append(package_import_seconds(err))
        wall, line, _err = run_child(child("split", spec))
        inner.append(wall)
        kids.append(json.loads(line))
        with open(sub_out) as f, open(spec["output"]) as g:
            if f.read() != g.read():
                fail(f"{d.name}: the split's result file != the CLI's")
    sub_rows = cs.read_output(sub_out)
    if d.cli_rows is None:
        d.cli_rows = sub_rows
    hold(run, d, sub_rows, "the CLI subprocess")  # and the oracle, plants
    interp = med(stats(start))
    for c, w in zip(kids, inner):
        c["seconds"]["exit"] = w - c["inside"] - interp
    split = {k: stats([c["seconds"].get(k) for c in kids])
             for k in (*CLI_STEPS, "exit")}
    # pair by pair (a CLI run, then a split run): a process's import
    # varies by tenths of a second, so each CLI wall loses its own
    account = [w - i - interp for w, i in zip(walls, imports)]
    parts = [sum(v for k, v in c["seconds"].items() if k != "import")
             for c in kids]
    rest = [a - p for a, p in zip(account, parts)]
    out = dict(subprocess_wall=stats(walls),
               subprocess_import=stats(imports), interpreter=stats(start),
               split=split, split_wall=stats(inner),
               accounted_wall=stats(account), split_total=stats(parts),
               unaccounted=stats(rest),
               unaccounted_share=med(stats(rest)) / med(stats(account)),
               samples=dict(subprocess_wall=walls, subprocess_import=imports,
                            split_wall=inner, unaccounted=rest))
    out.update(tables_share_of_wall=(med(split["tables"])
                                     / med(out["subprocess_wall"])),
               import_share_of_wall=(med(out["subprocess_import"])
                                     / med(out["subprocess_wall"])),
               byte_identical=True)
    return out


def arm_e2e(run: Run, d: Deployment) -> dict:
    m, corpus, n = d.matcher, d.corpus, len(d.corpus)
    out = dict(corpus_bytes=n, chunk_bytes=CHUNK)
    out["scan"] = scan_alone(run, d)
    staged = m.stage_for_chunked(corpus, chunk_bytes=CHUNK)
    kw = dict(input_size=n, chunk_bytes=CHUNK)
    res = {}
    for label, fn in (
            ("match", lambda: m.match(corpus, input_size=n)),
            ("chunked", lambda: m.match_chunked(corpus, **kw)),
            ("device_chunked",
             lambda: m.match_chunked(corpus, device_data=staged, **kw))):
        st = stats(run.samples(lambda: res.__setitem__(label, fn())))
        hold(run, d, res[label], f"e2e {label}")
        out[label] = dict(seconds=st, gb_per_s=gb_per_s(n, st))
    del staged
    scan = out["scan"].get("cuda") or out["scan"]["host"]
    out["device_chunked_over_scan"] = (med(scan)
                                       / med(out["device_chunked"]["seconds"]))
    out["cli"] = cli_split(run, d)
    return out


# ---- arm stages -------------------------------------------------------------

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
    """What the stage wrappers record: seconds, calls and CUDA-event pairs
    by stage, calls by wrapped name.  ``sync``: each stage is bracketed
    by synchronisations (the serial run); otherwise it is only marked by
    a ``record_function`` range (the traced run)."""

    def __init__(self, card: bool, sync: bool):
        self.card, self.sync = card, sync
        self.seconds = dict.fromkeys(STAGES, 0.0)
        self.calls = dict.fromkeys(STAGES, 0)
        self.reached = {}
        self.events = []
        self.depth = 0  # > 0 inside a stage: nested calls are its own
        self.window_t0 = None

    def barrier(self) -> None:
        if self.sync and self.card:
            torch.cuda.synchronize()

    def wrap(self, stage: str, name: str, fn, events: bool = False):
        def timed(*a, **kw):
            self.reached[name] = self.reached.get(name, 0) + 1
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            try:
                self.barrier()
                t0 = time.perf_counter()
                ev = None
                if events and self.sync and self.card:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                with torch.profiler.record_function(f"stage:{stage}"):
                    r = fn(*a, **kw)
                if ev is not None:
                    ev[1].record()
                    self.events.append(ev)
                self.barrier()
                self.seconds[stage] += time.perf_counter() - t0
                self.calls[stage] += 1
                return r
            finally:
                self.depth -= 1
        return timed

    def event_seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


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
         w("k1", "plan_scan", plan_mod.plan_scan, events=True)),
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


WRAPPED = ("window", "_dispatch", "pad_input", "to_device_bytes", "stage",
           "plan_scan", "scan_async", "verify", "fetch_hit_bits",
           "decode_hits", "_host_literal_one", "merge_flat_matches")


def trace_by_stage(mt, by_name: dict) -> dict:
    """Device seconds of the kernels launched inside each stage's
    ``record_function`` range of a trace.  K1 launches through ctypes,
    outside any torch op, and the profiler links its kernel to no range:
    its seconds are the trace's by kernel name.  The program's own
    ``stage:`` spans (``utils/profile.py``) lie inside these ranges and
    are left out, so that no kernel counts twice."""
    out = dict.fromkeys(STAGES, 0.0)
    for e in mt.prof.events():
        if e.name.startswith("stage:") and e.name[6:] in out and \
                e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name[6:]] += e.device_time_total / 1e6
    if not out["k1"]:
        out["k1"] = sum(v for k, v in by_name.items() if "plan_scan" in k)
    return out


def pinned_yardstick(run: Run, d: Deployment) -> dict:
    """One padded window uploaded from pageable and from pinned host
    memory (``Tensor.pin_memory``, here only): the upload's yardstick."""
    from phfpfac_tpu_torch.ops.common import pad_input, padded_steps

    chunk, overlap, _wpad = d.matcher._chunk_geometry(CHUNK)
    host = torch.from_numpy(pad_input(d.corpus[:chunk + overlap], 1024,
                                      padded_steps(d.compiled.max_pat_len)))
    pinned = host.pin_memory()
    pageable = stats(run.samples(lambda: host.to(run.device)))
    pin = stats(run.samples(
        lambda: pinned.to(run.device, non_blocking=True)))
    return dict(bytes=int(host.numel()), pageable=pageable, pinned=pin,
                pageable_gb_per_s=gb_per_s(host.numel(), pageable),
                pinned_gb_per_s=gb_per_s(host.numel(), pin))


def stages(run: Run, d: Deployment, reps=None) -> dict:
    """``match_chunked`` a stage at a time (``STAGES``), serially, under
    the wrappers; beside it the unwrapped serial and pipelined walls and
    a trace of the pipelined run."""
    from phfpfac_tpu_torch.utils.profile import trace

    reps = reps or run.reps
    m, corpus, n = d.matcher, d.corpus, len(d.corpus)
    chunk = m._chunk_geometry(CHUNK)[0]
    chunks = -(-n // chunk)

    def chunked(**kw):
        return m.match_chunked(corpus, input_size=n, chunk_bytes=CHUNK, **kw)

    plain = {}
    serial = stats(run.samples(
        lambda: plain.__setitem__("rows", chunked(max_outstanding=0)), reps))
    hold(run, d, plain["rows"], "stages, serial")
    pipelined = stats(run.samples(chunked, reps))

    timed = TimedCorpus(corpus)
    walls, per, k1_dev, reached = [], {k: [] for k in STAGES}, [], {}
    calls = None
    for i in range(reps + 1):  # the first is the warm-up
        clock = timed.clock = StageClock(run.card, sync=True)
        got = []
        with stage_wrappers(clock):
            wall = run.seconds(lambda: got.append(m.match_chunked(
                timed, input_size=n, chunk_bytes=CHUNK, max_outstanding=0)))
        if not np.array_equal(got[0], plain["rows"]):
            fail(f"{d.name}: the wrapped serial run's rows != the "
                 "unwrapped run's")
        for k, v in clock.reached.items():
            reached[k] = reached.get(k, 0) + v
        if not i:
            continue
        walls.append(wall)
        for k in STAGES:
            per[k].append(clock.seconds[k])
        if run.card:
            k1_dev.append(clock.event_seconds())
        calls = clock.calls
    wall_st = stats(walls)
    rest = [w - sum(per[k][i] for k in STAGES) for i, w in enumerate(walls)]
    out = dict(corpus_bytes=n, chunk_bytes=chunk, chunks=chunks,
               serial_wall_wrapped=wall_st, serial_wall=serial,
               pipelined_wall=pipelined, max_outstanding=3,
               stages={k: dict(seconds_per_chunk=stats(
                   [s / chunks for s in per[k]]),
                   share=med(stats(per[k])) / med(wall_st),
                   calls_per_chunk=calls[k] / chunks) for k in STAGES},
               unaccounted=stats(rest),
               unaccounted_share=med(stats(rest)) / med(wall_st),
               reached=reached, rows=len(plain["rows"]), equal=True)
    if run.card:
        out["stages"]["k1"]["device_seconds_per_chunk"] = stats(
            [s / chunks for s in k1_dev])
    timed.clock = None
    clock = StageClock(run.card, sync=False)
    got = []
    with stage_wrappers(clock), trace(device=run.device) as mt:
        got.append(chunked())
    if not np.array_equal(got[0], plain["rows"]):
        fail(f"{d.name}: the traced run's rows != the serial run's")
    # the stages' own ranges may show on the device as annotation spans:
    # they are no device work
    by_name = {k: v for k, v in mt.device_seconds_by_name().items()
               if not k.startswith("stage:")}
    busy = sum(by_name.values())
    out["trace"] = dict(
        wall_seconds=mt.wall_seconds, device_busy_seconds=busy or None,
        idle_share=1 - busy / mt.wall_seconds if busy else None,
        device_seconds_by_name=dict(sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:10]))
    if run.card:
        by_stage = trace_by_stage(mt, by_name)
        out["trace"].update(device_seconds_by_stage=by_stage,
                            unattributed_device_seconds=busy - sum(
                                by_stage.values()))
        out["pinned_upload"] = pinned_yardstick(run, d)
    return out


# ---- arm stream -------------------------------------------------------------

def stream_feeds(run: Run, m, compiled, cfg, data: bytes, feed: int):
    """``StreamMatcher.feed_async`` over ``data`` in ``feed``-byte feeds,
    ``DEPTH`` dispatched ahead of the one resolved, then ``finish()``:
    (rows, seconds a loop turn, seconds from a feed to its result,
    total seconds).  A turn is not synchronised (that would end the
    overlap); a resolver's download waits for its scan.  The streams
    share ``m``, whose scanners are built."""
    from phfpfac_tpu_torch.parallel.stream import StreamMatcher

    def stream():
        sm = StreamMatcher(compiled, cfg, device=run.device)
        sm.matcher = m  # the built scanners, not a second build
        return sm

    warm = stream()
    for i in (0, feed):  # both window shapes: no tail, then a tail
        warm.feed(data[i:i + feed])
    sm = stream()
    parts, pending, turns, latency = [], [], [], []
    run.sync()
    t_start = time.perf_counter()
    for i in range(0, len(data), feed):
        t0 = time.perf_counter()
        pending.append((sm.feed_async(data[i:i + feed]), t0))
        if len(pending) > DEPTH:
            r, tf = pending.pop(0)
            parts.append(r())
            latency.append(time.perf_counter() - tf)
        turns.append(time.perf_counter() - t0)
    for r, tf in pending:
        parts.append(r())
        latency.append(time.perf_counter() - tf)
    parts.append(sm.finish())
    run.sync()
    total = time.perf_counter() - t_start
    return np.concatenate(parts), turns, latency, total


def arm_stream(run: Run, d: Deployment) -> dict:
    """clamav5k: host-fed at each of ``FEEDS`` and device-resident over
    the size of ``--mib`` (1 GiB); ascii50k: a quarter of it in exact
    mode at ``FEEDS[0]``.  Every result against ``match_chunked`` over
    the same bytes, and that against the oracle windows and plants."""
    from phfpfac_tpu_torch.parallel.matcher import Matcher

    exact = d.name == "ascii50k"
    size = run.size("stream") // (4 if exact else 1)
    rng = np.random.default_rng([run.seed, 2, DICTS.index(d.name)])
    data, planted = cs.make_corpus(
        rng, d.pats, size, PRINTABLE if exact else None,
        plants=max(1, round(size * DENSITY)))
    cfg = (dataclasses.replace(d.cfg, truncation="none") if exact
           else d.cfg)
    compiled = with_tables(d)  # the split shards' tables are rebuilt
    m = Matcher(compiled, cfg, device=run.device, train=train_of(data))
    m._get_pallas_scanner()
    n = len(data)
    ref = {}
    uploaded = run.seconds(lambda: ref.__setitem__(
        "rows", m.match_chunked(data, input_size=n, chunk_bytes=CHUNK)))
    windows = hold_to_oracle(ref["rows"], d.pats, d.plen, data, n, cfg,
                             planted, f"{d.name} stream")
    want = sorted_rows(ref["rows"])
    out = dict(bytes=n, truncation=cfg.truncation, depth=DEPTH,
               matches=len(want), oracle_windows=windows,
               planted=len(planted),
               match_chunked_uploaded_seconds=uploaded)
    for feed in FEEDS[:1] if exact else FEEDS:
        got, turns, latency, total = stream_feeds(run, m, compiled, cfg,
                                                  data, feed)
        if not np.array_equal(sorted_rows(got), want):
            fail(f"{d.name} stream at {feed} B feeds != match_chunked")
        out[f"host_fed_{feed}"] = dict(
            feed_bytes=feed, feeds=len(turns),
            seconds_per_feed=stats(turns), feed_to_result=stats(latency),
            seconds=total, gb_per_s=n / total / 1e9, equal=True)
    if not exact:
        staged = m.stage_for_chunked(data, chunk_bytes=CHUNK)
        res = {}
        st = stats(run.samples(lambda: res.__setitem__(
            "rows", m.match_chunked(data, input_size=n, chunk_bytes=CHUNK,
                                    device_data=staged))))
        if not np.array_equal(rows(res["rows"]), rows(ref["rows"])):
            fail(f"{d.name}: the device-resident stream != match_chunked")
        out["device_resident"] = dict(seconds=st, gb_per_s=gb_per_s(n, st),
                                      staged_bytes=int(staged.numel()),
                                      equal=True)
        del staged
    return out


# ---- arm coldstart ----------------------------------------------------------

def coldstart_child(spec: dict) -> dict:
    """The timed fresh process of a cold start: everything from the
    interpreter's first line counts."""
    from phfpfac_tpu_torch import _build
    from phfpfac_tpu_torch.compile.tables import CompiledDictionary
    from phfpfac_tpu_torch.parallel.matcher import Matcher
    from phfpfac_tpu_torch.utils.config import PfacConfig

    t = {"import": time.perf_counter() - T0}
    device = torch.device(spec["device"])
    card = device.type == "cuda"

    def lap(step, t0):
        if card and torch.cuda.is_initialized():  # a sync would start CUDA
            torch.cuda.synchronize()
        t[step] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    compiled = CompiledDictionary.load(spec["tables"])
    t0 = lap("load", t0)
    held = None
    if card:
        torch.zeros(1, device=device)
        t0 = lap("cuda_init", t0)
        held = _build._target("plan_scan").exists()
        _build.load("plan_scan")
        t0 = lap("library_load", t0)
    with open(spec["data"], "rb") as f:
        data = f.read()
    m = Matcher(compiled, cli_config(PfacConfig), device=device,
                train=train_of(data))
    m._get_pallas_scanner()
    t0 = lap("scanners", t0)
    got = m.match_chunked(data, input_size=len(data))
    lap("first_result", t0)
    np.save(spec["rows"], rows(got))
    carried = sum(p is not None for p in compiled.plan_tables or [])
    return dict(seconds=t, library_held=held, plan_tables_carried=carried)


def arm_coldstart(run: Run, d: Deployment) -> dict:
    """Phase 0 (untimed): the scan the deployment's build ran, saved with
    its plan tables; one ``FIRST``-byte result.  Phase 1: this script
    in a fresh interpreter, ``reps`` times after a warm-up."""
    base = os.path.join(run.tmp, f"{d.name}.cold")
    spec = dict(tables=base + ".npz", data=base + ".in",
                rows=base + ".rows.npy", device=run.device.type)
    first = d.corpus[:FIRST]
    want = rows(d.matcher.match_chunked(first, input_size=len(first)))
    with_tables(d).save(spec["tables"])
    with open(spec["data"], "wb") as f:
        f.write(first)
    if not np.array_equal(want, within(cli_rows(run, d), d.plen, 0,
                                       len(first))):
        fail(f"{d.name}: phase 0's first result != the CLI's rows")
    walls, kids = [], []
    for i in range(run.reps + 1):
        wall, line, _err = run_child(child("coldstart", spec))
        if not np.array_equal(np.load(spec["rows"]), want):
            fail(f"{d.name}: a fresh process's first result != phase 0's")
        if i:  # the first is the warm-up
            walls.append(wall)
            kids.append(json.loads(line))
    steps = {k: stats([c["seconds"].get(k) for c in kids])
             for k in ("import", "load", "cuda_init", "library_load",
                       "scanners", "first_result")}
    return dict(first_bytes=len(first), wall=stats(walls), steps=steps,
                interpreter_and_exit=stats(
                    [w - c["inside"] for w, c in zip(walls, kids)]),
                plan_tables_carried=kids[0]["plan_tables_carried"],
                shards=len(d.compiled.shards),
                library_held_before_load=kids[0]["library_held"],
                nvcc_build=run.build, equal_to_phase_0=True)


# ---- the word regimes ---------------------------------------------------------

WORD_REPS = 2  # timed runs after a warm-up: a run scans 32-128 MiB at dense
               # matches


def count_total(run: Run, d: Deployment) -> int:
    """K1's count-mode total over the corpus (exact mode), summed over
    the plan shards: the matches of the patterns it walks."""
    from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
    from phfpfac_tpu_torch.ops.plan import PlanCountScan

    n = len(d.corpus)
    padded = pad_input(d.corpus, 1024, padded_steps(d.compiled.max_pat_len))
    total = 0
    for shard, sc in plan_entries(d):
        c = PlanCountScan(shard, padded_steps(d.compiled.max_pat_len),
                          device=run.device, pt=sc.pt, compact="off")
        total += int(c(padded, n, 0))
    return total


def cli_file(run: Run, d: Deployment) -> dict:
    """The CLI as a process (``python3 -m phfpfac_tpu_torch.cli``) at
    streamnum 1 (4 shards, its default segment cut) on the regime's
    files, on the first ``CLI_CUT`` bytes where set: its wall, lines and
    bytes; its file byte-identical to the rendering of the one-shard
    rows over the same bytes (any shard count gives the same file for a
    duplicate-free dictionary)."""
    from phfpfac_tpu_torch.parallel.merge import render_result_file

    want, n = cli_rows(run, d), len(d.corpus)
    cut = min(CLI_CUT.get(d.name, n), n)
    in_file = d.files[1]
    if cut < n:
        in_file = os.path.join(run.tmp, f"{d.name}.cut.in")
        with open(in_file, "wb") as f:
            f.write(d.corpus[:cut] + b"\n")  # the CLI scans size - 1
        want = within(want, d.plen, 0, cut)
    out = os.path.join(run.tmp, f"{d.name}.cli4.out")
    wall, _line, _err = run_child(
        [sys.executable, "-m", "phfpfac_tpu_torch.cli", d.files[0], "1",
         "4096", in_file, "-o", out, "--quiet", *d.flags, "--device",
         run.device.type])
    t0 = time.perf_counter()
    text = render_result_file(want).encode()
    render = time.perf_counter() - t0
    size = os.path.getsize(out)
    with open(out, "rb") as f:
        same = f.read() == text
    os.remove(out)
    if not same:
        fail(f"{d.name}: the CLI's file ({size} B) != the one-shard "
             f"rendering ({len(text)} B)")
    return dict(wall_seconds=wall, corpus_bytes=cut, cut=cut < n,
                num_shards=4, lines=len(want), file_bytes=size,
                render_seconds=render, byte_identical=True)


def arm_words_e2e(run: Run, d: Deployment) -> dict:
    """A word regime end to end: its build and calibration; the
    one-shard rows held to the oracle windows and the plants, K1's
    count total equal to their number; K1 alone (count mode, chained);
    ``Matcher.match``, ``match_chunked`` uploaded per chunk and over the
    corpus staged once; the CLI as a process (``cli_file``)."""
    m, corpus, n = d.matcher, d.corpus, len(d.corpus)
    laps, t0 = {}, time.perf_counter()

    def lap(step):
        nonlocal t0
        laps[step] = time.perf_counter() - t0
        t0 = time.perf_counter()

    want = cli_rows(run, d)
    lap("rows_oracle_plants")
    short = int((d.plen[want[:, 1]] <= 32).sum())
    total = count_total(run, d)
    lap("count_total")
    if total != short:
        fail(f"{d.name}: K1's count total {total} != the {short} rows of "
             "the patterns it walks")
    target = d.build["target"]["matches_per_byte"]
    out = dict(d.build, matches=len(want), count_total=total,
               matches_per_byte=len(want) / n,
               matches_vs_target=len(want) / n / target,
               oracle_windows=len(range(CHUNK, n, CHUNK)) + 1,
               chunk_bytes=CHUNK, reps=WORD_REPS)
    out["calibrated"] = dict(
        states=abs(out["states_vs_target"]) <= STATE_TOLERANCE,
        matches_per_byte=(1 / DENSITY_FACTOR <= out["matches_vs_target"]
                          <= DENSITY_FACTOR))
    out["scan"] = scan_alone(run, d)
    lap("scan_alone")
    staged = m.stage_for_chunked(corpus, chunk_bytes=CHUNK)
    kw = dict(input_size=n, chunk_bytes=CHUNK)
    res = {}
    for label, fn in (
            ("match", lambda: m.match(corpus, input_size=n)),
            ("chunked", lambda: m.match_chunked(corpus, **kw)),
            ("device_chunked",
             lambda: m.match_chunked(corpus, device_data=staged, **kw))):
        st = stats(run.samples(lambda: res.__setitem__(label, fn()),
                               WORD_REPS))
        hold(run, d, res.pop(label), f"e2e {label}")
        out[label] = dict(seconds=st, gb_per_s=gb_per_s(n, st))
        lap(label)
    del staged
    out["cli"] = cli_file(run, d)
    lap("cli")
    if out["cli"]["cut"]:  # forced by the run's time limit
        out["reduced"] = [f"cli: the first {out['cli']['corpus_bytes']} of "
                          f"{n} bytes"]
    out["arm_seconds"] = dict(laps, checks=d.check_seconds)
    return out


def arm_words_stream(run: Run, d: Deployment) -> dict:
    """``StreamMatcher.feed_async`` over the regime's corpus in 1 MiB
    feeds, exact mode, ``DEPTH`` outstanding, held to the one-shard
    rows."""
    want = sorted_rows(cli_rows(run, d))
    got, turns, latency, total = stream_feeds(run, d.matcher, d.compiled,
                                              d.cfg, d.corpus, FEEDS[0])
    if not np.array_equal(sorted_rows(got), want):
        fail(f"{d.name} stream at {FEEDS[0]} B feeds != match_chunked")
    n = len(d.corpus)
    return dict(bytes=n, truncation=d.cfg.truncation, depth=DEPTH,
                matches=len(want), feed_bytes=FEEDS[0], feeds=len(turns),
                seconds_per_feed=stats(turns), feed_to_result=stats(latency),
                total_seconds=total, gb_per_s=n / total / 1e9, equal=True)


def kernel_launches():
    from phfpfac_tpu_torch.ops import plan as K1

    return dict(plan_scan=K1.launches,
                plan_scan_compact_a=K1.launches_compact_a,
                planb_scan=K1.launches_compact_b,
                overflow_rescans=K1.overflow_rescans)


def reset_launches() -> None:
    from phfpfac_tpu_torch.ops import plan as K1

    K1.launches = K1.launches_compact_a = K1.launches_compact_b = 0


def arm_compact(run: Run, d: Deployment) -> dict:
    """The compacted scan (K1' + K6) on the regime's tables, as
    ``bench.py``'s english A/B runs it: per plan shard the cut and cap
    ``resolve_compact(pt, n_pos, "auto")`` gives with the opt-in (else
    the first explicit cut that resolves, as ``chip_smoke.py``'s
    ``compact_path``), the survivors on the first window and whether
    they outran the cap; ``match_chunked`` with it engaged, its launches
    and overflow rescans, held to the one-shard rows, timed (the
    uncompacted run is the e2e arm's ``chunked``); count mode chained
    both ways, the better kept."""
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
    from phfpfac_tpu_torch.ops.staging import TILE

    m, corpus, n = d.matcher, d.corpus, len(d.corpus)
    shards = []
    for shard, sc in plan_entries(d):
        staged, nw = cs.scan_inputs(sc, corpus[:CHUNK], run.device)
        how, cut, cap, why = cs.choose_compact(sc.pt, staged.numel() - TILE)
        r = dict(how=how, cut=cut, cap=cap, declined=why,
                 live_frac=[float(f) for f in sc.pt.live_frac])
        if how is not None:
            _res, surv = K1.plan_scan_compact_a(staged, sc.tables, cut=cut,
                                                cap=cap)
            r.update(window_bytes=nw, survivors=int(surv[2]),
                     survivor_share=int(surv[2]) / nw,
                     window_overflows=int(surv[2]) > cap)
        shards.append((sc, r))
        del staged
    out = dict(shards=[r for _sc, r in shards])
    if any(r["how"] is None for _sc, r in shards):
        return dict(out, engaged=False)
    kw = dict(input_size=n, chunk_bytes=CHUNK)
    saved = [sc.compact for sc, _r in shards]
    for sc, r in shards:
        sc.compact = "auto" if r["how"] == "auto" else r["cut"]
    try:
        with cs.opted_in():
            reset_launches()
            rescans0 = K1.overflow_rescans
            got = m.match_chunked(corpus, **kw)
            run.sync()
            launches = kernel_launches()
            launches["overflow_rescans"] -= rescans0
            hold(run, d, got, "compacted match_chunked")
            compacted = stats(run.samples(lambda: m.match_chunked(corpus,
                                                                  **kw),
                                          WORD_REPS))
    finally:
        for (sc, _r), c in zip(shards, saved):
            sc.compact = c
    # count mode over the corpus staged once, chained, both ways
    padded = pad_input(corpus, 1024, padded_steps(d.compiled.max_pat_len))
    ms = padded_steps(d.compiled.max_pat_len)
    count = {}
    for label, compact in (("plain", "off"), ("compacted", None)):
        scans = []
        for (shard, sc), (_sc, r) in zip(plan_entries(d), shards):
            # the cap resolved for the whole corpus, staged at once
            c = K1.PlanCountScan(shard, ms, device=run.device, pt=sc.pt,
                                 compact=compact or (
                                     "auto" if r["how"] == "auto"
                                     else r["cut"]))
            scans.append((c, c.prepare(padded, n)))

        def chain():
            with cs.opted_in():
                return [c.scan_chain(st, n, 0, CHAIN_K) for c, st in scans]

        totals = [int(t) for t in chain()]
        overflowed = any(c.check_overflow() for c, _st in scans)
        secs = ([cs.cuda_ms(chain, reps=1) / CHAIN_K / 1e3
                 for _ in range(run.reps)] if run.card else
                [s / CHAIN_K for s in run.samples(chain)])
        if run.card:
            overflowed |= any(c.check_overflow() for c, _st in scans)
        count[label] = dict(seconds_per_scan=stats(secs), totals=totals,
                            overflowed=overflowed)
        del scans
    exact = count["compacted"]["overflowed"] or \
        count["compacted"]["totals"] == count["plain"]["totals"]
    if not exact:
        fail(f"{d.name}: the compacted count totals "
             f"{count['compacted']['totals']} != the plain ones "
             f"{count['plain']['totals']} with no overflow")
    better = ("plain" if count["compacted"]["overflowed"] or
              med(count["plain"]["seconds_per_scan"])
              <= med(count["compacted"]["seconds_per_scan"]) else "compacted")
    # (the uncompacted match_chunked: the e2e arm's "chunked")
    return dict(out, engaged=True, launches=launches, match_chunked=dict(
        compacted=compacted, compacted_gb_per_s=gb_per_s(n, compacted)),
        count=count, count_better=better, equal=True)


def gather_rows(run: Run) -> list:
    """P1's int32 rates at its swept tables up to 32 MiB (once a run),
    every timed shape held to its plain version."""
    if getattr(run, "g_rows", None) is None:
        from phfpfac_tpu_torch.probes import gather

        run.g_rows = list(gather.sweep(
            run.device, arms=("i32",), ks=(1, 8),
            table_bytes=tuple(b for b in gather.SWEEP_TABLE_BYTES
                              if b <= 32 << 20),
            check=lambda got, want, what: cs.agree("probe_gather", [got],
                                                   [want], what)))
    return run.g_rows


def arm_kernels(run: Run, d: Deployment) -> dict:
    """K1, K1' and K6 on the regime's tables (the plan shard; a split
    shard's short part) over the first 16 MiB window, each held bit for
    bit to its plain version: K1 bitmap and count mode (the count equal
    to the bitmap's popcount and to the one-shard rows there), K1' at
    the compacted arm's cut and cap (else cut 1 at half the window), K6
    on its survivors, the pair equal to K1.  K1 timed (``cuda_ms``, the
    profiler's device time), its launches in one ``match_chunked`` run,
    its bytes bound (4 B read, 8 B written a position, the tables once)
    and gather bound (its dependent gathers on this window, table by
    table, over P1's best int32 rate at tables no larger)."""
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.staging import TILE

    (_shard, sc), = plan_entries(d)
    window = d.corpus[:CHUNK]
    staged, nw = cs.scan_inputs(sc, window, run.device)
    t, n_pos = sc.tables, staged.numel() - TILE
    what = f"{d.name} window"
    cnt, bits = K1.plan_scan(staged, t)
    cs.agree("plan_scan", [cnt, bits], K1.plan_scan_plain(staged, t),
             f"{what}: K1 bitmap")
    total = K1.plan_scan(staged, t, emit="count")
    cs.agree("plan_scan", [total], [K1.plan_scan_plain(staged, t,
                                                       emit="count")],
             f"{what}: K1 count")
    pop = int(K1.popcount32(bits[:nw]).sum())
    want = within(cli_rows(run, d), d.plen, 0, nw)
    walked = int((d.plen[want[:, 1]] <= 32).sum())
    if not int(total) == pop == walked:
        fail(f"{what}: count {int(total)}, popcount {pop}, rows {walked}")
    cut, cap = 1, n_pos // 2 // K1.COMPACT_BLOCK * K1.COMPACT_BLOCK
    how, c, k, _why = cs.choose_compact(sc.pt, n_pos)
    if how is not None:
        cut, cap = c, k
    kw = dict(cut=cut, cap=cap)
    got, surv = K1.plan_scan_compact_a(staged, t, **kw)
    want_a, want_surv = K1.plan_scan_compact_a_plain(staged, t, **kw)
    count, fed = int(surv[2]), None
    cs.agree("plan_scan_compact_a",
             [*got, *cs.sorted_survivors(surv, cap)],
             [*want_a, *cs.sorted_survivors(want_surv, cap)],
             f"{what}: K1' cut={cut} cap={cap}")
    if count <= cap:
        pad = torch.zeros(cap - count, dtype=torch.int32, device=run.device)
        fed = (torch.cat([want_surv[0], pad]),
               torch.cat([want_surv[1], pad]), want_surv[2])
        K1.planb_scan(staged, t, got, fed, **kw)
        K1.planb_scan_plain(staged, t, want_a, want_surv, **kw)
        cs.agree("planb_scan", got, want_a, f"{what}: K6")
        cs.agree("planb_scan", got, [cnt, bits], f"{what}: K1' + K6 != K1")
    del got, want_a, fed
    out = dict(window_bytes=nw, n_pos=n_pos, matches=walked,
               matches_per_byte=walked / nw, cut=cut, cap=cap,
               survivors=count, overflowed=count > cap,
               plan_table_bytes=cs.table_bytes(t),
               max_abs_err={k: cs.MAX_ERR[k] for k in
                            ("plan_scan", "plan_scan_compact_a",
                             "planb_scan")})
    reset_launches()
    d.matcher.match_chunked(d.corpus, input_size=len(d.corpus),
                            chunk_bytes=CHUNK)
    run.sync()
    out["launches_a_run"] = kernel_launches()
    out["bytes_bound_ms"] = cs.bound_ms(n_pos, cs.table_bytes(t), True)
    out["count_bytes_bound_ms"] = cs.bound_ms(n_pos, cs.table_bytes(t),
                                              False)
    if run.card:
        def timed(fn, name):
            return dict(cuda_ms=stats([cs.cuda_ms(fn) for _ in
                                       range(run.reps)]),
                        device_ms=cs.device_ms(fn, name))

        out["k1"] = timed(lambda: K1.plan_scan(staged, t), "plan_scan")
        out["k1_count"] = timed(lambda: K1.plan_scan(staged, t,
                                                     emit="count"),
                                "plan_scan")
        out["k1_plain_ms"] = cs.cuda_ms(lambda: K1.plan_scan_plain(staged, t),
                                        reps=2)
        items = [it for step in cs.plan_step_probes(staged, t, 0)
                 for it in step]
        rows_ = gather_rows(run)
        ms, tiers = 0.0, {}
        for g, tb in items:
            rate, tier = cs.gather_rate(rows_, tb)
            ms += g / rate * 1e3
            tiers[tier] = tiers.get(tier, 0) + g
        out["gather_bound"] = dict(
            gathers=sum(g for g, _ in items), gather_bound_ms=ms,
            gathers_by_table_tier_bytes=dict(sorted(tiers.items())),
            rates={r["table_bytes"]: r["gathers_per_s"] for r in rows_
                   if r["k"] == 1})
        if med(out["k1"]["cuda_ms"]) < ms:
            fail(f"{what}: K1 under its gather bound")
    return out


def arm_e2e_any(run: Run, d: Deployment) -> dict:
    return (arm_words_e2e if d.name in WORDS else arm_e2e)(run, d)


def arm_stream_any(run: Run, d: Deployment) -> dict:
    return (arm_words_stream if d.name in WORDS else arm_stream)(run, d)


def arm_stages(run: Run, d: Deployment) -> dict:
    return stages(run, d, 1 if d.name in WORDS else None)


def calibration(d: Deployment) -> dict:
    """A word regime against ``WORD_COUNTS``: states and, once its rows
    are counted, matches a byte (``STATE_TOLERANCE``,
    ``DENSITY_FACTOR``)."""
    t = d.build["target"]
    out = dict(states=d.build["states"],
               states_vs_target=d.build["states_vs_target"])
    if d.cli_rows is not None:
        mpb = len(d.cli_rows) / len(d.corpus)
        out.update(matches_per_byte=mpb,
                   matches_vs_target=mpb / t["matches_per_byte"])
    return out


def applies(arm: str, name: str) -> bool:
    return arm in (WORD_ARMS[name] if name in WORDS else ARMS)


ARM_FNS = dict(e2e=arm_e2e_any, stages=arm_stages, stream=arm_stream_any,
               coldstart=arm_coldstart, compact=arm_compact,
               kernels=arm_kernels)
CHILDREN = dict(split=split_child, coldstart=coldstart_child)


# ---- main -------------------------------------------------------------------

def emit(obj: dict) -> None:
    print(json.dumps({**obj, "at_seconds": time.perf_counter() - T0}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arm", choices=(*ARMS, *WORD_ONLY_ARMS, "all"),
                    default="all")
    ap.add_argument("--dict", choices=(*DICTS, *WORDS, "both", "words"),
                    default="both")
    ap.add_argument("--mib", type=float, default=None,
                    help="corpus MiB (default 64; the stream arm 1,024)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--patterns", type=int, default=None,
                    help="dictionary size (default 50,000 / 5,000)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:  # a fresh process of the e2e or coldstart arm
        spec = json.loads(args.child)
        out = CHILDREN[spec["kind"]](spec)
        print(json.dumps(dict(out, inside=time.perf_counter() - T0)))
        return 0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("chip_e2e: no CUDA device", file=sys.stderr)
        return 1
    run = Run(device, reps=args.reps, mib=args.mib, seed=args.seed,
              patterns=args.patterns)
    emit(dict(device=run.describe()))
    if run.card:
        from phfpfac_tpu_torch import _build

        held = all(_build._target(s).exists() for s in _build.SOURCES)
        t0 = time.perf_counter()
        _build.build_all()
        run.build = dict(seconds=time.perf_counter() - t0,
                         libraries_held_before=held)
    arms = (*ARMS, *WORD_ONLY_ARMS) if args.arm == "all" else (args.arm,)
    names = dict(both=DICTS, words=WORDS).get(args.dict, (args.dict,))
    results, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        run.tmp = tmp
        for arm in arms:
            for name in names:
                if not applies(arm, name):
                    continue
                t0 = time.perf_counter()
                try:
                    d = run.deployment(name)
                    r = dict(ARM_FNS[arm](run, d), ok=True)
                    if name in WORDS:
                        r["calibration"] = calibration(d)
                except Exception as e:  # noqa: BLE001 - reported; exit 1
                    r = dict(ok=False, error=f"{type(e).__name__}: {e}",
                             traceback=traceback.format_exc().splitlines()
                             [-8:])
                    failed.append(f"{arm}:{name}")
                r = dict(arm=arm, dictionary=name, **r,
                         seconds=time.perf_counter() - t0)
                results.setdefault(arm, {})[name] = r
                emit(r)
    ok = not failed
    emit(dict(summary=True, ok=ok, failed=failed, device=run.describe(),
              build=run.build, arms=results))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
