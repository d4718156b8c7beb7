"""Card soak of the PyTorch/CUDA port: every route at random geometries
against the oracle (the port's counterpart of ``bench/tpu_fuzz.py``).

Run on a machine with a CUDA GPU, from the repository root:

    python3 chip_fuzz.py [--seeds 15] [--start 100] [--segment] [--charset]
                         [--mib N] [--device cuda|cpu]

Each seed draws a dictionary, a corpus and a geometry from its own numpy
generator (``draw_geometry``): hash width, 1-4 shards, the walk cut
(exact mode; with ``--segment`` a power-of-two segment of 256-8,192 B
and a random halo below it, one seed in eight a segment that is not a
power of two, which routes the depth kernel), the corpus size (up to
``MAX_BYTES``; one seed in eight 1-6,000 B), an ``input_size`` 0-3 B
short of the data, a chunk size that cuts the corpus into 2-40 chunks,
``max_outstanding``, stream feeds of 1 B to 64 KiB and cuts for
``match_many``.  It then runs every route of the port that the
dictionary allows, on the device, and holds each to ``oracle/ac.py``
(class dictionaries: ``chip_smoke.py::class_oracle`` under the cut):
``Matcher.match``, ``match_chunked``, the device-resident chunk loop,
``StreamMatcher``, ``match_many``, ``count_matches``,
``PlanMeshMatcher`` and ``PallasMeshMatcher`` on 2 and 4 cells,
``MultiHostMatcher`` on 4, the CLI's result file, and the CLI with
``--save-tables`` then ``--load-tables`` (no pattern file read).
Dictionaries: ``tests/test_fuzz.py``'s four
flavors, ``chip_smoke.py::soak_case``'s kinds and a ``words`` draw (its
English-like words and titles over their text, at about 0.3-1 match a
byte: ``word_dictionary``); ``--charset`` takes
``bench/tpu_fuzz.py``'s random class dictionaries and ``soak_case``'s
class kind.

``--mib N`` runs the large-corpus arm instead: ``match_chunked`` at the
CLI's 16 MiB chunks over an N MiB corpus with a ragged end and patterns
planted across every chunk boundary, against the turbo engine (torch
ops, no hand-written kernel) over the whole corpus and the oracle on a
64 KiB window around every boundary and around the end.

One JSON line a seed (geometry, routes checked, routes refused by their
tables and why, kernel launches, failures with a reproducer, seconds),
then a summary line.  A mismatch or an error in a route is recorded and
the soak goes on; the exit code is 1 if any check failed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402

KIB, MIB = 1 << 10, 1 << 20
ARMS = ("exact", "segment", "charset")
PLAIN_SOURCES = ("fuzz:abcd", "fuzz:english", "fuzz:dense40", "fuzz:binary",
                 "soak:dense", "soak:s0", "soak:s0x", "words:titles")
CLASS_SOURCES = ("classes:narrow", "classes:lower", "classes:binary",
                 "soak:class")
ROUTES = ("match", "match_chunked", "device_data", "stream", "match_many",
          "count_matches", "plan_mesh", "pallas_mesh", "multihost", "cli",
          "tables")
LARGE_ROUTES = ("large_turbo", "large_oracle")
# how the Matcher routes pick their kernels: as they do (the plan kernel
# first), with the plan kernel withheld (K3 in exact mode, else K2), or
# with no per-shard kernel (K5 over every shard, the turbo engine past 32
# steps); one seed in six each for the last two
SCANNERS = ("matcher",) * 4 + ("no_plan", "multi")
MAX_BYTES = 256 * KIB  # the largest corpus a seed draws: the oracle's
# walk takes seconds a MiB on a host
MAX_FEEDS = 48  # stream feeds a seed
CLI_BYTES = 64 * KIB  # the CLI's input file: the corpus head
LARGE_CHUNK = 16 * MIB  # the CLI's match_chunked window
LARGE_WINDOW = 64 * KIB  # oracle window around a chunk boundary


# ---- generators ----------------------------------------------------------

# tests/test_fuzz.py::_dict_and_corpus's alphabets, by flavor
FUZZ_ALPHABETS = (
    np.frombuffer(b"abcd", dtype=np.uint8),
    np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8),
    np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789 .,;:-'",
                  dtype=np.uint8),
    np.arange(256, dtype=np.uint8),
)


def dict_and_corpus(seed: int):
    """A copy of ``tests/test_fuzz.py::_dict_and_corpus`` (which imports
    JAX): 5-120 distinct words of 1-13 B and 512-6,000 B of text over one
    of four alphabets (``seed % 4``): ``abcd``, English, 40+ symbols (the
    dense P0), full binary."""
    rng = np.random.default_rng(seed)
    alpha = FUZZ_ALPHABETS[seed % 4]
    n_words = int(rng.integers(5, 120))
    words = list(
        dict.fromkeys(
            bytes(alpha[rng.integers(0, len(alpha), int(rng.integers(1, 14)))])
            for _ in range(n_words)
        )
    )
    data = bytes(alpha[rng.integers(0, len(alpha),
                                    int(rng.integers(512, 6000)))])
    return words, data


# bench/tpu_fuzz.py::_class_dict_and_corpus's byte ranges, by flavor
CLASS_RANGES = ((97, 115), (48, 123), (0, 256))


def class_dict_and_corpus(seed: int):
    """A copy of ``bench/tpu_fuzz.py::_class_dict_and_corpus``: 4-23
    class patterns of 1-5 elements (ranges, multi-member and negated
    classes, ``\\xNN`` escapes, sometimes a duplicate) over one of three
    byte ranges (``seed % 3``), and 512-6,000 B of data."""
    rng = np.random.default_rng(seed)
    lo, hi = CLASS_RANGES[seed % 3]
    pats = []
    n_pats = int(rng.integers(4, 24))
    for _ in range(n_pats):
        n = int(rng.integers(1, 6))
        spec = b""
        for _ in range(n):
            r = rng.random()
            b = int(rng.integers(lo, hi))
            if r < 0.30:  # range class
                span = int(rng.integers(1, 6))
                a = min(b, hi - 1 - span)
                spec += b"[" + _esc(a) + b"-" + _esc(a + span) + b"]"
            elif r < 0.45:  # multi-member class
                members = rng.integers(lo, hi, int(rng.integers(2, 5)))
                spec += b"[" + b"".join(_esc(int(m)) for m in members) + b"]"
            elif r < 0.55:  # negated class
                members = rng.integers(lo, hi, int(rng.integers(1, 4)))
                spec += b"[^" + b"".join(_esc(int(m)) for m in members) + b"]"
            else:  # literal (escaped when needed)
                spec += _esc(b)
        pats.append(spec)
    if n_pats > 6 and rng.random() < 0.3:
        pats[-1] = pats[0]  # duplicate pattern (both ids must report)
    data = bytes(
        rng.integers(lo, hi, int(rng.integers(512, 6000))).astype(np.uint8)
    )
    return pats, data


def _esc(b: int) -> bytes:
    """Escape a byte for the class-pattern syntax."""
    if b in b"[]^-\\" or not (32 <= b < 127):
        return b"\\x%02x" % b
    return bytes([b])


class Case:
    """One seed's dictionary and corpus: ``compiled``, the patterns the
    oracle takes (``pats``: ``Pattern`` or ``ClassPattern``), the pattern
    file's lines (``lines``; escaped bytes for a plain dictionary),
    ``plen`` (length by pattern id), ``data``, ``charset``."""

    def __init__(self, compiled, pats, lines, data, charset):
        self.compiled, self.pats, self.lines = compiled, pats, lines
        self.data, self.charset = data, charset
        self.plen = np.zeros(len(pats) + 1, np.int64)
        for p in pats:
            self.plen[p.pattern_id] = len(p.classes if charset else p.data)


def make_case(source: str, seed: int, cfg, size: int, tmp: str) -> Case:
    """The dictionary of ``source`` for ``seed``, compiled under ``cfg``,
    over a corpus of ``size`` bytes with planted patterns (the head of
    one of at least 16 KiB)."""
    from phfpfac_tpu_torch.compile.tables import (
        compile_class_patterns,
        compile_patterns,
    )
    from phfpfac_tpu_torch.frontend.charset import parse_class_pattern
    from phfpfac_tpu_torch.frontend.patterns import Pattern

    family, name = source.split(":")
    rng = np.random.default_rng([seed, 7])
    full = max(size, 16 * KIB)
    plants = full // 512
    if family == "soak":
        kind_seed = len(cs.SOAK_KINDS) * seed + cs.SOAK_KINDS.index(name)
        _kind, compiled, pats, data = cs.soak_case(kind_seed, tmp, cfg, full)
        if name == "class":
            lines = [_class_line(p) for p in pats]
            return Case(compiled, pats, lines, data[:size], True)
        return Case(compiled, pats, [p.data for p in pats], data[:size],
                    False)
    if family == "words":
        words, pats = word_dictionary(rng)
        text = cs.make_english_text(rng, words, full)
        data, _ = cs.make_corpus(rng, pats, full, plants=plants, base=text)
        pats = [Pattern(i + 1, w) for i, w in enumerate(pats)]
        return Case(compile_patterns(pats, cfg), pats,
                    [p.data for p in pats], data[:size], False)
    if family == "fuzz":
        flavor = PLAIN_SOURCES.index(source)
        words, head = dict_and_corpus(4 * seed + flavor)
        body, _ = cs.make_corpus(rng, words, full - len(head),
                                 FUZZ_ALPHABETS[flavor], plants=plants)
        pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
        return Case(compile_patterns(pats, cfg), pats, words,
                    (head + body)[:size], False)
    flavor = CLASS_SOURCES.index(source)
    specs, head = class_dict_and_corpus(3 * seed + flavor)
    cps = [parse_class_pattern(s, i + 1) for i, s in enumerate(specs)]
    # planted: one random member string of each pattern
    strings = [bytes(int(rng.choice(sorted(c))) for c in cp.classes)
               for cp in cps]
    lo, hi = CLASS_RANGES[flavor]
    body, _ = cs.make_corpus(rng, strings, full - len(head),
                             np.arange(lo, hi, dtype=np.uint8), plants=plants)
    return Case(compile_class_patterns(cps, cfg), cps, specs,
                (head + body)[:size], True)


def word_dictionary(rng):
    """(vocabulary, dictionary) of a ``words`` draw: 200-2,000 of
    ``chip_smoke.py``'s English-like words, 100-3,000 of its titles (3 of
    33-64 B), one draw in two some single letters: about 0.3-1 match a
    byte of the vocabulary's text (``chip_e2e.py``'s word regimes, small)."""
    words = cs.make_english_words(rng, int(rng.integers(200, 2001)))
    pats = dict.fromkeys(words)
    pats.update(dict.fromkeys(cs.make_titles(rng, int(rng.integers(100,
                                                                   3001)))))
    if rng.random() < 0.5:
        pats.update(dict.fromkeys(bytes([c]) for c in rng.choice(
            cs.LETTERS, int(rng.integers(1, 27)), replace=False)))
    return words, list(pats)


def _class_line(cp) -> bytes:
    """A class pattern as one escaped pattern-file line."""
    out = b""
    for c in cp.classes:
        if len(c) == 1:
            out += b"\\x%02x" % next(iter(c))
        else:
            out += b"[" + b"".join(b"\\x%02x" % m for m in sorted(c)) + b"]"
    return out


# ---- the geometry of a seed ------------------------------------------------

def draw_geometry(seed: int, arm: str, max_bytes: int = MAX_BYTES) -> dict:
    """Everything a seed varies, from ``default_rng((seed, arm))``: the
    dictionary source, hash width, shard count, walk cut, corpus size and
    ``input_size``, chunk size, ``max_outstanding``, stream feeds and how
    many run ahead, ``match_many``'s cuts, the mesh shapes and the plan
    mesh's compaction, and what the plan tables' layout is trained on
    (the input's head, or foreign random bytes: a layout never changes
    a result).  Sizes scale with ``max_bytes``; every choice
    before the feeds and cuts is drawn the same whatever it is."""
    rng = np.random.default_rng([seed, ARMS.index(arm)])
    sources = CLASS_SOURCES if arm == "charset" else PLAIN_SOURCES
    u = rng.random(10)  # the draws whose range depends on the sizes
    if u[9] < 1 / 8:  # tpu_fuzz's sizes and below, down to nothing
        corpus = 1 + int(u[0] * 6000)
    else:
        corpus = max(int(max_bytes * (1 + 7 * u[0]) / 8), 1024)
    g = dict(source=sources[seed % len(sources)],
             width=int(rng.choice([256, 512, 4096])),
             num_shards=int(rng.integers(1, 5)), corpus_bytes=corpus,
             input_size=max(corpus - int(rng.integers(0, 4)), 0))
    n = g["input_size"]
    seg = halo = 0
    if arm == "segment" or (arm == "charset" and u[1] < 0.5):
        top = max(256, min(8192, n // 3))
        if u[2] < 1 / 8:  # not a power of two: the depth path
            seg = 100 + int(u[3] * (top - 100))
            seg += (seg & (seg - 1)) == 0
        else:
            seg = 1 << (8 + int(u[3] * (top.bit_length() - 8)))
        halo = int(u[5] * (min(64, seg) if u[4] < 0.5 else seg))
    g.update(truncation="segment" if seg else "none", segment_bytes=seg,
             halo_bytes=halo)
    chunks = 2 + int(u[6] * 39)
    if seg:
        g["chunk_bytes"] = max(seg, n // chunks // seg * seg)
    else:
        g["chunk_bytes"] = max(16, n // chunks + int(u[7] * 31) - 15)
    g["max_outstanding"] = int(rng.integers(0, 4))
    g["stream_ahead"] = int(rng.integers(0, 4))
    g["train"] = ["input", "foreign"][int(rng.integers(0, 2))]
    g["plan_mesh"] = [
        [list(((2, 1), (1, 2))[int(rng.integers(0, 2))]),
         list(((4, 1), (2, 2), (1, 4))[int(rng.integers(0, 3))])],
        ["off", "cap8", "cap1"][int(rng.integers(0, 3))]]
    cuts = sorted(int(c) for c in rng.integers(0, n + 1,
                                               int(rng.integers(1, 20))))
    if u[8] < 0.3:
        cuts.append(cuts[-1])  # an empty buffer
    g["many_cuts"] = sorted(cuts)
    feeds, total = [], 0
    while total < n and len(feeds) < MAX_FEEDS:
        f = int(rng.integers(1, 33)) if rng.random() < 0.3 \
            else int(np.exp(rng.uniform(0, np.log(64 * KIB))))
        feeds.append(min(f, n - total))
        total += feeds[-1]
    g["feeds"] = feeds
    # the Matcher routes' kernels, from a generator of their own so that
    # the draws above do not move
    pick = np.random.default_rng([seed, ARMS.index(arm), 1]).integers(0, 6)
    g["scanners"] = SCANNERS[int(pick)]
    return g


def config_of(g: dict):
    from phfpfac_tpu_torch.utils.config import PfacConfig

    if g["truncation"] == "segment":
        return PfacConfig(width=g["width"], num_shards=g["num_shards"],
                          truncation="segment",
                          segment_bytes=g["segment_bytes"],
                          halo_bytes=g["halo_bytes"])
    return PfacConfig(width=g["width"], num_shards=g["num_shards"],
                      truncation="none")


# ---- the oracle -----------------------------------------------------------

def rows(a) -> np.ndarray:
    return np.asarray(a, np.int64).reshape(-1, 2)


def oracle(case: Case, data: bytes, cfg) -> np.ndarray:
    """The oracle's [(position, pattern id)] over all of ``data``, in
    output order: ``oracle/ac.py::match_oracle``, or for a class
    dictionary ``chip_smoke.py::class_oracle`` with the walk cut applied
    (a match at p of length L stands if p + L <= segment end + halo)."""
    from phfpfac_tpu_torch.oracle.ac import match_oracle

    if not case.charset:
        return rows(match_oracle(case.pats, data, cfg))
    got = rows(cs.class_oracle(case.pats, data))
    if cfg.truncation != "segment" or not len(got):
        return got
    seg = cfg.segment_bytes
    p = got[:, 0]
    end = (p // seg + 1) * seg + cfg.halo_bytes
    return got[p + case.plen[got[:, 1]] <= end]


def within(case: Case, want: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The rows of ``want`` that start at or after ``lo`` and end at or
    before ``hi``, shifted by ``-lo``: the oracle over ``data[lo:hi]``
    where ``lo`` sits on a segment boundary (walks are position-local)."""
    p = want[:, 0]
    keep = (p >= lo) & (p + case.plen[want[:, 1]] <= hi)
    out = want[keep].copy()
    out[:, 0] -= lo
    return out


def sorted_rows(a) -> np.ndarray:
    a = rows(a)
    return a[np.lexsort((a[:, 1], a[:, 0]))]


def first_difference(got, want) -> dict:
    """Where two row lists part: index, a few rows of each, lengths."""
    got, want = rows(got), rows(want)
    k = min(len(got), len(want))
    diff = np.flatnonzero((got[:k] != want[:k]).any(axis=1))
    i = int(diff[0]) if diff.size else k
    return dict(index=i, got=got[i:i + 4].tolist(),
                want=want[i:i + 4].tolist(), got_rows=len(got),
                want_rows=len(want))


# ---- the routes -------------------------------------------------------------

class Seed:
    """One seed's run: the checks by route, refusals, failures."""

    def __init__(self, seed: int, arm: str, g: dict):
        self.seed, self.arm, self.g = seed, arm, g
        self.checks = {}
        self.refused = {}
        self.failures = []

    def check(self, route: str, ok: bool, what: str, detail=None) -> None:
        """One check of ``route``; a failed one keeps ``detail``."""
        self.checks[route] = self.checks.get(route, 0) + 1
        if not ok:
            self.fail(route, what, detail)

    def same(self, route: str, got, want, what: str = "rows differ") -> None:
        """One check: ``got`` equal to ``want``, row for row."""
        got, want = rows(got), rows(want)
        ok = np.array_equal(got, want)
        self.check(route, ok, what,
                   None if ok else first_difference(got, want))

    def fail(self, route: str, what: str, detail) -> None:
        self.failures.append(dict(seed=self.seed, arm=self.arm, route=route,
                                  what=what, detail=detail, geometry=self.g))

    def refuse(self, route: str, why: str) -> None:
        self.refused.setdefault(route, []).append(why)

    def run(self, route: str, fn, *a) -> None:
        """``fn(*a)``; an exception is the route's failure, with its
        traceback, and the soak goes on."""
        try:
            fn(*a)
        except Exception as e:  # noqa: BLE001 - a fault to report
            self.check(route, False, f"{type(e).__name__}: {e}",
                       traceback.format_exc().splitlines()[-6:])


def training(s: Seed, case: Case):
    """The plan layout's training bytes: None (``Matcher`` trains on the
    head of its first input) or 64 KiB of random bytes."""
    if s.g["train"] == "input":
        return None
    rng = np.random.default_rng([s.seed, 11])
    return rng.integers(0, 256, 64 * KIB, dtype=np.uint8).tobytes()


def route_match(s: Seed, case: Case, m, want) -> None:
    """One-shot ``Matcher.match`` with ``input_size`` short of the data."""
    s.same("match", m.match(case.data, input_size=s.g["input_size"]), want)


def route_chunked(s: Seed, case: Case, m, want) -> None:
    """``match_chunked`` at the drawn chunk size and ``max_outstanding``,
    uploaded per chunk, then from one staged upload (``device_data``)."""
    kw = dict(input_size=s.g["input_size"], chunk_bytes=s.g["chunk_bytes"],
              max_outstanding=s.g["max_outstanding"])
    s.same("match_chunked", m.match_chunked(case.data, **kw), want)
    staged = m.stage_for_chunked(case.data, chunk_bytes=s.g["chunk_bytes"])
    s.same("device_data", m.match_chunked(case.data, device_data=staged,
                                          **kw), want)


def route_stream(s: Seed, case: Case, cfg, device, want) -> None:
    """``StreamMatcher`` over the drawn feeds: ``feed`` where nothing runs
    ahead, else ``feed_async`` with ``stream_ahead`` resolvers pending,
    then ``finish``; every match reported once, as over the bytes fed."""
    from phfpfac_tpu_torch.parallel.stream import StreamMatcher

    if cfg.truncation != "segment" and case.charset:
        s.refuse("stream", "exact-mode streaming needs pattern bytes, which "
                           "class shards do not carry")
        return
    sm = StreamMatcher(case.compiled, cfg, device=device)
    parts, pending, at = [], [], 0
    for f in s.g["feeds"]:
        chunk = case.data[at:at + f]
        at += f
        if not s.g["stream_ahead"]:
            parts.append(sm.feed(chunk))
            continue
        pending.append(sm.feed_async(chunk))
        if len(pending) > s.g["stream_ahead"]:
            parts.append(pending.pop(0)())
    parts += [r() for r in pending]
    parts.append(sm.finish())
    s.same("stream", sorted_rows(np.concatenate([rows(p) for p in parts])),
           sorted_rows(within(case, want, 0, at)),
           f"{len(s.g['feeds'])} feeds over {at} B")


def route_many(s: Seed, case: Case, m, want) -> None:
    """``match_many`` over the drawn cuts of ``data[:input_size]``: each
    buffer's matches are the whole scan's that lie inside it."""
    from phfpfac_tpu_torch.parallel.stream import match_many

    if case.charset:
        s.refuse("match_many", "match_many needs pattern bytes, which class "
                               "shards do not carry")
        return
    n = s.g["input_size"]
    bounds = [0, *s.g["many_cuts"], n]
    bufs = [case.data[a:b] for a, b in zip(bounds, bounds[1:])]
    outs = match_many(m, bufs)
    if len(outs) != len(bufs):
        s.check("match_many", False, f"{len(outs)} results for "
                                     f"{len(bufs)} buffers")
        return
    got = np.concatenate([rows(o) + [a, 0] for o, a in zip(outs, bounds)])
    exp = np.concatenate([within(case, want, a, b) + [a, 0]
                          for a, b in zip(bounds, bounds[1:])])
    s.same("match_many", got, exp, f"{len(bufs)} buffers")


def expected_counts(case: Case, cfg, want, n: int) -> np.ndarray:
    """Per-position counts a count scan gives: a final state counts once
    at a position, so for a class dictionary the distinct (position,
    length) pairs of each shard's patterns (a final can carry several
    ids)."""
    from phfpfac_tpu_torch.frontend.patterns import shard_patterns

    if not case.charset:
        return np.bincount(want[:, 0], minlength=n)[:n]
    out = np.zeros(n, np.int64)
    for group in shard_patterns(case.pats, max(cfg.num_shards, 1)):
        ids = np.asarray([cp.pattern_id for cp in group], np.int64)
        sel = want[np.isin(want[:, 1], ids)]
        pairs = np.unique(sel[:, 0] * 1024 + case.plen[sel[:, 1]])
        out += np.bincount(pairs // 1024, minlength=n)[:n]
    return out


def route_count(s: Seed, case: Case, cfg, m, want) -> None:
    """``Matcher.count_matches``: per-position counts over
    ``input_size``."""
    n = s.g["input_size"]
    got = np.asarray(m.count_matches(case.data, input_size=n), np.int64)
    exp = expected_counts(case, cfg, want, n)
    ok = got.shape == exp.shape and np.array_equal(got, exp)
    bad = [] if ok or got.shape != exp.shape else \
        np.flatnonzero(got != exp)[:6].tolist()
    s.check("count_matches", ok, "per-position counts differ",
            None if ok else dict(positions=bad, got=got[bad].tolist(),
                                 want=exp[bad].tolist(), shape=got.shape,
                                 total_got=int(got.sum()),
                                 total_want=int(exp.sum())))


def cells(n: int, device) -> list:
    dev = torch.device(device)
    return [f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"] * n


def route_plan_mesh(s: Seed, case: Case, cfg, device, want) -> None:
    """``PlanMeshMatcher`` on 2 and 4 cells of the card at the drawn
    shapes and compaction: off, one cut with room (8 blocks) or one
    block (which overflows where a cell keeps more survivors, and the
    scan runs again uncompacted)."""
    from phfpfac_tpu_torch.compile.depth import DepthUnsupported
    from phfpfac_tpu_torch.ops.plan import COMPACT_BLOCK
    from phfpfac_tpu_torch.parallel.mesh import make_mesh
    from phfpfac_tpu_torch.parallel.mesh_pallas import PlanMeshMatcher

    shapes, how = s.g["plan_mesh"]
    compact = {"off": "off", "cap8": (1, 8 * COMPACT_BLOCK),
               "cap1": (1, COMPACT_BLOCK)}[how]
    for shape in shapes:
        mesh = make_mesh(*shape, cells(shape[0] * shape[1], device))
        try:  # the table build: the plan tables refuse the dictionary
            pm = PlanMeshMatcher(case.compiled, cfg, mesh,
                                 train=training(s, case) or case.data[:MIB],
                                 compact=compact)
        except DepthUnsupported as e:
            s.refuse("plan_mesh", f"{shape}: {type(e).__name__}: {e}")
            continue
        s.same("plan_mesh", pm.match(case.data, input_size=s.g["input_size"]),
               want, f"mesh {shape} compact {compact}")


def route_pallas_mesh(s: Seed, case: Case, cfg, device, want) -> None:
    """``PallasMeshMatcher`` (K2 per cell, exact mode) on 2 and 4 cells:
    its patterns axis is the shard count, its data axis the rest."""
    from phfpfac_tpu_torch.compile.depth import DepthUnsupported
    from phfpfac_tpu_torch.parallel.mesh import make_mesh
    from phfpfac_tpu_torch.parallel.mesh_pallas import PallasMeshMatcher

    n_shards = len(case.compiled.shards)
    for n in (2, 4):
        if n % n_shards:
            s.refuse("pallas_mesh", f"{n_shards} shards do not tile {n} cells")
            continue
        mesh = make_mesh(n // n_shards, n_shards, cells(n, device))
        try:  # the table build: depth tables, exact mode only
            pm = PallasMeshMatcher(case.compiled, cfg, mesh)
        except DepthUnsupported as e:
            s.refuse("pallas_mesh", f"{n} cells: {type(e).__name__}: {e}")
            continue
        s.same("pallas_mesh",
               pm.match(case.data, input_size=s.g["input_size"]), want,
               f"mesh {(n // n_shards, n_shards)}")


def route_multihost(s: Seed, case: Case, cfg, device, want) -> None:
    """``MultiHostMatcher`` (one process) on 4 cells of the card: the
    plan mesh, or where the plan tables refuse, the turbo mesh
    (``DistributedMatcher``)."""
    from phfpfac_tpu_torch.parallel.distributed import MultiHostMatcher

    mh = MultiHostMatcher(case.compiled, cfg, devices=cells(4, device))
    s.same("multihost", mh.match(case.data, input_size=s.g["input_size"]),
           want, f"engine {mh.last_engine}")


def cli_case(s: Seed, case: Case, cfg, device, want, tmp: str, tag: str):
    """The seed's files for ``cli.main`` (the pattern file escaped,
    ``--escapes``; class patterns with ``--charset``; the input file the
    corpus head plus the byte the CLI drops), the arguments after the
    pattern file, and the oracle's matches as the CLI renders them under
    its own cut (4,096 + 512 B, or ``--exact``)."""
    from phfpfac_tpu_torch.parallel.merge import render_result_file
    from phfpfac_tpu_torch.utils.config import PfacConfig

    n = min(s.g["input_size"], CLI_BYTES)
    name = f"fuzz{s.seed}{tag}"
    pat_file, in_file = cs.write_inputs(tmp, name, case.lines,
                                        case.data[:n], not case.charset)
    exact = cfg.truncation != "segment"
    ccfg = PfacConfig(width=cfg.width, num_shards=cfg.num_shards,
                      truncation="none" if exact else "segment")
    args = ["1", str(cfg.width), in_file, "--quiet",
            "--num-shards", str(cfg.num_shards),
            "--device", torch.device(device).type,
            "--charset" if case.charset else "--escapes",
            *(["--exact"] if exact else [])]
    if ccfg == cfg:
        exp = within(case, want, 0, n)
    else:
        exp = oracle(case, case.data[:n], ccfg)
    return pat_file, args, exp, render_result_file(exp)


def same_file(s: Seed, route: str, out: str, exp, text: str,
              what: str) -> None:
    """One check: the result file ``out`` is ``text``, the oracle's."""
    with open(out) as f:
        ok = f.read() == text
    s.check(route, ok, what,
            None if ok else first_difference(cs.read_output(out), exp))


def route_cli(s: Seed, case: Case, cfg, device, want, tmp: str) -> None:
    """``cli.main`` on files the seed writes; its result file must be the
    oracle's matches as the CLI renders them (``cli_case``)."""
    from phfpfac_tpu_torch import cli

    pat_file, args, exp, text = cli_case(s, case, cfg, device, want, tmp,
                                         "")
    out = os.path.join(tmp, f"fuzz{s.seed}.out")
    cli.main([pat_file, *args, "-o", out])
    same_file(s, "cli", out, exp, text,
              "GPU_match_result.txt differs from the oracle's")


def route_tables(s: Seed, case: Case, cfg, device, want, tmp: str) -> None:
    """``cli.main`` with ``--save-tables`` (saved again with the plan
    tables its scan built), then with ``--load-tables`` and a pattern
    file that does not exist, so that a read of it fails: both result
    files must be the oracle's (``cli_case``)."""
    from phfpfac_tpu_torch import cli

    pat_file, args, exp, text = cli_case(s, case, cfg, device, want, tmp,
                                         "t")
    npz = os.path.join(tmp, f"fuzz{s.seed}.npz")
    outs = [os.path.join(tmp, f"fuzz{s.seed}.{k}.out")
            for k in ("save", "load")]
    cli.main([pat_file, *args, "-o", outs[0], "--save-tables", npz])
    same_file(s, "tables", outs[0], exp, text,
              "--save-tables: the result file differs from the oracle's")
    cli.main([os.path.join(tmp, "no-such-pattern-file"), *args, "-o",
              outs[1], "--load-tables", npz])
    same_file(s, "tables", outs[1], exp, text,
              "--load-tables: the result file differs from the oracle's")


def launch_counts() -> dict:
    from phfpfac_tpu_torch.ops import depth as K2
    from phfpfac_tpu_torch.ops import pair as K3
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops import scan as K4

    return dict(plan_scan=K1.launches, depth_scan=K2.launches,
                pair_scan=K3.launches, phf_scan=K4.launches,
                phf_scan_multi=K4.launches_multi,
                plan_scan_compact_a=K1.launches_compact_a,
                planb_scan=K1.launches_compact_b)


def engines_of(m) -> list:
    """The scanner each shard took in ``m`` (or the whole dictionary's)."""
    kind, sc = m._get_pallas_scanner()
    if kind != "depth":
        return [kind]
    return ["turbo" if e is None else "split" if isinstance(e, tuple)
            else type(e).__name__ for e in sc]


def run_seed(seed: int, arm: str, device, tmp: str,
             max_bytes: int = MAX_BYTES) -> Seed:
    """Every route for one seed; -> its record."""
    from phfpfac_tpu_torch.parallel.matcher import Matcher

    g = draw_geometry(seed, arm, max_bytes)
    s = Seed(seed, arm, g)
    cfg = config_of(g)
    case = make_case(g["source"], seed, cfg, g["corpus_bytes"], tmp)
    want = oracle(case, case.data[:g["input_size"]], cfg)
    g.update(patterns=len(case.pats), max_pat_len=case.compiled.max_pat_len,
             oracle_rows=len(want),
             feeds_below_max_pat_len=sum(
                 f < case.compiled.max_pat_len for f in g["feeds"]))
    m = Matcher(case.compiled, cfg, device=device, train=training(s, case))
    with scanners(g["scanners"]):
        for route, fn, a in (
                ("match", route_match, (s, case, m, want)),
                ("match_chunked", route_chunked, (s, case, m, want)),
                ("stream", route_stream, (s, case, cfg, device, want)),
                ("match_many", route_many, (s, case, m, want)),
                ("count_matches", route_count, (s, case, cfg, m, want)),
                ("plan_mesh", route_plan_mesh, (s, case, cfg, device, want)),
                ("pallas_mesh", route_pallas_mesh,
                 (s, case, cfg, device, want)),
                ("multihost", route_multihost, (s, case, cfg, device, want)),
                ("cli", route_cli, (s, case, cfg, device, want, tmp)),
                ("tables", route_tables,
                 (s, case, cfg, device, want, tmp))):
            s.run(route, fn, *a)
        g["engines"] = engines_of(m)
    return s


def scanners(how: str):
    """A context in which ``Matcher`` picks its kernels as ``how`` says
    (``SCANNERS``): the plan scanner's constructor refuses every shard,
    or ``Matcher._shard_scanner_one`` offers none (the mesh matchers
    build their own tables and are not touched)."""
    from phfpfac_tpu_torch.compile.depth import DepthUnsupported
    from phfpfac_tpu_torch.parallel import matcher

    class Withheld(matcher.PlanShardScanner):
        """A plan scanner that refuses every shard (a class, so that
        ``Matcher.built_plan_tables``'s ``isinstance`` still works)."""

        def __init__(self, *_a, **_kw):
            raise DepthUnsupported("the plan scanner is withheld by the soak")

    if how == "no_plan":
        return cs.swapped(matcher, "PlanShardScanner", Withheld)
    if how == "multi":
        return cs.swapped(matcher.Matcher, "_shard_scanner_one",
                          lambda *_a, **_kw: None)
    return contextlib.nullcontext()


# ---- the large-corpus arm ---------------------------------------------------

def run_large(seed: int, arm: str, device, tmp: str, size: int,
              chunk: int = LARGE_CHUNK) -> Seed:
    """``match_chunked`` at ``chunk`` over ``size`` bytes less a ragged
    end, patterns planted across every chunk boundary and the end,
    against the turbo engine over the whole corpus and the oracle on a
    ``LARGE_WINDOW`` around every boundary and the end."""
    from phfpfac_tpu_torch.parallel.matcher import Matcher

    g = draw_geometry(seed, arm)
    rng = np.random.default_rng([seed, 99])
    if g["truncation"] == "segment" and g["segment_bytes"] & (
            g["segment_bytes"] - 1):
        g["segment_bytes"] = 4096  # chunks start on segment boundaries
    g.update(corpus_bytes=size, input_size=size - int(rng.integers(1, 4096)),
             chunk_bytes=chunk)
    s = Seed(seed, arm, g)
    cfg = config_of(g)
    case = make_case(g["source"], seed, cfg, size, tmp)
    n = g["input_size"]
    m = Matcher(case.compiled, cfg, device=device, train=training(s, case))
    overlap = m._chunk_geometry(chunk)[1]
    buf = bytearray(case.data)

    def draw() -> bytes:
        if not case.charset:
            return case.lines[int(rng.integers(0, len(case.lines)))]
        cp = case.pats[int(rng.integers(0, len(case.pats)))]
        return bytes(int(rng.choice(sorted(c))) for c in cp.classes)

    ends = list(range(chunk, n, chunk)) + [n]
    for b in ends:
        p1, p2, p3 = draw(), draw(), draw()
        at = b - len(p1) // 2
        # ending at the next chunk's window end; ending where the one
        # across the boundary (or input_size) starts; that one last
        places = [(b + overlap - len(p3), p3)] if b < n else []
        for a, p in places + [(at - len(p2), p2), (at, p1)]:
            a = min(max(a, 0), len(buf) - len(p))
            buf[a:a + len(p)] = p
    case.data = bytes(buf)
    g.update(patterns=len(case.pats), max_pat_len=case.compiled.max_pat_len,
             boundaries=len(ends) - 1, overlap=overlap)
    got = rows(m.match_chunked(case.data, input_size=n, chunk_bytes=chunk))
    g["engines"] = engines_of(m)
    turbo = Matcher(case.compiled, cfg, engine="turbo", device=device)
    s.same("large_turbo", got, turbo.match(case.data, input_size=n),
           "match_chunked != the turbo engine")
    seg = cfg.segment_bytes if cfg.truncation == "segment" else 1
    for b in ends:  # a window's matches are the corpus's that end in it
        lo = max(b - LARGE_WINDOW // 2, 0) // seg * seg
        hi = min(lo + LARGE_WINDOW, n)
        s.same("large_oracle", within(case, got, lo, hi),
               oracle(case, case.data[lo:hi], cfg),
               f"window [{lo}, {hi}) around {b}")
    return s


# ---- main ----------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=15)
    ap.add_argument("--start", type=int, default=100)
    ap.add_argument("--segment", action="store_true",
                    help="the segment + halo cut at random geometries")
    ap.add_argument("--charset", action="store_true",
                    help="random class dictionaries")
    ap.add_argument("--mib", type=int, default=0,
                    help="the large-corpus arm on N MiB (0 = off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    arm = "charset" if args.charset else "segment" if args.segment \
        else "exact"
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("chip_fuzz: no CUDA device", file=sys.stderr)
        return 1
    if device.type == "cuda":
        from phfpfac_tpu_torch import _build

        print(cs.nvidia_smi(), flush=True)
        _build.build_all()
    t0 = time.perf_counter()
    names = LARGE_ROUTES if args.mib else ROUTES
    checks = dict.fromkeys(names, 0)
    refused = dict.fromkeys(names, 0)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in range(args.start, args.start + args.seeds):
            t1 = time.perf_counter()
            before = launch_counts()
            if args.mib:
                s = run_large(seed, arm, device, tmp, args.mib * MIB)
            else:
                s = run_seed(seed, arm, device, tmp, MAX_BYTES)
            after = launch_counts()
            for k, v in s.checks.items():
                checks[k] += v
            for k, v in s.refused.items():
                refused[k] += len(v)
            failures += s.failures
            print(json.dumps(dict(
                seed=seed, arm=arm, geometry=s.g, checks=s.checks,
                refused=s.refused, failed=[f["route"] for f in s.failures],
                failures=s.failures,
                launches={k: after[k] - before[k] for k in after
                          if after[k] > before[k]},
                seconds=time.perf_counter() - t1)), flush=True)
    unreached = [k for k in names if not checks[k] and not refused[k]]
    ok = not failures and not unreached
    print(json.dumps(dict(
        summary=True, arm=arm, mib=args.mib, seeds=args.seeds,
        start=args.start, device=str(device),
        card=torch.cuda.get_device_name(device) if device.type == "cuda"
        else None, checks=checks, total_checks=sum(checks.values()),
        refused=refused, failed_checks=len(failures),
        failed_routes=sorted({f["route"] for f in failures}),
        unreached_routes=unreached, ok=ok,
        seconds=time.perf_counter() - t0)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
