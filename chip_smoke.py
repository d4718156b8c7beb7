"""Chip smoke test of the PyTorch/CUDA port (phfpfac_tpu_torch).

Run on a machine with one CUDA GPU, from the repository root:

    python3 chip_smoke.py [--seed 0] [--mib 64] [--soak]

It builds the CUDA kernels from ``phfpfac_tpu_torch/csrc``, holds each
against its plain torch version on the card, drives the gphf CLI main
path (``phfpfac_tpu_torch.cli.main``) over two dictionaries at the size
users run, its match phase a stage at a time (``chip_e2e.py``'s
``stages`` arm, once), a word regime (``words_phase``: ``chip_e2e.py``'s
``big``, 156,000 titles in one shard over 8 MiB of English-like text),
then the paths of the other kernels and engines
(the depth path, the exact-mode pair path, the banked-PHF path, ``--engine
turbo|jnp``, the count scanners), then the two-phase compacted plan scan
through ``Matcher.match_chunked`` on both dictionaries, the
device-resident chunk loop, ``StreamMatcher`` / ``match_many``, the
CLI's ``--save-tables`` / ``--load-tables`` and ``--charset``; then the
two probe kernels (parity and their sweeps), the device mesh with four
cells on the one card (plan, compacted plan, turbo and depth meshes),
two cooperating CLI processes over gloo, ``--profile`` and the
multi-device dry run; then a soak of random dictionaries through the
scan kernels and through every route of ``chip_fuzz.py`` at drawn
geometries (``soak_phase``; ``--soak`` runs it alone); checks every
output, times the kernels and prints one JSON line per phase.  The last line is
``{"ok": true, "device": {...}}``; any failed check raises and exits
non-zero.  Without a GPU, or without the package beside it, it exits
non-zero and prints no result.

Inputs are generated from ``--seed`` with numpy in a temporary
directory:

* ascii50k: 50,000 distinct printable-ASCII patterns of 4-32 B with
  shared prefixes, plus 3 patterns of 40-64 B (the long-tail split and
  its host literal search), over printable text;
* clamav5k: 5,000 binary signatures of 8-32 B (sigma 256: the s0x
  prologue and split steps), written as \\xNN escapes, over random bytes.

* lower50k: 50,000 distinct patterns of 4-32 B over ``a-z0-9`` (36
  symbols, which build_pair_tables takes; ascii50k's 95 it
  refuses), over text of the same alphabet, scanned in exact mode.

* class5k: 5,000 of lower50k's patterns with one byte widened to a
  ``[...]`` class of 2-10 members, plus 50 second spellings of the first
  50 (multi-output finals), over 16 MiB of ``a-z0-9`` (``--charset``).

All run with streamnum 1 (4 shards) and width 4096; each corpus holds
100,000 planted dictionary patterns (the 16 MiB ones: 25,000).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from phfpfac_tpu_torch.utils.profile import cuda_ms  # noqa: E402

DEVICE = "cuda"
MIB = 1 << 20
CHUNK = 16 * MIB  # the CLI's match_chunked window
FEED = MIB  # bytes per StreamMatcher feed
SEG, HALO = 4096, 512  # the CLI's default segment cut
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PLANTS = 100_000
CHAIN_K = 8
JNP_MIB = 4  # --engine jnp keeps [positions, 32] int32 rows: 128 B/position
NO_LIBRARY = ("no single PyTorch call computes the automaton walk "
              "(a data-dependent chain of table gathers)")


def device_ms(fn, name: str, reps: int = 5, tries: int = 3):
    """Mean device time in ms of the kernels whose name holds ``name``
    that ``fn`` launches: a ``torch.profiler`` trace of ``reps`` calls
    after a warm-up, traced again (up to ``tries`` times) where a trace
    shows no device time for them, which happens in a long process; None
    if none does.  Beside ``cuda_ms``, which keeps the wrappers' host
    work inside the time.  (``plan_times.py`` keeps a copy, to time
    checkouts made before it.)"""
    from phfpfac_tpu_torch.utils.profile import trace

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with trace() as mt:
            for _ in range(reps):
                fn()
        secs = sum(v for k, v in mt.device_seconds_by_name().items()
                   if name in k)
        if secs:
            return 1e3 * secs / reps
    return None


def plus(a, b):
    """a + b, where None (not measured) stays None."""
    return None if a is None or b is None else a + b


def check(ok, what: str) -> None:
    """A failed check ends the run (not ``assert``: it must survive -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# kernel vs plain, this run
MAX_ERR = {"plan_scan": 0, "depth_scan": 0, "pair_scan": 0, "phf_scan": 0,
           "phf_scan_multi": 0, "plan_scan_compact_a": 0, "planb_scan": 0,
           "probe_gather": 0, "probe_compact": 0}


def agree(kernel: str, got, want, what: str) -> None:
    """Hold a kernel's int32 outputs to its plain version's (exact):
    records the largest absolute difference, fails on any."""
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              if g.numel() else 0 for g, w in zip(got, want))
    MAX_ERR[kernel] = max(MAX_ERR[kernel], err)
    check(err == 0, f"{what}: kernel != plain (max abs err {err})")


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line for a phase, with the script's seconds so far."""
    print(json.dumps({"phase": phase, **kw,
                      "at_seconds": time.perf_counter() - T_START}),
          flush=True)


# ---- inputs ------------------------------------------------------------------

LOWER = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)


def make_stem_patterns(rng, alphabet, count=50_000, n_long=0) -> list[bytes]:
    """``count`` distinct patterns of 4-32 B over ``alphabet`` grown
    from 5,000 shared stems, plus ``n_long`` patterns of 40-64 B."""
    stems = [bytes(rng.choice(alphabet, int(rng.integers(3, 11))))
             for _ in range(5000)]
    pats: dict[bytes, None] = {}
    while len(pats) < count:
        stem = stems[int(rng.integers(0, len(stems)))]
        n = int(rng.integers(max(4 - len(stem), 1), 33 - len(stem)))
        pats[stem + bytes(rng.choice(alphabet, n))] = None
    out = list(pats)
    for _ in range(n_long):
        out.append(bytes(rng.choice(alphabet, int(rng.integers(40, 65)))))
    return out


def make_ascii50k(rng) -> list[bytes]:
    """50,000 printable-ASCII patterns of 4-32 B plus 3 of 40-64 B."""
    return make_stem_patterns(rng, np.arange(32, 127, dtype=np.uint8),
                              n_long=3)


def make_signatures(n_sigs: int, seed: int = 7) -> list[bytes]:
    """ClamAV-style byte signatures: 8-32 random bytes each (the same
    generator as bench/binary.py)."""
    rng = np.random.default_rng(seed)
    sigs = set()
    while len(sigs) < n_sigs:
        ln = int(rng.integers(8, 33))
        sigs.add(bytes(rng.integers(0, 256, ln, dtype=np.uint8)))
    return sorted(sigs)


def make_corpus(rng, pats, size, alphabet=None, plants=None, base=None):
    """``size`` bytes (random over ``alphabet``, or ``base``'s) with
    ``plants`` (default PLANTS) dictionary patterns at known places;
    returns (corpus, planted (pos, 1-based id) pairs)."""
    plants = plants or PLANTS
    if base is not None:
        buf = np.frombuffer(base, np.uint8)[:size].copy()
    elif alphabet is None:
        buf = rng.integers(0, 256, size, dtype=np.uint8)
    else:
        buf = rng.choice(alphabet, size)
    slot = size // plants
    ids = rng.integers(0, len(pats), plants)
    ids[: min(3, plants)] = np.arange(len(pats) - 3, len(pats))  # long ones
    planted = []
    for k, i in enumerate(ids):
        p = pats[int(i)]
        pos = k * slot + int(rng.integers(0, slot - len(p)))
        buf[pos: pos + len(p)] = np.frombuffer(p, np.uint8)
        planted.append((pos, int(i) + 1))
    return buf.tobytes(), planted


# The word-dictionary regimes (``bench.py``'s english, big, full, random):
# word-like strings from one letter chain (letters at English frequencies,
# mostly alternating vowels and consonants), so that the dictionaries share
# prefixes as real ones do and the text holds their words.
LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
LETTER_FREQ = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3,
                        4.0, 2.8, 2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0,
                        0.8, 0.15, 0.15, 0.1, 0.07]) / 100.35
SUFFIXES = (b"s", b"ed", b"ing", b"er", b"ly", b"es", b"ers", b"ness",
            b"tion", b"al", b"ment")
SUFFIX_P = np.array([30, 14, 14, 8, 6, 6, 3, 3, 3, 3, 2]) / 92
TITLE_FORMS = (b"s", b"es", b"er", b"ers", b"ing", b"ed", b" 2", b" 3",
               b" II", b" I")
TITLE_QUALIFIERS = (b" (film)", b" (band)", b" (album)", b" River",
                    b" County", b" (disambiguation)")
FULL_TITLES = 466_543  # the short lowercase titles spread over this many


def letter_chain(seed: int = 12345) -> np.ndarray:
    """Cumulative next-letter probabilities, [27, 26] (row 26: a word's
    first letter), over ``LETTERS``: English letter frequencies times a
    fixed random preference per letter, vowel after vowel and consonant
    after consonant four times less likely."""
    r = np.random.default_rng(seed)
    vowel = np.isin(LETTERS, np.frombuffer(b"aeiouy", np.uint8))
    t = np.empty((27, 26))
    for i in range(27):
        w = LETTER_FREQ * r.dirichlet(np.full(26, 0.3)) ** 0.5
        if i < 26:
            w = w * np.where(vowel == vowel[i], 0.25, 1.0)
        t[i] = w / w.sum()
    return np.cumsum(t, 1)


def chain_words(rng, lengths, cdf) -> list[bytes]:
    """One word from the letter chain ``cdf`` per entry of ``lengths``."""
    n, m = len(lengths), int(max(lengths, default=0))
    cur, out = np.full(n, 26), np.empty((n, m), np.uint8)
    for j in range(m):
        u = rng.random(n)
        cur = np.minimum((cdf[cur] < u[:, None]).sum(1), 25)
        out[:, j] = LETTERS[cur]
    return [row[:k].tobytes() for row, k in zip(out, lengths.tolist())]


def word_lengths(rng, n: int) -> np.ndarray:
    """Stem lengths: 3 + Poisson(4.5) up to 12, one in a hundred 2."""
    lengths = np.minimum(3 + rng.poisson(4.5, n), 12)
    lengths[rng.random(n) < 0.01] = 2
    return lengths


def capital(w: bytes) -> bytes:
    return w[:1].upper() + w[1:]


def make_english_words(rng, count: int = 7_977) -> list[bytes]:
    """``count`` distinct lowercase words (``bench.py``'s english has
    7,977): "a", "i", then stems from the letter chain, each with a
    Poisson(1.8) number of its inflections (-s, -ed, -ing, ...)."""
    cdf = letter_chain()
    words = dict.fromkeys([b"a", b"i"])
    while len(words) < count:
        stems = chain_words(rng, word_lengths(rng, count), cdf)
        forms = rng.poisson(1.8, count)
        for stem, k in zip(stems, forms.tolist()):
            words[stem] = None
            for j in rng.choice(len(SUFFIXES), size=min(k, 4), replace=False,
                                p=SUFFIX_P):
                words[stem + SUFFIXES[j]] = None
            if len(words) >= count:
                break
    return list(words)[:count]


def short_titles(cdf) -> list[bytes]:
    """The one- and two-letter lowercase titles: every letter and the
    10 likeliest two-letter strings of the chain, ordered so that any
    prefix of the list holds about its share of their weight (a letter's
    frequency; a pair's, times the chain's next-letter probability)."""
    step = np.diff(cdf, prepend=0.0, axis=1)
    weight = {bytes([c]): f for c, f in zip(LETTERS.tolist(), LETTER_FREQ)}
    pairs = {bytes([a, b]): LETTER_FREQ[i] * step[i, j]
             for i, a in enumerate(LETTERS.tolist())
             for j, b in enumerate(LETTERS.tolist())}
    for p in sorted(pairs, key=lambda p: -pairs[p])[:10]:
        weight[p] = pairs[p]
    left = sorted(weight, key=lambda w: -weight[w])
    total, have, out = sum(weight.values()), 0.0, []
    while left:  # greedily, the one that keeps the running sum on the line
        goal = total * (len(out) + 1) / len(weight)
        best = min(left, key=lambda w: abs(have + weight[w] - goal))
        left.remove(best)
        out.append(best)
        have += weight[best]
    return out


def make_titles(rng, count: int, n_long: int = 3) -> list[bytes]:
    """``count`` distinct title-like patterns of at most 32 B, then
    ``n_long`` of 33-64 B (the long-pattern split; ``bench.py``'s full
    has one).  Titles come in families from one head word of the letter
    chain (capitalized, or lowercase one time in three where it has 6
    letters or more, as shorter ones would match text often): the head, some
    of its forms (``TITLE_FORMS``), sometimes the head and a second word
    from a shared pool of 2,000, or a qualifier, as a title list's
    entries share their prefixes.  The one- and two-letter lowercase
    titles (``short_titles``) arrive one per ``FULL_TITLES // 36``
    titles, so a list's share of them, and its matches a byte of text,
    grow with its length; the first ``count`` of a longer list are this
    list."""
    cdf = letter_chain()
    short = short_titles(cdf)
    every = FULL_TITLES // len(short)
    pool = [capital(w) for w in chain_words(rng, word_lengths(rng, 2000),
                                            cdf)]
    pool_p = 1.0 / (np.arange(1, len(pool) + 1) + 2.7)
    pool_p /= pool_p.sum()
    out: dict[bytes, None] = {}
    want = count - n_long
    while len(out) < want:
        n = 10_000  # a round's draws, whatever ``count`` is
        lengths = word_lengths(rng, n)
        heads = chain_words(rng, lengths, cdf)
        lower = (rng.random(n) < 1 / 3) & (lengths >= 6)
        forms = rng.poisson(3.0, n)
        extra = rng.random(n)
        second = rng.choice(len(pool), n, p=pool_p)
        qual = rng.integers(0, len(TITLE_QUALIFIERS), n)
        for i, h in enumerate(heads):
            head = h if lower[i] else capital(h)
            family = [head] + [head + TITLE_FORMS[j] for j in rng.choice(
                len(TITLE_FORMS), size=min(int(forms[i]), 6), replace=False)]
            if extra[i] < 0.3:
                family.append(head + b" " + pool[second[i]])
            elif extra[i] < 0.4:
                family.append(head + TITLE_QUALIFIERS[qual[i]])
            for t in family:
                if len(out) >= want:
                    break
                k = len(out) // every
                if len(out) % every == every - 1 and k < len(short) and \
                        short[k] not in out:
                    out[short[k]] = None
                elif len(t) <= 32:
                    out[t] = None
    long = []
    while len(long) < n_long:
        t = b" ".join(pool[int(j)] for j in rng.integers(0, len(pool), 8))
        if 33 <= len(t) <= 64 and t not in out:
            long.append(t)
    return list(out)[:want] + long


def make_english_text(rng, words, size: int) -> bytes:
    """``size`` bytes of text over ``words`` at Zipf frequencies (rank
    by length with noise: frequent words are short), words separated by
    spaces, one in 14 by a newline, one in 14 ending a sentence with a
    period and the next word capitalized."""
    lengths = np.array([len(w) for w in words])
    rank = np.empty(len(words), np.int64)
    rank[np.argsort(lengths + rng.exponential(2.0, len(words)),
                    kind="stable")] = np.arange(len(words))
    p = 1.0 / (rank + 3.7)
    p /= p.sum()
    flat = np.frombuffer(b"".join(words), np.uint8)
    start = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    out, have = [], 0
    while have < size:
        idx = rng.choice(len(words), size=200_000, p=p)
        span = lengths[idx] + 1  # the word and its separator
        total = int(span.sum())
        first = np.cumsum(span) - span
        at = np.arange(total) - np.repeat(first, span)
        end = at == np.repeat(span - 1, span)
        buf = flat[np.minimum(np.repeat(start[idx], span) + at,
                              len(flat) - 1)].copy()
        buf[end] = ord(" ")
        ends = np.flatnonzero(end)
        r = rng.random(len(ends))
        buf[ends[r < 1 / 14]] = ord("\n")
        stop = ends[(r >= 1 / 14) & (r < 2 / 14)]
        buf[stop] = ord(".")
        nxt = stop[stop + 1 < total] + 1
        buf[nxt] = np.where((buf[nxt] >= 97) & (buf[nxt] <= 122),
                            buf[nxt] - 32, buf[nxt])
        out.append(buf.tobytes())
        have += total
    return b"".join(out)[:size]


def write_inputs(tmp, name, pats, corpus, escapes):
    pat_file = os.path.join(tmp, f"{name}.pat")
    with open(pat_file, "wb") as f:
        for p in pats:
            f.write("".join(f"\\x{b:02x}" for b in p).encode()
                    if escapes else p)
            f.write(b"\n")
    in_file = os.path.join(tmp, f"{name}.in")
    with open(in_file, "wb") as f:
        f.write(corpus + b"\n")  # the CLI scans filesize - 1 bytes
    return pat_file, in_file


_LINE = re.compile(rb"At position +(\d+), match pattern (\d+)")


def read_output(path) -> np.ndarray:
    with open(path, "rb") as f:
        return np.asarray(_LINE.findall(f.read()), np.int64).reshape(-1, 2)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---- bounds ------------------------------------------------------------------

def bound_ms(n_pos: int, table_bytes: int, bitmap: bool, *,
             read_b: int = 4, bitmap_rows: int = 1) -> float:
    """Least time for the bytes the scan must move: ``read_b`` bytes of
    input read per position (4 B of staged stream, or 1 B of raw
    corpus), the tables read once, and (bitmap mode) 4 B of counts plus
    4 B of bitmap per bitmap row written per position."""
    per_pos = read_b + (4 + 4 * bitmap_rows if bitmap else 0)
    return (per_pos * n_pos + table_bytes) / HBM_BYTES_PER_S * 1e3


def table_bytes(tables) -> int:
    return sum(x.numel() * x.element_size() for x in vars(tables).values()
               if isinstance(x, torch.Tensor))


# ---- phases ------------------------------------------------------------------

def shard_kernels(matcher):
    """Per shard of the main path: (kind, bitmap scanner); a split
    shard's scanner is its short part's."""
    return [
        ("split", e[1][1]) if isinstance(e, tuple)  # long-pattern split
        else (type(e).__name__, e)
        for e in matcher._get_scanners()
    ]


def scan_inputs(scanner, window: bytes, device):
    """(staged stream, input_size) of one window for ``scanner``."""
    from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
    from phfpfac_tpu_torch.ops.staging import to_device_bytes

    ms = padded_steps(scanner.shard.max_pat_len)
    data = to_device_bytes(pad_input(window, 1024, ms), device)
    return scanner.stage(data, len(window), ms), len(window)


def kernel_parity(name, kinds, window, device):
    """K1 against its plain version on the card, on every shard the
    main path gives it; returns per-shard records for the later phases."""
    from phfpfac_tpu_torch.ops import plan as K1

    recs = []
    for si, (_kind, sc) in enumerate(kinds):
        staged, n = scan_inputs(sc, window, device)
        rec = dict(shard=si, scanner=sc, staged=staged, n=n)
        if isinstance(sc, K1.PlanShardScanner):
            t = sc.tables
            for seg in (SEG, 0):
                got = K1.plan_scan(staged, t, seg_bytes=seg, halo_bytes=HALO)
                want = K1.plan_scan_plain(staged, t, seg_bytes=seg,
                                          halo_bytes=HALO)
                agree("plan_scan", got, want,
                      f"{name} shard {si}: plan bitmap (seg={seg})")
                if seg:
                    rec["plan_bits"] = got[1]
                    rec["matches"] = int(got[0][:n].sum())
            agree("plan_scan", [K1.plan_scan(staged, t, emit="count")],
                  [K1.plan_scan_plain(staged, t, emit="count")],
                  f"{name} shard {si}: plan count")
        recs.append(rec)
    return recs


def depth_parity(name, compiled, recs, window, device):
    """K2 on every shard, held to its plain version and to K1's bitmap."""
    from phfpfac_tpu_torch.ops import depth as K2

    out = []
    for rec, sh in zip(recs, compiled.shards):
        ds = K2.DepthShardScanner(sh, device=device)
        staged, n = scan_inputs(ds, window, device)
        t = ds.tables
        got = K2.depth_scan(staged, t, input_size=n, seg_bytes=SEG,
                            halo_bytes=HALO)
        want = K2.depth_scan_plain(staged, t, input_size=n, seg_bytes=SEG,
                                   halo_bytes=HALO)
        agree("depth_scan", got, want,
              f"{name} shard {rec['shard']}: depth bitmap")
        check(torch.equal(got[1][:n], rec["plan_bits"][:n]),
              f"{name} shard {rec['shard']}: depth bitmap != plan bitmap")
        agree("depth_scan",
              [K2.depth_scan(staged, t, input_size=n, emit="count")],
              [K2.depth_scan_plain(staged, t, input_size=n, emit="count")],
              f"{name} shard {rec['shard']}: depth count")
        out.append(dict(shard=rec["shard"], scanner=ds, staged=staged, n=n))
    return out


def plain_match_count(kinds, matcher, corpus, input_size, device):
    """Output lines the main path must write: per shard, the popcount of
    the plain version's segment-cut bitmap over the whole corpus, plus
    the host literal matches of a split shard's long tail."""
    from phfpfac_tpu_torch.ops import depth as K2
    from phfpfac_tpu_torch.ops import plan as K1

    total = 0
    for (kind, sc), entry in zip(kinds, matcher._get_scanners()):
        staged, _ = scan_inputs(sc, corpus[:input_size], device)
        if isinstance(sc, K1.PlanShardScanner):
            cnt, _bits = K1.plan_scan_plain(staged, sc.tables, seg_bytes=SEG,
                                            halo_bytes=HALO)
        else:
            cnt, _bits = K2.depth_scan_plain(staged, sc.tables,
                                             input_size=input_size,
                                             seg_bytes=SEG, halo_bytes=HALO)
        total += int(cnt[:input_size].sum())
        del staged, cnt, _bits
        if kind == "split":
            total += len(matcher._host_literal_one(corpus, input_size,
                                                   entry[1][4][1]))
    return total


def profile_match(matcher, corpus, input_size) -> dict:
    """Where one match phase's time goes: a torch.profiler trace of
    ``match_chunked`` (the tracer behind the CLI's ``--profile``); device
    busy time by kernel name over the wall time (None where the trace
    shows no device time)."""
    from phfpfac_tpu_torch.utils.profile import trace

    with trace(device=DEVICE) as mt:
        matcher.match_chunked(corpus, input_size=input_size)
    return mt.summary()


def run_cli(args):
    from phfpfac_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    check(cli_main([str(a) for a in args] + ["--device", DEVICE]) == 0,
          "the CLI exited non-zero")
    return time.perf_counter() - t0


def time_kernels(recs, depth_recs):
    """Per 16 MiB chunk (summed over the 4 shards): kernel and plain
    times, bitmap mode with the segment cut and count mode, and k=8
    chained count scans."""
    from phfpfac_tpu_torch.ops import depth as K2
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.staging import TILE

    def per_chunk(items, kernel, plain, extra):
        r = dict(ms=0.0, plain_ms=0.0, count_ms=0.0, count_plain_ms=0.0,
                 chain_ms_per_scan=0.0, bound_ms=0.0, count_bound_ms=0.0,
                 n_pos=0)
        for it in items:
            st, t = it["staged"], it["scanner"].tables
            kw = extra(it)
            n_pos = st.numel() - TILE
            tb = table_bytes(t)
            r["ms"] += cuda_ms(lambda: kernel(st, t, seg_bytes=SEG,
                                              halo_bytes=HALO, **kw))
            r["plain_ms"] += cuda_ms(lambda: plain(st, t, seg_bytes=SEG,
                                                   halo_bytes=HALO, **kw),
                                     reps=2)
            r["count_ms"] += cuda_ms(lambda: kernel(st, t, emit="count",
                                                    **kw))
            r["count_plain_ms"] += cuda_ms(
                lambda: plain(st, t, emit="count", **kw), reps=2)

            def chain():
                prev = None
                for _ in range(CHAIN_K):
                    prev = kernel(st, t, emit="count", prev_total=prev, **kw)
                return prev

            r["chain_ms_per_scan"] += cuda_ms(chain) / CHAIN_K
            r["bound_ms"] += bound_ms(n_pos, tb, True)
            r["count_bound_ms"] += bound_ms(n_pos, tb, False)
            r["n_pos"] += n_pos
        return r

    plan_items = [r for r in recs
                  if isinstance(r["scanner"], K1.PlanShardScanner)]
    k1 = per_chunk(plan_items, K1.plan_scan, K1.plan_scan_plain,
                   lambda it: {})
    k2 = per_chunk(depth_recs, K2.depth_scan, K2.depth_scan_plain,
                   lambda it: {"input_size": it["n"]})
    return k1, k2


def padded_window(window: bytes, max_steps: int, device):
    from phfpfac_tpu_torch.ops.common import pad_input
    from phfpfac_tpu_torch.ops.staging import to_device_bytes

    return to_device_bytes(pad_input(window, 1024, max_steps), device)


def pair_parity(name, scanners, window, device):
    """K3 against its plain version on the card (bitmap and count), on
    every shard; returns per-shard records for the later phases."""
    from phfpfac_tpu_torch.ops import pair as K3

    recs = []
    for si, sc in enumerate(scanners):
        staged, n = scan_inputs(sc, window, device)
        got = K3.pair_scan(staged, sc.tables)
        agree("pair_scan", got, K3.pair_scan_plain(staged, sc.tables),
              f"{name} shard {si}: pair bitmap")
        agree("pair_scan",
              [K3.pair_scan(staged, sc.tables, emit="count", shift=1)],
              [K3.pair_scan_plain(staged, sc.tables, emit="count", shift=1)],
              f"{name} shard {si}: pair count")
        recs.append(dict(shard=si, scanner=sc, staged=staged, n=n,
                         matches=int(got[0][:n].sum())))
    return recs


def phf_parity(name, singles, multi, window, max_steps, device):
    """K4 (per shard) and K5 (all shards) against their plain versions
    on the card; K5's bitmap rows must be K4's bitmaps."""
    from phfpfac_tpu_torch.ops import scan as K4

    data = padded_window(window, max_steps, device)
    kw = dict(input_size=len(window), max_steps=max_steps)
    seg = dict(seg_bytes=SEG, halo_bytes=HALO)
    got5 = K4.phf_scan_multi(data, multi.tables, **kw, **seg)
    agree("phf_scan_multi", got5,
          K4.phf_scan_multi_plain(data, multi.tables, **kw, **seg),
          f"{name}: multi bitmap+segment")
    agree("phf_scan_multi",
          [K4.phf_scan_multi(data, multi.tables, emit="count", **kw)],
          [K4.phf_scan_multi_plain(data, multi.tables, emit="count", **kw)],
          f"{name}: multi count")
    for si, sc in enumerate(singles):
        t = sc.tables
        for g in (seg, {}):
            got = K4.phf_scan(data, t, **kw, **g)
            agree("phf_scan", got, K4.phf_scan_plain(data, t, **kw, **g),
                  f"{name} shard {si}: phf bitmap ({g or 'exact'})")
            if g:
                check(torch.equal(got[1], got5[1][si]),
                      f"{name} shard {si}: K5's row != K4's bitmap")
        agree("phf_scan", [K4.phf_scan(data, t, emit="count", **kw)],
              [K4.phf_scan_plain(data, t, emit="count", **kw)],
              f"{name} shard {si}: phf count")
    return data


@contextlib.contextmanager
def swapped(owner, name, value):
    """``owner.name`` set to ``value`` inside the block, then restored."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def time_new_kernels(pair_recs, singles, multi, data, n, max_steps):
    """Per 16 MiB chunk: K3 and K4 summed over the 4 shards, K5 one
    launch; kernel and plain times in bitmap and count mode, and the
    bytes bound."""
    from phfpfac_tpu_torch.ops import pair as K3
    from phfpfac_tpu_torch.ops import scan as K4
    from phfpfac_tpu_torch.ops.staging import TILE

    def blank():
        return dict(ms=0.0, plain_ms=0.0, count_ms=0.0, count_plain_ms=0.0,
                    bound_ms=0.0, count_bound_ms=0.0, n_pos=0)

    k3 = blank()
    for it in pair_recs:
        st, t = it["staged"], it["scanner"].tables
        n_pos = st.numel() - TILE
        k3["ms"] += cuda_ms(lambda: K3.pair_scan(st, t))
        k3["plain_ms"] += cuda_ms(lambda: K3.pair_scan_plain(st, t), reps=2)
        k3["count_ms"] += cuda_ms(lambda: K3.pair_scan(st, t, emit="count"))
        k3["count_plain_ms"] += cuda_ms(
            lambda: K3.pair_scan_plain(st, t, emit="count"), reps=2)
        k3["bound_ms"] += bound_ms(n_pos, table_bytes(t), True)
        k3["count_bound_ms"] += bound_ms(n_pos, table_bytes(t), False)
        k3["n_pos"] += n_pos
    k3["dead_exit"] = [it["scanner"].tables.dead_exit for it in pair_recs]

    kw = dict(input_size=n, max_steps=max_steps)
    seg = dict(seg_bytes=SEG, halo_bytes=HALO)
    n_pos = data.shape[0] - max_steps

    def phf(kernel, plain, t, rows):
        r = blank()
        r["ms"] = cuda_ms(lambda: kernel(data, t, **kw, **seg))
        r["plain_ms"] = cuda_ms(lambda: plain(data, t, **kw, **seg), reps=2)
        r["count_ms"] = cuda_ms(lambda: kernel(data, t, emit="count", **kw))
        r["count_plain_ms"] = cuda_ms(
            lambda: plain(data, t, emit="count", **kw), reps=2)
        r["bound_ms"] = bound_ms(n_pos, table_bytes(t), True, read_b=1,
                                 bitmap_rows=rows)
        r["count_bound_ms"] = bound_ms(n_pos, table_bytes(t), False,
                                       read_b=1)
        r["n_pos"] = n_pos
        return r

    k4 = blank()
    for sc in singles:
        one = phf(K4.phf_scan, K4.phf_scan_plain, sc.tables, 1)
        for k, v in one.items():
            k4[k] += v
    k5 = phf(K4.phf_scan_multi, K4.phf_scan_multi_plain, multi.tables,
             multi.tables.n_shards)
    return k3, k4, k5


# ---- the compacted plan scan -------------------------------------------------

@contextlib.contextmanager
def opted_in():
    """"auto" compaction engaged inside the block (it is opt-in)."""
    from phfpfac_tpu_torch.ops.plan import AUTO_OPT_IN

    old = os.environ.get(AUTO_OPT_IN)
    os.environ[AUTO_OPT_IN] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ[AUTO_OPT_IN]
        else:
            os.environ[AUTO_OPT_IN] = old


def choose_compact(pt, n_pos):
    """(how, cut, cap, why): the cut "auto" picks with the opt-in, else
    the first explicit int cut ``resolve_compact`` accepts, and why
    "auto" declined."""
    from phfpfac_tpu_torch.ops import plan as K1

    with opted_in():
        auto = K1.resolve_compact(pt, n_pos, "auto")
    if auto is not None:
        return ("auto", *auto, None)
    if not pt.trained or not pt.live_frac:
        why = "untrained tables"
    elif not any(f <= K1.COMPACT_MAX_FRAC for f in pt.live_frac[1:]):
        why = (f"no trained step at or under {K1.COMPACT_MAX_FRAC:.0%} "
               f"live (least {min(pt.live_frac[1:], default=1.0):.4f})")
    else:
        why = "cap * 2 >= n_pos"
    for cut in range(1, len(pt.steps)):
        cc = K1.resolve_compact(pt, n_pos, cut)
        if cc is not None:
            return ("explicit", *cc, why)
    return (None, 0, 0, why + "; no int cut resolves either")


def sorted_survivors(surv, cap):
    pos, disp, count = surv
    n = min(int(count), cap)
    order = torch.argsort(pos[:n])
    return [pos[:n][order], disp[:n][order], count.reshape(1)]


def compact_parity(name, d, device):
    """K1' and K6 against their plain versions on a 16 MiB window, per
    shard: at the cut "auto" picks with the opt-in (where it picks one)
    and at one explicit cut, under the segment cut and in exact mode,
    bitmap and count mode; equal also to uncompacted K1.  Then one
    forced overflow per dictionary: the scanner still gives K1's result."""
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.common import padded_steps
    from phfpfac_tpu_torch.ops.staging import TILE

    out = []
    for rec in d["recs"]:
        sc, staged = rec["scanner"], rec["staged"]
        check(isinstance(sc, K1.PlanShardScanner),
              f"{name} shard {rec['shard']}: not a plan scanner")
        t, n_pos = sc.tables, staged.numel() - TILE
        n_steps = len(t.spec)
        check(n_steps >= 2, f"{name} shard {rec['shard']}: nothing to cut")
        how, cut, cap, _why = choose_compact(sc.pt, n_pos)
        cuts = [(how, cut, cap)] if how == "auto" else []
        e_cut = 1 if not cuts or cut != 1 else 2
        e = K1.resolve_compact(sc.pt, n_pos, e_cut) or (
            e_cut, n_pos // 2 // K1.COMPACT_BLOCK * K1.COMPACT_BLOCK)
        cuts.append(("explicit", *e))
        for how, cut, cap in cuts:
            for seg in (SEG, 0):
                what = (f"{name} shard {rec['shard']}: compact {how} "
                        f"cut={cut} cap={cap} seg={seg}")
                kw = dict(cut=cut, cap=cap, seg_bytes=seg, halo_bytes=HALO)
                whole = K1.plan_scan(staged, t, seg_bytes=seg,
                                     halo_bytes=HALO)
                want, want_surv = K1.plan_scan_compact_a_plain(staged, t,
                                                               **kw)
                got, surv = K1.plan_scan_compact_a(staged, t, **kw)
                count = int(surv[2])
                check(count <= cap, f"{what}: {count} survivors overflow")
                agree("plan_scan_compact_a",
                      [*got, *sorted_survivors(surv, cap)],
                      [*want, *sorted_survivors(want_surv, cap)],
                      f"{what}: phase A")
                # K6 on the plain version's survivors, padded to cap
                pad = torch.zeros(cap - count, dtype=torch.int32,
                                  device=device)
                fed = (torch.cat([want_surv[0], pad]),
                       torch.cat([want_surv[1], pad]), want_surv[2])
                K1.planb_scan(staged, t, got, fed, **kw)
                K1.planb_scan_plain(staged, t, want, want_surv, **kw)
                agree("planb_scan", got, want, f"{what}: phase B")
                agree("planb_scan", got, whole, f"{what}: != K1")
                # the pair through its wrapper, with K1's own slot order
                pair = K1.plan_scan_compact(staged, t, **kw)
                agree("planb_scan", pair[:2], whole, f"{what}: pair != K1")
                check(int(pair[2]) == count, f"{what}: pair's count")
                del want, got, pair, fed, surv, want_surv
                total, c2 = K1.plan_scan_compact(staged, t, emit="count",
                                                 shift=1, **kw)
                ptotal, pc2 = K1.plan_scan_compact_plain(
                    staged, t, emit="count", shift=1, **kw)
                agree("planb_scan", [total, c2.reshape(1)],
                      [ptotal, pc2.reshape(1)], f"{what}: count mode")
                agree("planb_scan", [total],
                      [K1.plan_scan(staged, t, emit="count", shift=1,
                                    seg_bytes=seg, halo_bytes=HALO)],
                      f"{what}: count mode != K1")
                out.append(dict(shard=rec["shard"], how=how, cut=cut,
                                cap=cap, seg=seg, survivors=count))
                del whole
    # forced overflow: a cap of one block at step 1
    rec = d["recs"][0]
    sc = rec["scanner"]
    ms = padded_steps(sc.shard.max_pat_len)
    window = padded_window(d["corpus"][:CHUNK], ms, device)
    small = K1.PlanShardScanner(sc.shard, device=device, pt=sc.pt,
                                compact=(1, K1.COMPACT_BLOCK))
    before = K1.overflow_rescans
    _cnt, bits, verify = small.scan_async(window, rec["n"], d["cfg"], ms)
    truncated = not torch.equal(bits, rec["plan_bits"])
    _cnt, bits = verify()
    check(K1.overflow_rescans == before + 1,
          f"{name}: the forced overflow did not rescan")
    check(torch.equal(bits, rec["plan_bits"]),
          f"{name}: the overflow rescan != K1")
    return out, dict(cap=K1.COMPACT_BLOCK, rescans=1,
                     truncated_before_rescan=truncated)


def compacting_scanner(chosen: list):
    """A PlanShardScanner factory that compacts at ``choose_compact``'s
    cut for the matcher's chunk size, and records what it chose."""
    from phfpfac_tpu_torch.ops import plan as K1

    def make(shard, **kw):
        sc = K1.PlanShardScanner(shard, **kw)
        how, cut, cap, why = choose_compact(sc.pt, chosen[0])
        check(how is not None, f"no compaction cut for a shard: {why}")
        if how == "explicit":
            sc.compact = cut  # an int cut: capped as resolve_compact caps
        chosen.append(dict(how=how, cut=cut, cap=cap, auto_declined=why))
        return sc

    return make


def compact_path(name, d, device, matcher_mod):
    """This slice's path: ``Matcher.match_chunked`` over the whole corpus
    with the compacted scan engaged: "auto" under the opt-in where it
    resolves, else scanners built with an explicit int cut."""
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.common import padded_steps
    from phfpfac_tpu_torch.parallel.matcher import Matcher

    corpus, n = d["corpus"], len(d["corpus"])
    _chunk, _overlap, wpad = d["matcher"]._chunk_geometry(CHUNK)
    chosen = [wpad - padded_steps(d["compiled"].max_pat_len)]

    def uncompacted():
        return host_seconds(lambda: d["matcher"].match_chunked(
            corpus, input_size=n, chunk_bytes=CHUNK))

    plain_secs = [uncompacted()]
    with swapped(matcher_mod, "PlanShardScanner",
                 compacting_scanner(chosen)), opted_in():
        m = Matcher(d["compiled"], d["cfg"], device=device,
                    train=corpus[:MIB])
        K1.launches = K1.launches_compact_a = K1.launches_compact_b = 0
        rescans0 = K1.overflow_rescans
        t0 = time.perf_counter()
        got = m.match_chunked(corpus, input_size=n, chunk_bytes=CHUNK)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(plan_scan_compact_a=K1.launches_compact_a,
                      planb_scan=K1.launches_compact_b,
                      plan_scan=K1.launches)
        scans = counts["plan_scan_compact_a"]
        rescans = K1.overflow_rescans - rescans0
        # again for the time (the first run built the scanners), in
        # turns with the uncompacted matcher: plain, pair, pair, plain
        warm = [host_seconds(lambda: m.match_chunked(
            corpus, input_size=n, chunk_bytes=CHUNK)) for _ in range(2)]
    plain_secs.append(uncompacted())
    chunks = -(-n // CHUNK)
    n_plan = len(chosen) - 1
    check(np.array_equal(got, d["got"]),
          f"{name}: compacted path != the CLI's main-path output")
    check(counts["plan_scan_compact_a"] == counts["planb_scan"]
          == n_plan * chunks,
          f"{name}: compacted launches {counts}, {n_plan} plan shards x "
          f"{chunks} chunks")
    check(counts["plan_scan"] == rescans,
          f"{name}: {counts['plan_scan']} K1 launches, {rescans} rescans")
    check(rescans < scans, f"{name}: every compacted scan overflowed")
    return dict(dictionary=name, corpus_bytes=n, seconds_first=secs,
                seconds=warm, seconds_uncompacted=plain_secs,
                chunks=chunks, shards=chosen[1:], launches=counts,
                compacted_scans=scans, overflow_rescans=rescans,
                identical_to_cli_output=True, matches=len(got))


def deep_work(staged, t, surv, cut, cap, seg):
    """What phase B's data needs: window reads (one per survivor per
    step it is still live at) and survivors that end with deep bits."""
    from phfpfac_tpu_torch.ops import plan as K1

    pos, disp, count = surv
    n = min(int(count), cap)
    pos, disp = pos[:n].to(torch.int64), disp[:n].to(torch.int64)
    flat = staged.reshape(-1)
    room = ((pos & ~(seg - 1)) + (seg + HALO) - pos) if seg else None
    out = torch.zeros_like(pos)
    reads = 0
    for sp in t.spec[cut:]:
        live = disp != t.p0_miss
        if room is not None:
            live = live & (room > sp.depth0 - 1)
        reads += int(live.sum())
        disp, out = K1.plan_steps_plain([sp], t, lambda o: flat[pos + o],
                                        room, disp, out)
    return reads, int((out != 0).sum())


def compact_times(name, d):
    """CUDA-event ms per 16 MiB chunk, summed over the plan shards:
    K1' alone, K6 alone (the merge is inside it; no separate compaction
    pass exists; also by the profiler's device time, ``b_device_ms``),
    the pair, and uncompacted K1 in the same run; bitmap mode under the
    segment cut and count mode; survivors, cap and live fraction at the
    cut; each kernel's bytes bound."""
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.staging import TILE

    keys = ("a_ms", "b_ms", "b_device_ms", "pair_ms", "k1_ms", "a_plain_ms",
            "b_plain_ms", "count_a_ms", "count_b_ms", "count_b_device_ms",
            "count_pair_ms", "count_k1_ms",
            "a_bound_ms", "b_bound_ms", "count_a_bound_ms",
            "count_b_bound_ms", "b_sector_traffic_ms", "k1_bound_ms")
    r = dict.fromkeys(keys, 0.0)
    r.update(n_pos=0, survivors=0, cap=0, window_reads=0, deep_hits=0,
             shards=[])
    for rec in d["recs"]:
        sc, st = rec["scanner"], rec["staged"]
        t, n_pos = sc.tables, st.numel() - TILE
        how, cut, cap, _why = choose_compact(sc.pt, n_pos)
        kw = dict(cut=cut, cap=cap, seg_bytes=SEG, halo_bytes=HALO)
        ckw = dict(cut=cut, cap=cap, emit="count")
        res, surv = K1.plan_scan_compact_a(st, t, **kw)
        count = int(surv[2])
        check(count <= cap, f"{name} shard {rec['shard']}: overflow "
                            f"({count} > {cap}) in compact_times")
        tot, csurv = K1.plan_scan_compact_a(st, t, **ckw)
        r["a_ms"] += cuda_ms(lambda: K1.plan_scan_compact_a(st, t, **kw))
        r["b_ms"] += cuda_ms(lambda: K1.planb_scan(st, t, res, surv, **kw))
        r["b_device_ms"] = plus(r["b_device_ms"], device_ms(
            lambda: K1.planb_scan(st, t, res, surv, **kw), "planb_scan"))
        r["pair_ms"] += cuda_ms(lambda: K1.plan_scan_compact(st, t, **kw))
        r["k1_ms"] += cuda_ms(lambda: K1.plan_scan(
            st, t, seg_bytes=SEG, halo_bytes=HALO))
        r["a_plain_ms"] += cuda_ms(
            lambda: K1.plan_scan_compact_a_plain(st, t, **kw), reps=2)
        r["b_plain_ms"] += cuda_ms(
            lambda: K1.planb_scan_plain(st, t, res, surv, **kw), reps=2)
        r["count_a_ms"] += cuda_ms(
            lambda: K1.plan_scan_compact_a(st, t, **ckw))
        r["count_b_ms"] += cuda_ms(
            lambda: K1.planb_scan(st, t, tot, csurv, **ckw))
        r["count_b_device_ms"] = plus(r["count_b_device_ms"], device_ms(
            lambda: K1.planb_scan(st, t, tot, csurv, **ckw), "planb_scan"))
        r["count_pair_ms"] += cuda_ms(
            lambda: K1.plan_scan_compact(st, t, **ckw))
        r["count_k1_ms"] += cuda_ms(lambda: K1.plan_scan(st, t,
                                                         emit="count"))
        reads, hits = deep_work(st, t, surv, cut, cap, SEG)
        creads, _ = deep_work(st, t, csurv, cut, cap, 0)
        tb = table_bytes(t)
        # K1': the stream read, cnt and bits written, (pos, disp) written
        # per survivor, the tables read once
        r["a_bound_ms"] += ((12 * n_pos + 8 * count + tb)
                            / HBM_BYTES_PER_S * 1e3)
        r["count_a_bound_ms"] += ((4 * n_pos + 8 * int(csurv[2]) + tb)
                                  / HBM_BYTES_PER_S * 1e3)
        # K6: (pos, disp) read per survivor, one int32 per window read,
        # and per survivor with deep bits its word of bits and of cnt
        # read and written
        r["b_bound_ms"] += ((8 * count + 4 * reads + 16 * hits)
                            / HBM_BYTES_PER_S * 1e3)
        r["count_b_bound_ms"] += ((8 * int(csurv[2]) + 4 * creads)
                                  / HBM_BYTES_PER_S * 1e3)
        # what the card moves if every scattered word costs a 32 B
        # sector (an upper figure: a survivor's step windows share
        # sectors); not a bound
        r["b_sector_traffic_ms"] += ((8 * count + 32 * reads + 128 * hits)
                                     / HBM_BYTES_PER_S * 1e3)
        r["k1_bound_ms"] += bound_ms(n_pos, tb, True)
        r["n_pos"] += n_pos
        r["survivors"] += count
        r["cap"] += cap
        r["window_reads"] += reads
        r["deep_hits"] += hits
        r["shards"].append(dict(shard=rec["shard"], how=how, cut=cut,
                                cap=cap, steps=len(t.spec),
                                survivors=count,
                                live_fraction=count / n_pos,
                                count_mode_survivors=int(csurv[2])))
        del res, surv, tot, csurv
    r["live_fraction"] = r["survivors"] / r["n_pos"]
    r["sum_ms"] = r["a_ms"] + r["b_ms"]
    return r


# ---- the rest of the single-device surface -----------------------------------

def sorted_rows(a):
    a = np.asarray(a, np.int64).reshape(-1, 2)
    return a[np.lexsort((a[:, 1], a[:, 0]))]


def device_data_phase(d):
    """``match_chunked`` with the corpus uploaded once
    (``stage_for_chunked``) against the loop that uploads each chunk."""
    m, corpus, n = d["matcher"], d["corpus"], len(d["corpus"])
    out = {}
    staged = None

    def upload():
        nonlocal staged
        staged = m.stage_for_chunked(corpus, chunk_bytes=CHUNK)

    out["staging_upload_seconds"] = host_seconds(upload)
    res = {}
    for label, kw in (("uploaded_per_chunk", {}),
                      ("device_resident", {"device_data": staged}),
                      ("uploaded_per_chunk_2", {}),
                      ("device_resident_2", {"device_data": staged})):
        out[f"{label}_seconds"] = host_seconds(
            lambda: res.__setitem__(label, m.match_chunked(
                corpus, input_size=n, chunk_bytes=CHUNK, **kw)))
    check(np.array_equal(res["device_resident"], res["uploaded_per_chunk"]),
          "device-resident chunking != per-chunk upload")
    check(np.array_equal(res["device_resident"], d["got"]),
          "device-resident chunking != the CLI's output")
    out.update(staged_bytes=int(staged.numel()), matches=len(d["got"]),
               equal=True)
    return out


def stream_phase(d, cfg, window: bytes, feed_bytes: int, device):
    """``StreamMatcher`` fed ``window`` in ``feed_bytes`` feeds, two
    dispatched ahead of the one resolved, then ``finish()``: the
    concatenated results against one ``Matcher.match``."""
    from phfpfac_tpu_torch.parallel.matcher import Matcher
    from phfpfac_tpu_torch.parallel.stream import StreamMatcher

    sm = StreamMatcher(d["compiled"], cfg, device=device)
    check(sm.matcher.engine == "pallas", "StreamMatcher's default engine")
    sm.matcher._train = window[:MIB]
    sm.matcher._get_pallas_scanner()  # build the scanners: not timed
    torch.cuda.synchronize()
    parts, pending = [], []
    t0 = time.perf_counter()
    for i in range(0, len(window), feed_bytes):
        pending.append(sm.feed_async(window[i: i + feed_bytes]))
        if len(pending) > 2:
            parts.append(pending.pop(0)())
    parts += [r() for r in pending]
    parts.append(sm.finish())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    feeds = -(-len(window) // feed_bytes)
    got = np.concatenate(parts)
    want = Matcher(d["compiled"], cfg, device=device,
                   train=window[:MIB]).match(window)
    check(np.array_equal(sorted_rows(got), sorted_rows(want)),
          "streamed results != one Matcher.match")
    return dict(bytes=len(window), feeds=feeds, feed_bytes=feed_bytes,
                truncation=cfg.truncation, seconds=secs,
                seconds_per_feed=secs / feeds,
                gb_per_s=len(window) / secs / 1e9, matches=len(got),
                flushed_by_finish=len(parts[-1]), equal_to_one_shot=True)


def match_many_phase(d, rng, device):
    """``match_many`` on 10,000 buffers of 1,500 B cut from the corpus
    (fewer where the corpus is shorter); a sample of 200 against
    scanning each alone."""
    from phfpfac_tpu_torch.parallel.stream import match_many

    m, corpus = d["matcher"], d["corpus"]
    bufs = [corpus[i * 1500: (i + 1) * 1500]
            for i in range(min(10_000, len(corpus) // 1500))]
    outs = []
    secs = host_seconds(lambda: outs.extend(match_many(m, bufs)))
    check(len(outs) == len(bufs), "match_many: one result per buffer")
    sample = rng.choice(len(bufs), min(200, len(bufs)), replace=False)
    for i in sample:
        check(np.array_equal(outs[int(i)], m.match(bufs[int(i)])),
              f"match_many: buffer {int(i)} != scanning it alone")
    return dict(buffers=len(bufs), buffer_bytes=1500, seconds=secs,
                matches=sum(len(o) for o in outs), sampled=len(sample),
                sample_matches=sum(len(outs[int(i)]) for i in sample),
                equal=True)


def run_cli_phases(args):
    """The CLI: (whole seconds, create_pfac seconds, match seconds), the
    last two from its own phase timer."""
    from phfpfac_tpu_torch import cli as cli_mod

    real, timers = cli_mod.PhaseTimer, []

    def timer():
        timers.append(real())
        return timers[-1]

    with swapped(cli_mod, "PhaseTimer", timer):
        secs = run_cli(args)
    phases = timers[-1].phases
    return secs, phases["create_pfac"], phases["match"]


def tables_phase(name, d, tmp):
    """The CLI with ``--save-tables``, then with ``--load-tables``."""
    from phfpfac_tpu_torch.compile.tables import CompiledDictionary

    pat_file, in_file = d["files"]
    npz = os.path.join(tmp, f"{name}.npz")
    outs = [os.path.join(tmp, f"{name}.{k}.out") for k in ("save", "load")]
    save = run_cli_phases([pat_file, 1, 4096, in_file, "-o", outs[0],
                           "--quiet", *d["flags"], "--save-tables", npz])
    saved = CompiledDictionary.load(npz)
    carried = sum(p is not None for p in saved.plan_tables or [])
    check(carried > 0, f"{name}: the saved file carries no plan tables")
    load = run_cli_phases(["no-such-pattern-file", 1, 4096, in_file, "-o",
                           outs[1], "--quiet", "--load-tables", npz])
    for out in outs:
        with open(out, "rb") as f, open(d["out"], "rb") as g:
            check(f.read() == g.read(),
                  f"{name}: {os.path.basename(out)} != the main path's")
    keys = ("cli_seconds", "create_pfac_seconds", "match_seconds")
    return dict(dictionary=name, file_bytes=os.path.getsize(npz),
                shards=len(saved.shards), plan_tables_carried=carried,
                save=dict(zip(keys, save)), load=dict(zip(keys, load)),
                main_path_cli_seconds=d["cli_seconds"],
                byte_identical=True)


def make_class_specs(rng, count=5000, again=50):
    """``count`` of lower50k's patterns with one byte widened to a class
    of 2-10 members that holds it; each of the first ``again`` is
    followed by a second spelling with a byte widened anew, so that both
    ids end in one DFA final of one shard.  Returns (specs, the plain
    patterns they were made of)."""
    base = make_stem_patterns(rng, LOWER, count=count)

    def widen(p):
        i = int(rng.integers(0, len(p)))
        others = rng.choice(LOWER[LOWER != p[i]], int(rng.integers(1, 10)),
                            replace=False)
        return p[:i] + b"[" + bytes([p[i]]) + bytes(others) + b"]" + p[i + 1:]

    plain = [p for k, p in enumerate(base) for _ in range(1 + (k < again))]
    return [widen(p) for p in plain], plain


def class_oracle(class_patterns, data: bytes) -> np.ndarray:
    """Host oracle for a class dictionary, no walk truncation (every
    pattern is shorter than the halo): per position by (length, id)."""
    buf = np.frombuffer(data, np.uint8)
    at = {b: np.flatnonzero(buf == b) for b in np.unique(buf).tolist()}
    none = np.empty(0, np.int64)
    rows = []
    for cp in class_patterns:
        L = len(cp.classes)
        cand = np.concatenate(
            [at.get(b, none) for b in cp.classes[0]] or [none])
        cand = cand[cand <= len(buf) - L]
        for j in range(1, L):
            if not cand.size:
                break
            lut = np.zeros(256, bool)
            lut[list(cp.classes[j])] = True
            cand = cand[lut[buf[cand + j]]]
        rows += [(int(p), L, cp.pattern_id) for p in cand]
    rows.sort()
    return np.asarray([(p, i) for p, _L, i in rows],
                      np.int64).reshape(-1, 2)


def charset_phase(rng, tmp, device):
    """The CLI with ``--charset`` on class5k over 16 MiB: output lines
    against the plain version's bitmaps, and a 1 MiB prefix against the
    host oracle."""
    from phfpfac_tpu_torch.compile.tables import compile_class_patterns
    from phfpfac_tpu_torch.frontend.charset import read_class_patterns
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.parallel.matcher import Matcher
    from phfpfac_tpu_torch.parallel.merge import render_result_file
    from phfpfac_tpu_torch.utils.config import PfacConfig

    specs, plain_pats = make_class_specs(rng)
    corpus, planted = make_corpus(rng, plain_pats, CHUNK, LOWER,
                                  plants=PLANTS // 4)
    pat_file, in_file = write_inputs(tmp, "class5k", specs, corpus, False)
    cfg = PfacConfig(width=4096, num_shards=4, truncation="segment")
    t0 = time.perf_counter()
    cps = read_class_patterns(pat_file)
    compiled = compile_class_patterns(cps, cfg)
    compile_seconds = time.perf_counter() - t0
    multi = sum(len(v) > 1 for sh in compiled.shards
                for v in sh.output_lists.values())
    check(multi > 0, "class5k: no multi-output final")
    out = os.path.join(tmp, "class5k.out")
    secs = run_cli([pat_file, 1, 4096, in_file, "-o", out, "--quiet",
                    "--charset"])
    got = read_output(out)
    got_set = set(map(tuple, got.tolist()))
    missing = [p for p in planted if p not in got_set]
    check(not missing, f"class5k: planted matches missing {missing[:5]}")
    # distinct (position, length) pairs of the output = set bits of the
    # plain version's bitmaps (a multi-output final writes several lines)
    plen = np.zeros(len(cps) + 1, np.int64)
    for cp in cps:
        plen[cp.pattern_id] = len(cp.classes)
    distinct = len(np.unique(got[:, 0] * 64 + plen[got[:, 1]]))
    m = Matcher(compiled, cfg, device=device, train=corpus[:MIB])
    bits_set = 0
    for sc in m._get_scanners():
        check(isinstance(sc, K1.PlanShardScanner),
              "class5k: a shard took another kernel than plan")
        staged, n = scan_inputs(sc, corpus, device)
        cnt, _bits = K1.plan_scan_plain(staged, sc.tables, seg_bytes=SEG,
                                        halo_bytes=HALO)
        bits_set += int(cnt[:n].sum())
    # counted per shard: two shards' patterns may match one string
    per_shard = 0
    for sh in compiled.shards:
        ids = np.unique(np.concatenate(
            [np.asarray(v) for v in sh.output_lists.values()]))
        sel = got[np.isin(got[:, 1], ids)]
        per_shard += len(np.unique(sel[:, 0] * 64 + plen[sel[:, 1]]))
    check(per_shard == bits_set,
          f"class5k: {per_shard} (position, length) pairs per shard in "
          f"the output, plain bitmaps hold {bits_set} bits")
    small = corpus[:MIB]
    s_in = os.path.join(tmp, "class5k.small")
    with open(s_in, "wb") as f:
        f.write(small + b"\n")
    s_out = os.path.join(tmp, "class5k.small.out")
    run_cli([pat_file, 1, 4096, s_in, "-o", s_out, "--quiet", "--charset"])
    t0 = time.perf_counter()
    want = class_oracle(cps, small)
    oracle_seconds = time.perf_counter() - t0
    with open(s_out) as f:
        check(f.read() == render_result_file(want),
              "class5k: 1 MiB output differs from the host oracle")
    return dict(dictionary="class5k", class_patterns=len(cps),
                compile_seconds=compile_seconds,
                states=[sh.state_num for sh in compiled.shards],
                multi_output_finals=multi, corpus_bytes=len(corpus),
                cli_seconds=secs, output_lines=len(got),
                distinct_position_length=distinct,
                plain_bitmap_bits=bits_set, planted_found=len(planted),
                oracle_bytes=len(small), oracle_matches=len(want),
                oracle_seconds=oracle_seconds, identical_to_oracle=True)



# ---- the probes --------------------------------------------------------------

GATHER_T = 4 * MIB  # the kernels line's probe_gather: an int32 table this big
SWEEP_KS = (1, 8)  # walkers a thread interleaves in the gather sweep here


def probe_parity(device):
    """P1 (every arm, every K, lane_probe's recurrence and the scattered
    one) and P2 (1, 2, 6 planes; copy, in-block pack, atomic pack)
    against their plain versions on the card."""
    from phfpfac_tpu_torch.probes import compact, gather

    rng = np.random.default_rng(1)
    idx = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, MIB).astype(np.int32)).to(device)
    cases = 0
    for arm in gather.ARMS:
        host = gather.make_table(rng, arm, 1 << 16)
        table = None if host is None else torch.from_numpy(host).to(device)
        for k in gather.KS:
            for mul in (1, gather.SCATTER):
                kw = dict(arm=arm, reps=5, k=k, mul=mul)
                agree("probe_gather",
                      [gather.probe_gather(table, idx, **kw)],
                      [gather.probe_gather_plain(table, idx, **kw)],
                      f"probe_gather {arm} k={k} mul={mul}")
                cases += 1
    disp = torch.from_numpy(compact.make_disp(rng, MIB)).to(device)
    for m in compact.SWEEP_PLANES:
        agree("probe_compact", compact.probe_compact(disp, m),
              compact.probe_compact_plain(disp, m), f"probe_compact m={m}")
        agree("probe_compact", compact.probe_copy(disp, m),
              compact.probe_copy_plain(disp, m), f"probe_copy m={m}")
        # tiles arrive in any order: the same values, as a multiset
        agree("probe_compact",
              compact.sorted_live(*compact.probe_compact_atomic(disp, m)),
              compact.sorted_live(
                  *compact.probe_compact_atomic_plain(disp, m)),
              f"probe_compact_atomic m={m}")
    return dict(gather_cases=cases, gather_walkers=MIB,
                gather_table_entries=1 << 16, arms=list(gather.ARMS),
                ks=list(gather.KS), compact_lanes=MIB,
                planes=list(compact.SWEEP_PLANES), equal=True)


def probes_phase(device):
    """The probes' own path, ``python -m phfpfac_tpu_torch.probes``'s two
    sweeps (interleaving 1 and 8 walkers a thread: the module sweeps 2
    and 4 too), every timed shape held to its plain version first; then
    each kernel, its plain version and (P2) the PyTorch call that
    compacts the same input, timed at one shape for the kernels line and
    compared there too; P2's three forms also by the profiler's device
    time."""
    from phfpfac_tpu_torch.probes import compact, gather

    gather.launches = compact.launches = 0
    compact.launches_copy = compact.launches_atomic = 0
    g_rows = list(gather.sweep(
        device, ks=SWEEP_KS,
        check=lambda got, want, what: agree("probe_gather", [got], [want],
                                            what)))
    c_rows = list(compact.sweep(
        device,
        check=lambda got, want, what: agree("probe_compact", got, want,
                                            what)))
    counts = dict(probe_gather=gather.launches,
                  probe_compact=compact.launches,
                  probe_copy=compact.launches_copy,
                  probe_compact_atomic=compact.launches_atomic)

    rng = np.random.default_rng(0)
    walkers = gather.SWEEP_WALKERS
    table = torch.from_numpy(
        gather.make_table(rng, "i32", GATHER_T // 4)).to(device)
    idx = torch.from_numpy(
        rng.integers(0, 1 << 31, walkers).astype(np.int32)).to(device)
    kw = dict(arm="i32", reps=8, k=1, mul=gather.SCATTER)
    agree("probe_gather", [gather.probe_gather(table, idx, **kw)],
          [gather.probe_gather_plain(table, idx, **kw)],
          f"probe_gather at the kernels line's shape ({walkers} walkers)")
    p1 = dict(
        ms=cuda_ms(lambda: gather.probe_gather(table, idx, **kw)),
        plain_ms=cuda_ms(lambda: gather.probe_gather_plain(table, idx, **kw),
                         reps=2),
        bound_ms=(8 * walkers + GATHER_T) / HBM_BYTES_PER_S * 1e3,
        walkers=walkers, table_bytes=GATHER_T, **kw)
    # what the card moves: a 32 B sector for every dependent gather, from
    # a table small enough for L2 (the data sheet gives no L2 rate)
    p1["sector_bytes"] = 32 * walkers * kw["reps"]
    p1["sector_rate_tb_per_s"] = p1["sector_bytes"] / p1["ms"] / 1e9
    p1["sector_bytes_at_hbm_rate_ms"] = (p1["sector_bytes"]
                                         / HBM_BYTES_PER_S * 1e3)
    del table, idx
    lanes = compact.SWEEP_LANES
    disp = torch.from_numpy(compact.make_disp(rng, lanes)).to(device)
    agree("probe_compact", compact.probe_compact(disp, 1),
          compact.probe_compact_plain(disp, 1),
          f"probe_compact at the kernels line's shape ({lanes} lanes)")
    p2 = dict(
        ms=cuda_ms(lambda: compact.probe_compact(disp, 1)),
        device_ms=device_ms(lambda: compact.probe_compact(disp, 1),
                            "probe_compact"),
        copy_ms=cuda_ms(lambda: compact.probe_copy(disp, 1)),
        copy_device_ms=device_ms(lambda: compact.probe_copy(disp, 1),
                                 "probe_compact"),
        atomic_ms=cuda_ms(lambda: compact.probe_compact_atomic(disp, 1)),
        atomic_device_ms=device_ms(
            lambda: compact.probe_compact_atomic(disp, 1), "probe_compact"),
        plain_ms=cuda_ms(lambda: compact.probe_compact_plain(disp, 1),
                         reps=2),
        library_ms=cuda_ms(lambda: disp[disp != 0]),
        torch_nonzero_ms=cuda_ms(lambda: torch.nonzero(disp)),
        bound_ms=(8 * lanes + 4 * (lanes // compact.TILE))
        / HBM_BYTES_PER_S * 1e3,
        lanes=lanes, density=compact.SWEEP_DENSITY, planes=1)
    return g_rows, c_rows, counts, p1, p2


def gather_rate(g_rows, nbytes: int):
    """(gathers/s, size tier): the best rate P1 measured for int32
    entries, at any interleaving, over the swept tables no larger than
    ``nbytes``; the tier is the largest of those tables' sizes.  A table
    under the smallest swept size (tier 0) reads at the best rate of
    all.  No table of ``nbytes`` random int32 entries was read faster in
    this run, so gathers over this rate bound the time from below."""
    rows = [r for r in g_rows if r["arm"] == "i32"]
    fit = [r for r in rows if r["table_bytes"] <= nbytes]
    rate = max(r["gathers_per_s"] for r in fit or rows)
    return rate, max((r["table_bytes"] for r in fit), default=0)


def bank_bytes(nb: int) -> int:
    """Bytes of ``nb`` banks of 128 int32 entries."""
    return int(nb) * 128 * 4


def plan_step_probes(staged, t, seg):
    """Dependent gathers of the plan walk over one staged window, from
    this run's data: [prologue, step 0, step 1, ...], each a list of
    (gathers, bytes of the table they read).  The prologue reads p0 once
    per position; a step reads its main table, and a pair step its side
    table too, once per walker that is live at it (a side table packs 4
    or 8 entries a word, so its gathers are counted against all of it,
    hot words or not)."""
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.staging import TILE

    flat = staged.reshape(-1)
    n_pos = flat.shape[0] - TILE
    room = K1.segment_room(n_pos, seg, HALO, flat.device) if seg else None
    out, disp = K1._prologue_plain(flat, n_pos, t, room)
    # the part of p0 the prologue's index can reach, where that is less
    # than the table ("s0": one entry per code, whatever p0's length)
    reach = {"dense": 2 * t.cb, "s0x": 2 * t.cb - 6, "s0": t.cb}[t.p0_mode]
    items = [[(n_pos, min(bank_bytes(t.p0.shape[0]), 4 << reach))]]
    for sp in t.spec:
        live = disp != t.p0_miss
        if room is not None:
            live = live & (room > sp.depth0 - 1)
        n_live = int(live.sum())
        step = [(n_live, bank_bytes(sp.nb))]
        if sp.kind == "pair":
            step.append((n_live, bank_bytes(sp.s_nb)))
        items.append(step)
        disp, out = K1.plan_steps_plain(
            [sp], t, lambda o: flat[o:o + n_pos], room, disp, out)
    return items


def warp_lane_stats(steps: torch.Tensor) -> dict:
    """How one walker per thread keeps a warp's lanes busy, from the steps
    each position's walker probes (``steps``, int64 [n_pos]): a warp of 32
    positions runs a step while any lane's walker is live before it
    (``warp_steps_per_warp``); ``lane_util`` = live lane-steps over 32 x
    warp steps; ``deep_warp_share``: warps of 7 steps or more."""
    warp = steps.reshape(-1, 32).max(1).values
    return dict(positions=steps.numel(), warps=warp.numel(),
                lane_steps=int(steps.sum()), warp_steps=int(warp.sum()),
                deep_warps=int((warp >= 7).sum()))


def lane_ratios(acc: dict) -> dict:
    return dict(
        positions=acc["positions"],
        steps_per_position=acc["lane_steps"] / acc["positions"],
        warp_steps_per_warp=acc["warp_steps"] / acc["warps"],
        lane_util=acc["lane_steps"] / max(32 * acc["warp_steps"], 1),
        deep_warp_share=acc["deep_warps"] / acc["warps"])


def lane_stats(d, device):
    """Per plan shard, over the whole corpus in 16 MiB windows, from the
    plain version: how one walker per thread (K1's mapping up to PR 4)
    keeps a warp's lanes busy (``warp_lane_stats``)."""
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.staging import TILE

    out = []
    for si, (_kind, sc) in enumerate(d["kinds"]):
        if not isinstance(sc, K1.PlanShardScanner):
            continue
        t = sc.tables
        acc: dict = {}
        for w0 in range(0, len(d["corpus"]), CHUNK):
            staged, _n = scan_inputs(sc, d["corpus"][w0:w0 + CHUNK], device)
            flat = staged.reshape(-1)
            n_pos = flat.shape[0] - TILE
            room = K1.segment_room(n_pos, SEG, HALO, flat.device)
            _out, disp = K1._prologue_plain(flat, n_pos, t, room)
            steps = torch.zeros(n_pos, dtype=torch.int64, device=flat.device)
            for sp in t.spec:
                steps += disp != t.p0_miss  # live before the step
                disp, _out = K1.plan_steps_plain(
                    [sp], t, lambda o: flat[o:o + n_pos], room, disp, _out)
            for k, v in warp_lane_stats(steps).items():
                acc[k] = acc.get(k, 0) + v
            del staged, flat, room, disp, steps, _out
        out.append(dict(shard=si, **lane_ratios(acc)))
    return out


def depth_live(staged, t, input_size, seg, halo=HALO):
    """Per step s >= 1 of the stride-1 depth walk, the walkers live
    before it (and inside the cut): bool [n_pos], one a step."""
    from phfpfac_tpu_torch.compile.depth import DISP_MISS
    from phfpfac_tpu_torch.ops.plan import probe_banks
    from phfpfac_tpu_torch.ops.staging import TILE

    flat = staged.reshape(-1)
    n_pos = flat.shape[0] - TILE
    lim = None
    if seg:
        pos = torch.arange(n_pos, dtype=torch.int64, device=flat.device)
        lim = torch.clamp((pos // seg + 1) * seg + halo,
                          max=input_size) - pos
    cur = flat[:n_pos].to(torch.int64)
    v = probe_banks(t.s0, cur, 0, t.s0.shape[0], 0)
    disp = torch.where(v >= 0, v >> 1, DISP_MISS)
    for s, (off, nb, k0) in enumerate(t.steps.cpu().tolist(), 1):
        if lim is not None:
            disp = torch.where(s < lim, disp, DISP_MISS)
        yield disp != DISP_MISS
        cur = flat[s:s + n_pos].to(torch.int64)
        g = probe_banks(t.packed, disp + cur, off, nb, k0)
        hit = (g >= 0) & ((g & 255) == cur)
        disp = torch.where(hit, g >> 9, DISP_MISS)


def depth_step_probes(staged, t, input_size, seg):
    """Walkers that probe at each step of the stride-1 depth walk:
    [every position (s0), step 1, step 2, ...]; entry s >= 1 is the
    number of walkers live after s characters (and inside the cut)."""
    from phfpfac_tpu_torch.ops.staging import TILE

    return [staged.numel() - TILE] + [
        int(live.sum()) for live in depth_live(staged, t, input_size, seg)]


def pair_live(staged, t):
    """Per pair step k >= 1 of the stride-2 walk (exact mode), the
    walkers live before it: bool [n_pos], one a step."""
    from phfpfac_tpu_torch.ops.plan import probe_banks
    from phfpfac_tpu_torch.ops.staging import TILE

    flat = staged.reshape(-1)
    n_pos = flat.shape[0] - TILE
    cb = t.cb
    v = probe_banks(t.p0, flat[:n_pos].to(torch.int64), 0, t.p0.shape[0], 0)
    disp = torch.where(v >= 0, v >> 2, t.disp_miss)
    for k, (po, pn, pk0, *_side) in enumerate(t.step_rows, 1):
        yield disp != t.disp_miss
        cur = flat[2 * k:2 * k + n_pos].to(torch.int64)
        g = probe_banks(t.packed, disp + cur, po, pn, pk0)
        hit = (g >= 0) & ((g & ((1 << (2 * cb)) - 1)) == cur)
        disp = torch.where(hit, g >> (2 * cb + 1), t.disp_miss)


def walk_lane_stats(clam, lower) -> dict:
    """Modelled, not measured: K2 on the depth path (clamav5k's first 16
    MiB, a 6,144 B segment) and K3 on the pair path (lower50k, exact),
    per kernel over its 4 shards, from the plain versions' live walkers:
    how one walker per thread (the parent's mapping) keeps a warp's lanes
    busy (``warp_lane_stats``), and the share of positions still live
    after step 1, which the new kernels' prologue leaves to the lists."""
    out = {}
    for label, recs, live_of in (
            ("depth_scan/clamav5k", clam["depth_recs"],
             lambda r: depth_live(r["staged"], r["scanner"].tables, r["n"],
                                  6144)),
            ("pair_scan/lower50k", lower["recs"],
             lambda r: pair_live(r["staged"], r["scanner"].tables))):
        acc, listed = {}, 0
        for r in recs:
            steps = None
            for s, live in enumerate(live_of(r), 1):
                steps = live.to(torch.int64) if steps is None \
                    else steps + live
                if s == 2:
                    listed += int(live.sum())
            if steps is None:
                continue
            for k, v in warp_lane_stats(steps).items():
                acc[k] = acc.get(k, 0) + v
        out[label] = dict(**lane_ratios(acc),
                          live_after_step1_share=listed / acc["positions"])
    return out


def gather_bounds(g_rows, dicts, lower, ct, phf_singles, device):
    """Per kernel, per 16 MiB chunk (4 shards): its dependent gathers on
    this run's data, table by table (the prologue's table and each
    step's, at their own sizes), and the least time P1's measured rates
    leave for them (``gather_rate`` per table)."""
    from phfpfac_tpu_torch.ops import depth as K2

    def bound(items):
        # items: (gathers, bytes of the table they read)
        by_size, ms = {}, 0.0
        for g, tb in items:
            rate, tier = gather_rate(g_rows, tb)
            ms += g / rate * 1e3
            by_size[tier] = by_size.get(tier, 0) + g
        return dict(gathers=sum(g for g, _ in items), gather_bound_ms=ms,
                    gathers_by_table_tier_bytes=dict(sorted(
                        by_size.items())))

    def flat(steps):
        return [it for step in steps for it in step]

    out = {}
    for name, d in dicts.items():
        k1, ka, kb, kc = [], [], [], []
        for rec, sh in zip(d["recs"], ct[name]["shards"]):
            steps = plan_step_probes(rec["staged"], rec["scanner"].tables,
                                     SEG)
            cut = sh["cut"] + 1
            k1 += flat(steps)
            ka += flat(steps[:cut])
            kb += flat(steps[cut:])
            # count mode walks without the segment cut
            kc += flat(plan_step_probes(rec["staged"],
                                        rec["scanner"].tables, 0))
        out[f"plan_scan/{name}"] = bound(k1)
        out[f"plan_scan_count/{name}"] = bound(kc)
        out[f"plan_scan_compact_a/{name}"] = bound(ka)
        out[f"planb_scan/{name}"] = bound(kb)
        out[f"plan_scan/{name}"]["lane_stats"] = lane_stats(d, device)
    # K2, and from its per-step live walkers K4 and K5: the banked-PHF
    # walk reads s0, then per live walker and step the row's displacement
    # (r) and the slot that points at (packed); K5 makes K4's gathers in
    # one launch, each in its own shard's slice of the tables
    k2, k4 = [], []
    for rec, single in zip(dicts["clamav5k"]["depth_recs"], phf_singles):
        t = rec["scanner"].tables
        c = depth_step_probes(rec["staged"], t, rec["n"], SEG)
        k2.append((c[0], bank_bytes(t.s0.shape[0])))
        k2 += [(g, bank_bytes(nb))
               for g, (_off, nb, _k0) in zip(c[1:], t.steps.cpu().tolist())]
        (_so, nb_s0, _ro, nb_r, _po, nb_p, *_rest), = single.tables.spec_rows
        walked = sum(c[1:])
        k4 += [(c[0], bank_bytes(nb_s0)), (walked, bank_bytes(nb_r)),
               (walked, bank_bytes(nb_p))]
    out["depth_scan/clamav5k"] = bound(k2)
    out["phf_scan/clamav5k"] = bound(k4)
    out["phf_scan_multi/clamav5k"] = bound(k4)
    # K3 (exact mode): the dense prologue, then per pair step k the main
    # and the side table for every walker live after 2k characters
    k3 = []
    for sc in lower["pair_scanners"]:
        ds = K2.DepthShardScanner(sc.shard, device=device)
        staged, n = scan_inputs(ds, lower["corpus"], device)
        c = depth_step_probes(staged, ds.tables, n, 0)
        k3.append((c[0], bank_bytes(sc.tables.p0.shape[0])))
        for k, row in enumerate(sc.tables.step_rows, 1):
            live = c[2 * k] if 2 * k < len(c) else 0
            _po, p_nb, _pk0, _so, s_nb, _sk0, _nib = row
            k3 += [(live, bank_bytes(p_nb)), (live, bank_bytes(s_nb))]
        del staged
    out["pair_scan/lower50k"] = bound(k3)
    return out


# ---- the soak: random dictionaries through the scan kernels ------------------

# Everything the soak reads is here: its seeds, its sizes and its
# generators (soak_case).  ``python3 chip_smoke.py --soak`` runs it alone.
SOAK_SEEDS = 12
SOAK_BYTES = MIB  # corpus a seed
SOAK_E2E_BYTES = 128 * 1024  # of it, end to end against the oracle
SOAK_KINDS = ("dense", "s0", "s0x", "class")
SOAK_DEPTH_GEOMS = ((512, 64), (6144, 512), (100, 3), (0, 0))
SOAK_SEG = (512, 64)  # Matcher.match_chunked's segment cut in the soak


def soak_case(seed: int, tmp: str, cfg=None, size: int = SOAK_BYTES):
    """One seed's inputs, from a numpy generator seeded by it: (kind,
    compiled dictionary, the patterns the oracle takes, corpus).  The
    kinds rotate: a small alphabet (the dense prologue), a mid alphabet
    with two patterns of 40-64 B (the s0 prologue and the long-pattern
    split), 6,000-9,000 random byte signatures and one of 33-40 B (s0x),
    class patterns (``--charset``); each corpus of ``size`` bytes holds
    planted patterns, one in 512 B (at least 3, at most 2,000).  ``cfg``
    defaults to width 4096, 2 shards."""
    from phfpfac_tpu_torch.compile.tables import (
        compile_class_patterns,
        compile_patterns,
    )
    from phfpfac_tpu_torch.frontend.charset import read_class_patterns
    from phfpfac_tpu_torch.frontend.patterns import Pattern
    from phfpfac_tpu_torch.utils.config import PfacConfig

    rng = np.random.default_rng(10_000 + seed)
    kind = SOAK_KINDS[seed % len(SOAK_KINDS)]
    cfg = cfg or PfacConfig(width=4096, num_shards=2)
    plants = min(2000, max(3, size // 512))
    count = int(rng.integers(500, 3000))
    if kind == "class":
        specs, plain = make_class_specs(rng, count=count, again=20)
        corpus, _ = make_corpus(rng, plain, size, LOWER, plants=plants)
        pat_file, _ = write_inputs(tmp, f"soak{seed}", specs, corpus, False)
        cps = read_class_patterns(pat_file)
        return kind, compile_class_patterns(cps, cfg), cps, corpus
    if kind == "s0x":  # the split prologue pays off at 3,000 a shard
        alphabet = None
        count = int(rng.integers(6000, 9000))
        pats = list(dict.fromkeys(
            bytes(rng.integers(0, 256, int(rng.integers(3, 33)),
                               dtype=np.uint8)) for _ in range(count)))
        pats.append(bytes(rng.integers(0, 256, int(rng.integers(33, 41)),
                                       dtype=np.uint8)))
    else:
        width = int(rng.integers(4, 13) if kind == "dense"
                    else rng.integers(20, 61))
        alphabet = rng.choice(np.arange(33, 127, dtype=np.uint8), width,
                              replace=False)
        pats = make_stem_patterns(rng, alphabet, count=count)
        known = set(pats)
        pats += [p for p in dict.fromkeys(
            bytes(rng.choice(alphabet, int(rng.integers(1, 4))))
            for _ in range(20)) if p not in known]
        if kind == "s0":  # last: make_corpus plants the last three first
            pats += [bytes(rng.choice(alphabet, int(rng.integers(40, 65))))
                     for _ in range(2)]
    corpus, _ = make_corpus(rng, pats, size, alphabet, plants=plants)
    compiled = compile_patterns(
        [Pattern(i + 1, p) for i, p in enumerate(pats)], cfg)
    return kind, compiled, [Pattern(i + 1, p) for i, p in enumerate(pats)], \
        corpus


def _built(make, *a, **kw):
    """The scanner ``make`` builds, or None where its tables refuse."""
    from phfpfac_tpu_torch.compile.depth import DepthUnsupported

    try:
        return make(*a, **kw)
    except DepthUnsupported:  # the plan and pair builders' refusals too
        return None


def soak_plan(sc, corpus, device, what) -> int:
    """K1 in bitmap (under the cut and exact) and count mode, K1′ + K6 at
    an explicit cut with a cap that holds every survivor (cap = count,
    and the cap ``resolve_compact`` would give: 8 x count rounded up to
    a block), with no survivors (a last cut that leaves none, else K6
    fed a zeroed count) and with a cap that overflows (K1′ alone, and K6
    on its buffers), against the plain versions.  -> checks made."""
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops.staging import TILE

    st, _n = scan_inputs(sc, corpus, device)
    t, n_pos = sc.tables, st.numel() - TILE
    checks = 0
    for seg, halo in (SOAK_SEG, (0, 0)):
        kw = dict(seg_bytes=seg, halo_bytes=halo)
        agree("plan_scan", K1.plan_scan(st, t, **kw),
              K1.plan_scan_plain(st, t, **kw), f"{what}: K1 seg={seg}")
        checks += 1
    agree("plan_scan", [K1.plan_scan(st, t, emit="count", shift=1)],
          [K1.plan_scan_plain(st, t, emit="count", shift=1)],
          f"{what}: K1 count")
    checks += 1
    if len(t.spec) < 2:
        return checks
    cut = len(t.spec) // 2
    block = K1.COMPACT_BLOCK
    for seg, halo in (SOAK_SEG, (0, 0)):
        kw = dict(cut=cut, seg_bytes=seg, halo_bytes=halo)
        w = f"{what}: K1' + K6 cut={cut} seg={seg}"
        want, wsurv = K1.plan_scan_compact_a_plain(st, t, cap=n_pos, **kw)
        count = int(wsurv[2])
        whole = K1.plan_scan_plain(st, t, seg_bytes=seg, halo_bytes=halo)
        real = -(-8 * max(count, 1) // block) * block
        for cap in (max(count, 1), real):
            got, surv = K1.plan_scan_compact_a(st, t, cap=cap, **kw)
            agree("plan_scan_compact_a",
                  [*got, *sorted_survivors(surv, cap)],
                  [*want, *sorted_survivors(wsurv, cap)], f"{w} cap={cap}")
            res = K1.plan_scan_compact(st, t, cap=cap, **kw)
            agree("planb_scan", res[:2], whole,
                  f"{w} cap={cap}: != K1's plain version")
            check(int(res[2]) == count, f"{w} cap={cap}: survivor count")
            checks += 2
        # no survivors: the last cut where it leaves none, else K6 fed a
        # zeroed count (it must leave phase A's result as it is)
        last = dict(kw, cut=len(t.spec) - 1)
        _r, lsurv = K1.plan_scan_compact_a_plain(st, t, cap=n_pos, **last)
        if int(lsurv[2]) == 0:
            res = K1.plan_scan_compact(st, t, cap=block, **last)
            agree("planb_scan", res[:2], whole,
                  f"{w}: no survivors at cut {last['cut']}")
            check(int(res[2]) == 0, f"{w}: survivors at the last cut")
        else:
            got, surv = K1.plan_scan_compact_a(st, t, cap=real, **kw)
            before = [x.clone() for x in got]
            K1.planb_scan(st, t, got, (surv[0], surv[1],
                                       torch.zeros_like(surv[2])),
                          cap=real, **kw)
            agree("planb_scan", got, before,
                  f"{w}: K6 with a zeroed count changed its result")
        checks += 1
        if count < 2:
            continue
        cap = count // 2  # overflows: the true count, cap of the set
        got, surv = K1.plan_scan_compact_a(st, t, cap=cap, **kw)
        agree("plan_scan_compact_a", got, want, f"{w} cap={cap}")
        check(int(surv[2]) == count, f"{w} cap={cap}: true count")
        gp, gd, _ = sorted_survivors(surv, cap)
        wp, wd, _ = sorted_survivors(wsurv, count)
        at = torch.searchsorted(wp, gp).clamp(max=count - 1)
        check(torch.unique(gp).numel() == cap and torch.equal(wp[at], gp)
              and torch.equal(wd[at], gd),
              f"{w} cap={cap}: survivors not {cap} of the plain set")
        # K6 on the overflowed buffers: the first cap of them, as plain
        wres = [x.clone() for x in got]
        K1.planb_scan(st, t, got, surv, cap=cap, **kw)
        K1.planb_scan_plain(st, t, wres, surv, cap=cap, **kw)
        agree("planb_scan", got, wres, f"{w} cap={cap}: K6 after overflow")
        checks += 2
    return checks


def soak_mesh(compiled, cfg, train, data, want, what) -> int:
    """``PlanMeshMatcher`` on two cells of the one card, compacted at an
    explicit (cut, cap), against ``match_chunked``'s output ``want`` on
    ``data``.  -> 1, or 0 where the plan tables refuse the dictionary."""
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.parallel.mesh import make_mesh
    from phfpfac_tpu_torch.parallel.mesh_pallas import PlanMeshMatcher

    pm = _built(PlanMeshMatcher, compiled, cfg,
                make_mesh(2, 1, cell_devices(2)), train=train,
                compact=(1, 8 * K1.COMPACT_BLOCK))
    if pm is None:
        return 0
    before = K1.launches_compact_b
    got = pm.match(data)
    if any(len(pt.steps) > 1 for pt in pm._shard_pts):  # a cut at step 1
        check(K1.launches_compact_b > before, f"{what}: the mesh ran no K6")
    check(np.array_equal(np.asarray(got).reshape(-1, 2),
                         np.asarray(want).reshape(-1, 2)),
          f"{what}: the compacted plan mesh != match_chunked")
    return 1


def soak_depth(ds, corpus, device, what) -> int:
    """K2 at every segment geometry of the soak and exact, with its
    dead_exit and (exact) with it off, count mode and a chained count,
    against the plain version.  -> checks made."""
    from phfpfac_tpu_torch.ops import depth as K2

    st, n = scan_inputs(ds, corpus, device)
    t = ds.tables
    checks = 0
    for tt, geoms in ((t, SOAK_DEPTH_GEOMS),
                      (dataclasses.replace(t, dead_exit=False), ((0, 0),))):
        for seg, halo in geoms:
            kw = dict(input_size=n, seg_bytes=seg, halo_bytes=halo)
            agree("depth_scan", K2.depth_scan(st, tt, **kw),
                  K2.depth_scan_plain(st, tt, **kw),
                  f"{what}: K2 seg={seg}+{halo} dead_exit={tt.dead_exit}")
            checks += 1
    prev = want = None
    for shift in (1, 0):  # a count, then a count chained to it
        prev = K2.depth_scan(st, t, input_size=n, emit="count", shift=shift,
                             prev_total=prev)
        want = K2.depth_scan_plain(st, t, input_size=n, emit="count",
                                   shift=shift, prev_total=want)
        agree("depth_scan", [prev], [want], f"{what}: K2 count")
        checks += 1
    return checks


def soak_pair(ps, corpus, device, what) -> int:
    """K3 with its dead_exit and with it off, bitmap and count, against
    the plain version.  -> checks made."""
    from phfpfac_tpu_torch.ops import pair as K3

    st, _n = scan_inputs(ps, corpus, device)
    checks = 0
    for tt in (ps.tables, dataclasses.replace(ps.tables, dead_exit=False)):
        w = f"{what}: K3 dead_exit={tt.dead_exit}"
        agree("pair_scan", K3.pair_scan(st, tt), K3.pair_scan_plain(st, tt),
              w)
        agree("pair_scan", [K3.pair_scan(st, tt, emit="count", shift=1)],
              [K3.pair_scan_plain(st, tt, emit="count", shift=1)],
              f"{w} count")
        checks += 2
    return checks


def soak_phf(compiled, corpus, seed, device, what):
    """K5 over every shard whose tables ``PallasTables`` accepts and K4
    on each: bitmap mode at every ``SOAK_DEPTH_GEOMS`` geometry where the
    padded step count allows it (K5's rows equal to K4's bitmaps), count
    mode with shift 0 and 1 (up to 128 steps), ``dead_exit`` forced off,
    and a window viewed at an odd byte offset, against the plain
    versions.  -> (K4 checks, K5 checks, shards refused)."""
    from phfpfac_tpu_torch.ops import scan as K4
    from phfpfac_tpu_torch.ops.common import padded_steps

    pts, refused = [], 0
    for sh in compiled.shards:
        try:
            pts.append(K4.PallasTables(sh))
        except K4.PhfUnsupported:
            refused += 1
    if not pts:
        return 0, 0, refused
    ms = padded_steps(max(pt.max_pat_len for pt in pts))
    if ms > K4.MAX_COUNT_STEPS:
        return 0, 0, refused + len(pts)
    multi = K4.PhfKernelTables.from_tables(pts, device)
    singles = [K4.PhfKernelTables.from_tables([pt], device) for pt in pts]
    data = padded_window(corpus, ms, device)
    # the same bytes at an odd offset from a 16-byte boundary, random
    # bytes around them
    k = 1 + 2 * (seed % 8)
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(0, 256, data.numel() + 32,
                                        dtype=np.uint8)).to(device)
    view = buf[k:k + data.numel()]
    view.copy_(data)
    check(view.data_ptr() % 16 == k, f"{what}: view offset")
    n = len(corpus)
    kw = dict(input_size=n, max_steps=ms)
    c4 = c5 = 0
    bitmap = ms <= K4.MAX_BITMAP_STEPS
    if bitmap:
        for seg, halo in SOAK_DEPTH_GEOMS:
            g = dict(seg_bytes=seg, halo_bytes=halo, **kw)
            w = f"{what}: K5 seg={seg}+{halo}"
            got5 = K4.phf_scan_multi(data, multi, **g)
            agree("phf_scan_multi", got5,
                  K4.phf_scan_multi_plain(data, multi, **g), w)
            c5 += 1
            for si, t in enumerate(singles):
                got = K4.phf_scan(data, t, **g)
                agree("phf_scan", got, K4.phf_scan_plain(data, t, **g),
                      f"{what}: K4 shard {si} seg={seg}+{halo}")
                check(torch.equal(got[1], got5[1][si]),
                      f"{w}: K5's row {si} != K4's bitmap")
                c4 += 1
    for shift in (0, 1):
        agree("phf_scan_multi",
              [K4.phf_scan_multi(data, multi, emit="count", shift=shift,
                                 **kw)],
              [K4.phf_scan_multi_plain(data, multi, emit="count",
                                       shift=shift, **kw)],
              f"{what}: K5 count shift={shift}")
        c5 += 1
        for si, t in enumerate(singles):
            agree("phf_scan",
                  [K4.phf_scan(data, t, emit="count", shift=shift, **kw)],
                  [K4.phf_scan_plain(data, t, emit="count", shift=shift,
                                     **kw)],
                  f"{what}: K4 shard {si} count shift={shift}")
            c4 += 1
    # dead_exit forced off, and the window at an odd offset (both under
    # the soak's segment cut, bitmap mode where it fits)
    emit = dict() if bitmap else dict(emit="count", shift=1)
    seg = dict(seg_bytes=SOAK_SEG[0], halo_bytes=SOAK_SEG[1], **kw, **emit)
    off = dataclasses.replace(multi, dead_exit=False)
    for d, tt, w in ((data, off, "dead_exit off"),
                     (view, multi, f"a view at offset {k}")):
        got = K4.phf_scan_multi(d, tt, **seg)
        agree("phf_scan_multi", got if bitmap else [got],
              K4.phf_scan_multi_plain(data, tt, **seg) if bitmap
              else [K4.phf_scan_multi_plain(data, tt, **seg)],
              f"{what}: K5 {w}")
        c5 += 1
    one = singles[0]
    for d, tt, w in ((data, dataclasses.replace(one, dead_exit=False),
                      "dead_exit off"), (view, one, f"a view at {k}")):
        got = K4.phf_scan(d, tt, **seg)
        agree("phf_scan", got if bitmap else [got],
              K4.phf_scan_plain(data, tt, **seg) if bitmap
              else [K4.phf_scan_plain(data, tt, **seg)],
              f"{what}: K4 shard 0 {w}")
        c4 += 1
    return c4, c5, refused


def soak_phase(device) -> dict:
    """Over SOAK_SEEDS seeds (soak_case): K1, K1′ + K6, K2 and K3 on every
    shard, K5 over the shards and K4 on each (``soak_phf``), bit for bit
    against their plain versions, and ``Matcher.match_chunked`` on the
    card under a 512 + 64 B segment cut and in exact mode against the
    host oracle, and the compacted ``PlanMeshMatcher`` against it
    (``soak_mesh``).  Then, a seed, every route of ``chip_fuzz.py`` at
    one geometry it draws (exact, segment and charset arms in turn, on
    corpora of at most SOAK_E2E_BYTES): one-shot ``match`` with a ragged
    ``input_size``, ``match_chunked`` and the device-resident loop, the
    stream at random feed sizes, ``match_many``, ``count_matches``, the
    mesh matchers and the CLI's result file, each against the oracle.
    The first mismatch fails the run."""
    import chip_fuzz
    from phfpfac_tpu_torch.ops import depth as K2
    from phfpfac_tpu_torch.ops import pair as K3
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.oracle.ac import match_oracle
    from phfpfac_tpu_torch.parallel.matcher import Matcher
    from phfpfac_tpu_torch.utils.config import PfacConfig

    t0 = time.perf_counter()
    checks = dict(plan_scan=0, depth_scan=0, pair_scan=0, phf_scan=0,
                  phf_scan_multi=0, end_to_end=0, plan_mesh=0)
    p0_modes, kinds = set(), []
    routes, routes_refused, geometries = {}, {}, []
    refused = dict(plan=0, depth=0, pair=0, phf=0, plan_mesh=0)
    cfgs = {"segment": PfacConfig(width=4096, num_shards=2,
                                  truncation="segment",
                                  segment_bytes=SOAK_SEG[0],
                                  halo_bytes=SOAK_SEG[1]),
            "none": PfacConfig(width=4096, num_shards=2, truncation="none")}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in range(SOAK_SEEDS):
            kind, compiled, pats, corpus = soak_case(seed, tmp)
            kinds.append(kind)
            train = corpus[:MIB]
            for mode, cfg in cfgs.items():
                m = Matcher(compiled, cfg, device=device, train=train)
                got = m.match_chunked(corpus[:SOAK_E2E_BYTES],
                                      chunk_bytes=SOAK_E2E_BYTES // 4)
                # the second mode's matcher takes the tables built here
                compiled.plan_tables = m.built_plan_tables()
                if kind == "class":
                    want = class_oracle(pats, corpus[:SOAK_E2E_BYTES])
                else:
                    want = np.asarray(match_oracle(
                        pats, corpus[:SOAK_E2E_BYTES], cfg),
                        np.int64).reshape(-1, 2)
                check(np.array_equal(np.asarray(got).reshape(-1, 2), want),
                      f"soak seed {seed} ({kind}, {mode}): match_chunked "
                      f"!= the oracle")
                checks["end_to_end"] += 1
                ran = soak_mesh(compiled, cfg, train,
                                corpus[:SOAK_E2E_BYTES], got,
                                f"soak seed {seed} ({kind}, {mode})")
                checks["plan_mesh"] += ran
                refused["plan_mesh"] += 1 - ran
                if mode != "segment":
                    continue
                for si, (_k, sc) in enumerate(shard_kernels(m)):
                    if sc is None:
                        continue
                    what = f"soak seed {seed} ({kind}) shard {si}"
                    plan = sc if isinstance(sc, K1.PlanShardScanner) else \
                        _built(K1.PlanShardScanner, sc.shard, device=device,
                               train=train)
                    depth = _built(K2.DepthShardScanner, sc.shard,
                                   device=device)
                    pair = _built(K3.PairShardScanner, sc.shard,
                                  device=device)
                    for name, s, run in (("plan", plan, soak_plan),
                                         ("depth", depth, soak_depth),
                                         ("pair", pair, soak_pair)):
                        if s is None:
                            refused[name] += 1
                        else:
                            checks[f"{name}_scan"] += run(s, corpus, device,
                                                          what)
                    if plan is not None:
                        p0_modes.add(plan.tables.p0_mode)
            c4, c5, r = soak_phf(compiled, corpus, seed, device,
                                 f"soak seed {seed} ({kind})")
            checks["phf_scan"] += c4
            checks["phf_scan_multi"] += c5
            refused["phf"] += r
            fz = chip_fuzz.run_seed(
                seed, chip_fuzz.ARMS[seed % len(chip_fuzz.ARMS)], device,
                tmp, SOAK_E2E_BYTES)
            check(not fz.failures, f"soak seed {seed}: chip_fuzz routes "
                                   f"failed {fz.failures[:1]}")
            for k, v in fz.checks.items():
                routes[k] = routes.get(k, 0) + v
            for k, v in fz.refused.items():
                routes_refused[k] = routes_refused.get(k, 0) + len(v)
            geometries.append({k: fz.g[k] for k in (
                "source", "num_shards", "truncation", "segment_bytes",
                "halo_bytes", "input_size", "chunk_bytes")})
    check(p0_modes == {"dense", "s0", "s0x"},
          f"soak: the generators reached the prologues {sorted(p0_modes)}")
    check(all(checks.values()), f"soak: a kernel went unchecked {checks}")
    check(all(routes.get(k) for k in chip_fuzz.ROUTES),
          f"soak: a route went unchecked {routes}")
    return dict(seeds=SOAK_SEEDS, kinds=kinds, corpus_bytes=SOAK_BYTES,
                end_to_end_bytes=SOAK_E2E_BYTES, checks=checks,
                total_checks=sum(checks.values()), p0_modes=sorted(p0_modes),
                refused=refused, routes=routes,
                route_checks=sum(routes.values()),
                routes_refused=routes_refused, geometries=geometries,
                seconds=time.perf_counter() - t0)


# ---- the mesh, the two-rank run, --profile, the dry run ----------------------

def cell_devices(n: int = 4) -> list[str]:
    """``n`` mesh cells, all on the one card."""
    return [f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE] * n


def mesh_phase(dicts, device, reset_launches, read_launches):
    """The device mesh at full width, four cells on the one card:
    clamav5k's whole corpus under the CLI's segment cut through
    ``MultiHostMatcher.match`` and ``PlanMeshMatcher`` on (4,1), (2,2)
    and (1,4), uncompacted, compacted at an explicit (cut, cap) and with
    one forced overflow; ascii50k's through the turbo mesh; clamav5k's first window
    through the depth mesh in exact mode.  Every output equal to the
    single-device one."""
    from phfpfac_tpu_torch.ops import depth as K2
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.parallel.distributed import MultiHostMatcher
    from phfpfac_tpu_torch.parallel.matcher import Matcher
    from phfpfac_tpu_torch.parallel.mesh import make_mesh
    from phfpfac_tpu_torch.parallel.mesh_pallas import (
        PallasMeshMatcher,
        PlanMeshMatcher,
    )
    from phfpfac_tpu_torch.utils.config import PfacConfig

    cells = cell_devices()
    clam, asc = dicts["clamav5k"], dicts["ascii50k"]
    corpus, n = clam["corpus"], len(clam["corpus"])
    n_shards = len(clam["compiled"].shards)
    rows = []

    def timed_match(matcher, data, size):
        """(first seconds, second seconds, result)."""
        res, secs = [], []
        for _ in range(2):
            secs.append(host_seconds(
                lambda: res.append(matcher.match(data, input_size=size))))
        check(np.array_equal(res[0], res[1]), "a mesh scan is not repeatable")
        return secs[0], secs[1], res[0]

    # the serving wrapper: plan mesh first
    reset_launches()
    mh = MultiHostMatcher(clam["compiled"], clam["cfg"], devices=cells)
    first, again, got = timed_match(mh, corpus, n)
    check(mh.last_engine == "plan", f"MultiHostMatcher rode {mh.last_engine}")
    check(np.array_equal(got, clam["got"]),
          "MultiHostMatcher != the CLI's main-path output")
    shape = (mh._plan.mesh.shape["data"], mh._plan.mesh.shape["patterns"])
    counts = read_launches()
    check(counts["plan_scan"] == 2 * shape[0] * n_shards,
          f"MultiHostMatcher: {counts['plan_scan']} K1 launches on {shape}")
    rows.append(dict(matcher="MultiHostMatcher", dictionary="clamav5k",
                     mesh=shape, engine=mh.last_engine,
                     stacked=mh._plan.stacked is not None,
                     seconds_first=first, seconds=again,
                     launches_per_scan=counts["plan_scan"] // 2))
    mesh_launches = dict(counts)

    # the plan mesh on every shape, uncompacted and compacted
    for shape in ((4, 1), (2, 2), (1, 4)):
        t0 = time.perf_counter()
        pm = PlanMeshMatcher(clam["compiled"], clam["cfg"],
                             make_mesh(*shape, cells), train=corpus[:MIB])
        build = time.perf_counter() - t0
        # "auto" (opt-in: declines, K1 alone), then an explicit (cut, cap)
        # with room for every cell's survivors: K1' + K6 per cell
        for compact in ("auto", (1, 1 << 22)):
            pm.compact = compact
            reset_launches()
            rescans0 = K1.overflow_rescans
            first, again, got = timed_match(pm, corpus, n)
            check(np.array_equal(got, clam["got"]),
                  f"plan mesh {shape} compact={compact} != the CLI's output")
            counts = read_launches()
            per_scan = shape[0] * n_shards
            if compact == "auto":  # opt-in: the default route is K1
                check(counts["plan_scan"] == 2 * per_scan
                      and counts["plan_scan_compact_a"] == 0,
                      f"plan mesh {shape}: launches {counts}")
            else:
                check(counts["plan_scan_compact_a"] == counts["planb_scan"]
                      == 2 * per_scan and counts["plan_scan"] == 0
                      and K1.overflow_rescans == rescans0,
                      f"compacted plan mesh {shape}: launches {counts}")
            for k, v in counts.items():
                mesh_launches[k] = mesh_launches.get(k, 0) + v
            rows.append(dict(
                matcher="PlanMeshMatcher", dictionary="clamav5k", mesh=shape,
                compact=compact, stacked=pm.stacked is not None,
                table_build_seconds=build, seconds_first=first,
                seconds=again, launches_per_scan=per_scan,
                overflow_rescans=K1.overflow_rescans - rescans0))

    # one forced overflow: a cap of one block on every cell
    pm = PlanMeshMatcher(clam["compiled"], clam["cfg"],
                         make_mesh(4, 1, cells), train=corpus[:MIB],
                         compact=(1, K1.COMPACT_BLOCK))
    reset_launches()
    rescans0 = K1.overflow_rescans
    got = pm.match(corpus, input_size=n)
    counts = read_launches()
    check(K1.overflow_rescans - rescans0 == n_shards,
          "the forced mesh overflow did not rescan every shard")
    check(counts["plan_scan"] == counts["plan_scan_compact_a"]
          == 4 * n_shards, f"forced mesh overflow: launches {counts}")
    check(np.array_equal(got, clam["got"]),
          "the mesh's overflow rescan != the CLI's output")
    forced = dict(mesh=(4, 1), cap=K1.COMPACT_BLOCK,
                  rescans=K1.overflow_rescans - rescans0, equal=True)

    # ascii50k: its 40-64 B patterns make the plan tables refuse it
    reset_launches()
    mh = MultiHostMatcher(asc["compiled"], asc["cfg"], devices=cells)
    first, again, got = timed_match(mh, asc["corpus"], len(asc["corpus"]))
    check(mh.last_engine == "turbo" and mh._plan is None
          and mh._plan_refused,
          f"ascii50k rode {mh.last_engine}: the plan tables should refuse")
    check(not any(read_launches().values()),
          "the turbo mesh launched a kernel")
    check(np.array_equal(got, asc["got"]),
          "the turbo mesh != the CLI's main-path output")
    rows.append(dict(matcher="MultiHostMatcher", dictionary="ascii50k",
                     mesh=(mh.mesh.shape["data"], mh.mesh.shape["patterns"]),
                     engine="turbo", seconds_first=first, seconds=again))

    # the depth kernel per cell: exact mode, the first window
    window = corpus[:CHUNK]
    exact = PfacConfig(width=4096, num_shards=4, truncation="none")
    pm = PallasMeshMatcher(clam["compiled"], exact, make_mesh(1, 4, cells))
    reset_launches()
    first, again, got = timed_match(pm, window, len(window))
    check(K2.launches == 2 * n_shards,
          f"depth mesh: {K2.launches} K2 launches")
    mesh_launches["depth_scan"] = mesh_launches.get("depth_scan", 0) \
        + K2.launches
    want = Matcher(clam["compiled"], exact, device=device,
                   train=window[:MIB]).match(window)
    check(np.array_equal(got, want),
          "the depth mesh != the single-device matcher in exact mode")
    rows.append(dict(matcher="PallasMeshMatcher", dictionary="clamav5k",
                     mesh=(1, 4), truncation="none",
                     corpus_bytes=len(window), seconds_first=first,
                     seconds=again, matches=len(got)))
    return dict(cells=cells, corpus_bytes=n, rows=rows,
                forced_overflow=forced,
                single_device_match_seconds={
                    k: d["match_seconds"] for k, d in dicts.items()},
                identical_to_cli_output=True), mesh_launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def distributed_phase(d, tmp):
    """Two cooperating processes of the port's CLI over gloo, both on
    the one card, each scanning its half of the input file; rank 0's
    file against the single-process one.  A rank that dies or runs past
    its limit fails the run."""
    pat_file, in_file = d["files"]
    outs = [os.path.join(tmp, f"rank{r}.out") for r in range(2)]
    port = free_port()
    common = [sys.executable, "-m", "phfpfac_tpu_torch.cli", pat_file, "1",
              "4096", in_file, "--quiet", *d["flags"], "--device", DEVICE,
              "--coordinator", f"localhost:{port}", "--num-processes", "2"]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [*common, "--process-id", str(r), "-o", outs[r]], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        logs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for r, p in enumerate(procs):
        check(p.returncode == 0 and len(logs) == 2,
              f"rank {r} failed ({p.returncode}):\n{logs[-1][-2000:]}")
    check(os.path.exists(outs[0]) and not os.path.exists(outs[1]),
          "rank 0 alone writes the result file")
    with open(outs[0], "rb") as f, open(d["out"], "rb") as g:
        check(f.read() == g.read(),
              "the two-rank output != the single-process CLI's")
    return dict(ranks=2, backend="gloo", corpus_bytes=len(d["corpus"]),
                seconds=secs, single_process_cli_seconds=d["cli_seconds"],
                byte_identical=True)


def profile_phase(d, tmp):
    """The CLI with ``--profile``: the trace exists, names the plan
    kernel, and the output file is unchanged."""
    pat_file, in_file = d["files"]
    out = os.path.join(tmp, "profiled.out")
    prof = os.path.join(tmp, "profile")
    secs = run_cli([pat_file, 1, 4096, in_file, "-o", out, "--quiet",
                    *d["flags"], "--profile", prof])
    traces = [f for f in os.listdir(prof) if f.endswith(".trace.json")]
    check(len(traces) == 1, f"--profile wrote {traces}")
    path = os.path.join(prof, traces[0])
    with open(path, "rb") as f:
        text = f.read()
    check(DEVICE != "cuda" or b"plan_scan" in text,
          "the trace does not name the plan kernel")
    with open(out, "rb") as f, open(d["out"], "rb") as g:
        check(f.read() == g.read(), "--profile changed the output")
    return dict(cli_seconds=secs, unprofiled_cli_seconds=d["cli_seconds"],
                trace_bytes=len(text), names_plan_scan=b"plan_scan" in text,
                output_unchanged=True)


def stages_phase(name, d, device) -> dict:
    """``chip_e2e.py``'s ``stages`` arm once (one timed run after a
    warm-up) on a main-path deployment: ``match_chunked`` a stage at a
    time, held to the CLI's rows, the oracle around every chunk boundary
    and the plants; every wrapped function reached (the host tail only
    where a shard splits)."""
    import chip_e2e as e2e

    dep = e2e.Deployment(
        name=name, pats=d["pats"], plen=e2e.pattern_lengths(d["pats"]),
        corpus=d["corpus"], planted=d["planted"], files=d["files"],
        escapes=d["escapes"], cfg=d["cfg"], compiled=d["compiled"],
        matcher=d["matcher"], cli_rows=d["got"])
    r = e2e.stages(e2e.Run(device, reps=1), dep, reps=1)
    want = set(e2e.WRAPPED)
    if all(kind != "split" for kind, _ in d["kinds"]):
        want.discard("_host_literal_one")
    reached = {k for k, v in r["reached"].items() if v}
    check(reached == want, f"{name}: the stage wrappers reached "
          f"{sorted(reached)}, not {sorted(want)}")
    return r


WORDS_MIB = 8  # the words phase's corpus


def words_phase(device, tmp, patterns=None) -> dict:
    """``chip_e2e.py``'s ``big`` word regime cut to ``WORDS_MIB`` of its
    text: 156,000 titles in one shard, exact mode, through
    ``Matcher.match_chunked`` (K1), held to ``oracle/ac.py`` windows and
    every plant; K1 bit for bit against its plain version on the window,
    its count total equal to the rows of the patterns it walks."""
    import chip_e2e as e2e
    from phfpfac_tpu_torch.ops import plan as K1

    run = e2e.Run(device, reps=1, mib=WORDS_MIB, tmp=tmp, patterns=patterns)
    t0 = time.perf_counter()
    d = run.deployment("big")
    K1.launches = K1.launches_compact_a = K1.launches_compact_b = 0
    t1 = time.perf_counter()
    got = e2e.cli_rows(run, d)  # match_chunked, then the oracle and plants
    run.sync()
    t2 = time.perf_counter()
    launches = dict(plan_scan=K1.launches,
                    plan_scan_compact_a=K1.launches_compact_a,
                    planb_scan=K1.launches_compact_b)
    check(not run.card or launches["plan_scan"] > 0,
          "words: the plan kernel never ran")
    (_shard, sc), = e2e.plan_entries(d)
    staged, n = scan_inputs(sc, d.corpus[:CHUNK], device)
    t = sc.tables
    bits = K1.plan_scan(staged, t)
    agree("plan_scan", bits, K1.plan_scan_plain(staged, t),
          "words big: plan bitmap (exact)")
    total = K1.plan_scan(staged, t, emit="count")
    agree("plan_scan", [total], [K1.plan_scan_plain(staged, t, emit="count")],
          "words big: plan count")
    walked = int((d.plen[e2e.within(got, d.plen, 0, n)[:, 1]] <= 32).sum())
    check(int(total) == walked, f"words big: count {int(total)} != {walked} "
          "rows of the patterns K1 walks")
    return dict(d.build, dictionary="big", matches=len(got),
                matches_per_byte=len(got) / len(d.corpus),
                oracle_windows=1, planted_found=len(d.planted),
                build_seconds=t1 - t0, match_and_check_seconds=t2 - t1,
                launches=launches, parity=["bitmap+exact", "count"])


def host_seconds(fn) -> float:
    """Host-clock seconds of ``fn`` up to the end of its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=64,
                    help="main-path corpus size per dictionary")
    ap.add_argument("--soak", action="store_true",
                    help="build the kernels, run the soak phase alone and "
                         "stop (no result line)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from phfpfac_tpu_torch import _build, compile_dictionary
    from phfpfac_tpu_torch.frontend.patterns import Pattern
    from phfpfac_tpu_torch.compile.pair import PairUnsupported
    from phfpfac_tpu_torch.ops import depth as K2
    from phfpfac_tpu_torch.ops import engine_select, reference, turbo
    from phfpfac_tpu_torch.ops import pair as K3
    from phfpfac_tpu_torch.ops import plan as K1
    from phfpfac_tpu_torch.ops import scan as K4
    from phfpfac_tpu_torch.ops.common import padded_steps, walk_limits
    from phfpfac_tpu_torch.oracle.ac import match_oracle
    from phfpfac_tpu_torch.parallel import matcher as matcher_mod
    from phfpfac_tpu_torch.parallel.matcher import Matcher
    from phfpfac_tpu_torch.parallel.merge import render_result_file
    from phfpfac_tpu_torch.utils.config import PfacConfig

    device = torch.device(DEVICE)

    # ---- 0. device ----
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- 1. build ----
    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources=list(_build.SOURCES))

    if args.soak:
        emit("soak", **soak_phase(device))
        return 0

    rng = np.random.default_rng(args.seed)
    size = args.mib * MIB
    dicts = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 2. dictionaries ----
        printable = np.arange(32, 127, dtype=np.uint8)
        for name, pats, alphabet, escapes in (
            ("ascii50k", make_ascii50k(rng), printable, False),
            ("clamav5k", make_signatures(5000, seed=7), None, True),
        ):
            corpus, planted = make_corpus(rng, pats, size, alphabet)
            files = write_inputs(tmp, name, pats, corpus, escapes)
            cfg = PfacConfig(width=4096, num_shards=4, truncation="segment")
            t0 = time.perf_counter()
            compiled = compile_dictionary(files[0], cfg, escapes=escapes)
            t1 = time.perf_counter()
            # the CLI trains the plan layout on its first chunk's head
            matcher = Matcher(compiled, cfg, device=device,
                              train=corpus[:MIB])
            kinds = shard_kernels(matcher)
            t2 = time.perf_counter()
            dicts[name] = dict(pats=pats, corpus=corpus, planted=planted,
                               files=files, escapes=escapes, cfg=cfg,
                               compiled=compiled, matcher=matcher,
                               kinds=kinds)
            emit("dictionary", name=name, patterns=len(pats),
                 compile_seconds=t1 - t0, kernel_tables_seconds=t2 - t1,
                 shards=[dict(states=sh.state_num,
                              finals=sh.final_state_num,
                              max_pat_len=sh.max_pat_len, kernel=k[0])
                         for sh, k in zip(compiled.shards, kinds)])

        # lower50k: 36 symbols, scanned in exact mode over 16 MiB, 4
        # shards (the pair tables take a shard only while they fit the
        # entry's displacement field; a refusal fails the run)
        rng2 = np.random.default_rng(args.seed + 1)
        pats = make_stem_patterns(rng2, LOWER)
        lsize = min(CHUNK, size)
        corpus, planted = make_corpus(rng2, pats, lsize, LOWER,
                                      plants=PLANTS * lsize // size)
        files = write_inputs(tmp, "lower50k", pats, corpus, False)
        cfg = PfacConfig(width=4096, num_shards=4, truncation="none")
        t0 = time.perf_counter()
        compiled = compile_dictionary(files[0], cfg)
        t1 = time.perf_counter()
        # with the plan kernel first in line the matcher reaches the
        # pair kernel only where the plan tables refuse: they refuse here

        def plan_refuses(*a, **k):
            raise PairUnsupported("the plan kernel stands aside")

        with swapped(matcher_mod, "PlanShardScanner", plan_refuses):
            pair_matcher = Matcher(compiled, cfg, device=device,
                                   train=corpus[:MIB])
            pair_scanners = pair_matcher._get_scanners()
        check(all(isinstance(sc, K3.PairShardScanner)
                  for sc in pair_scanners),
              "build_pair_tables refused a shard of lower50k")
        t2 = time.perf_counter()
        lower = dict(pats=pats, corpus=corpus, planted=planted, files=files,
                     cfg=cfg, compiled=compiled, pair_scanners=pair_scanners,
                     pair_matcher=pair_matcher)
        emit("dictionary", name="lower50k", patterns=len(pats),
             corpus_bytes=lsize, num_shards=cfg.num_shards,
             compile_seconds=t1 - t0, kernel_tables_seconds=t2 - t1,
             shards=[dict(states=sh.state_num, finals=sh.final_state_num,
                          max_pat_len=sh.max_pat_len,
                          kernel="PairShardScanner",
                          code_bits=sc.pt.code_bits,
                          pair_steps=sc.pt.n_pair_steps,
                          dead_exit=sc.tables.dead_exit)
                     for sh, sc in zip(compiled.shards, pair_scanners)])

        # ---- 3. kernel parity on the card ----
        for name, d in dicts.items():
            window = d["corpus"][:CHUNK]
            d["recs"] = kernel_parity(name, d["kinds"], window, device)
            emit("parity", dictionary=name, kernel="plan_scan",
                 modes=["bitmap+segment", "bitmap+exact", "count"],
                 equal=True, matches=[r.get("matches") for r in d["recs"]])
        clam = dicts["clamav5k"]
        clam["depth_recs"] = depth_parity(
            "clamav5k", clam["compiled"], clam["recs"],
            clam["corpus"][:CHUNK], device)
        emit("parity", dictionary="clamav5k", kernel="depth_scan",
             modes=["bitmap+segment", "count"], equal=True,
             equal_to_plan_bitmap=True)

        lower["recs"] = pair_parity("lower50k", lower["pair_scanners"],
                                    lower["corpus"], device)
        emit("parity", dictionary="lower50k", kernel="pair_scan",
             modes=["bitmap+exact", "count"], equal=True,
             matches=[r["matches"] for r in lower["recs"]])
        clam_ms = padded_steps(clam["compiled"].max_pat_len)
        clam_n = min(CHUNK, size)  # bytes of clamav5k's first window
        phf_singles = [K4.PallasShardScanner(sh, device=device)
                       for sh in clam["compiled"].shards]
        # the matcher hands a dictionary to the multi kernel only when no
        # shard has a bitmap scanner: none is offered here
        with swapped(Matcher, "_shard_scanner_one",
                     lambda self, shard, pt=None: None):
            phf_matcher = Matcher(clam["compiled"], clam["cfg"],
                                  device=device)
            kind, phf_multi = phf_matcher._get_pallas_scanner()
        check(kind == "multi" and isinstance(phf_multi, K4.MultiShardScanner),
              f"clamav5k: the matcher's all-None route gave {kind!r}")
        clam["phf_data"] = phf_parity(
            "clamav5k", phf_singles, phf_multi, clam["corpus"][:CHUNK],
            clam_ms, device)
        emit("parity", dictionary="clamav5k", kernel="phf_scan",
             modes=["bitmap+segment", "bitmap+exact", "count"], equal=True,
             dead_exit=[sc.tables.dead_exit for sc in phf_singles])
        emit("parity", dictionary="clamav5k", kernel="phf_scan_multi",
             modes=["bitmap+segment", "count"], equal=True,
             rows_equal_phf_scan=True, dead_exit=phf_multi.tables.dead_exit)

        def reset_launches():
            K1.launches = K2.launches = K3.launches = 0
            K1.launches_compact_a = K1.launches_compact_b = 0
            K4.launches = K4.launches_multi = 0

        def read_launches():
            return dict(plan_scan=K1.launches, depth_scan=K2.launches,
                        pair_scan=K3.launches, phf_scan=K4.launches,
                        phf_scan_multi=K4.launches_multi,
                        plan_scan_compact_a=K1.launches_compact_a,
                        planb_scan=K1.launches_compact_b)

        # ---- 4. main path: the gphf CLI ----
        launches = {}
        for name, d in dicts.items():
            pat_file, in_file = d["files"]
            out = os.path.join(tmp, f"{name}.out")
            flags = ["--escapes"] if d["escapes"] else []
            reset_launches()
            secs = run_cli([pat_file, 1, 4096, in_file, "-o", out,
                            "--quiet", *flags])
            launches[name] = read_launches()
            d["out"], d["flags"], d["got"] = out, flags, None
            check(K1.launches > 0, f"{name}: the plan kernel never ran")
            check(K1.launches_compact_a == K1.launches_compact_b == 0,
                  f"{name}: the default route launched a compacted kernel")
            got = read_output(out)
            got_set = set(map(tuple, got.tolist()))
            missing = [p for p in d["planted"] if p not in got_set]
            check(not missing,
                  f"{name}: planted matches missing {missing[:5]}")
            input_size = len(d["corpus"])
            want_lines = plain_match_count(d["kinds"], d["matcher"],
                                           d["corpus"], input_size, device)
            check(len(got) == want_lines,
                  f"{name}: {len(got)} output lines, plain bitmaps say "
                  f"{want_lines}")
            d["cli_seconds"], d["got"] = secs, got
            # the match phase alone, on the tables built in phase 2
            t0 = time.perf_counter()
            d["matcher"].match_chunked(d["corpus"], input_size=input_size)
            torch.cuda.synchronize()
            d["match_seconds"] = time.perf_counter() - t0
            emit("main_path", dictionary=name, corpus_bytes=input_size,
                 seconds=secs, gb_per_s=input_size / secs / 1e9,
                 match_seconds=d["match_seconds"],
                 match_gb_per_s=input_size / d["match_seconds"] / 1e9,
                 output_lines=len(got), planted_found=len(d["planted"]),
                 launches=launches[name])
            emit("match_trace", dictionary=name,
                 **profile_match(d["matcher"], d["corpus"], input_size))

            # a small file, byte-identical to the oracle
            small = d["corpus"][: 256 * 1024]
            s_in = os.path.join(tmp, f"{name}.small")
            with open(s_in, "wb") as f:
                f.write(small + b"\n")
            s_out = os.path.join(tmp, f"{name}.small.out")
            run_cli([pat_file, 1, 4096, s_in, "-o", s_out, "--quiet",
                     *flags])
            pats = [Pattern(i + 1, p) for i, p in enumerate(d["pats"])]
            want = np.asarray(match_oracle(pats, small, d["cfg"]),
                              np.int64).reshape(-1, 2)
            with open(s_out) as f:
                check(f.read() == render_result_file(want),
                      f"{name}: 256 KiB output differs from the oracle")
            emit("oracle", dictionary=name, bytes=len(small),
                 matches=len(want), identical=True)

        # the match phase a stage at a time
        for name, d in dicts.items():
            emit("stages", dictionary=name, **stages_phase(name, d, device))

        # a word regime: 156,000 titles in one shard over English-like text
        reset_launches()
        r = words_phase(device, tmp)
        launches["words"] = r["launches"]
        emit("words", **r)

        # the depth kernel's path: a segment geometry the plan kernel
        # does not take (not a power of two) routes every shard to K2
        window = clam["corpus"][:CHUNK]
        cfg = PfacConfig(width=4096, num_shards=4, truncation="segment",
                         segment_bytes=6144, halo_bytes=HALO)
        dm = Matcher(clam["compiled"], cfg, device=device)
        reset_launches()
        t0 = time.perf_counter()
        got = dm.match_chunked(window)
        secs = time.perf_counter() - t0
        launches["depth_path"] = read_launches()
        check(K2.launches > 0, "the depth kernel never ran on its path")
        want_lines = 0
        for sc in dm._get_scanners():
            check(isinstance(sc, K2.DepthShardScanner),
                  "the depth path took another kernel")
            staged, n = scan_inputs(sc, window, device)
            cnt, _ = K2.depth_scan_plain(staged, sc.tables, input_size=n,
                                         seg_bytes=6144, halo_bytes=HALO)
            want_lines += int(cnt[:n].sum())
        check(len(got) == want_lines, "depth path != plain bitmaps")
        emit("depth_path", dictionary="clamav5k", corpus_bytes=len(window),
             segment_bytes=6144, seconds=secs, matches=len(got),
             launches=launches["depth_path"])

        # ---- 4b. the pair kernel's path: exact mode ----
        window = lower["corpus"]
        reset_launches()
        t0 = time.perf_counter()
        got = lower["pair_matcher"].match_chunked(window)
        secs = time.perf_counter() - t0
        launches["pair_path"] = read_launches()
        check(K3.launches > 0, "the pair kernel never ran on its path")
        lm = Matcher(lower["compiled"], lower["cfg"], device=device,
                     train=window[:MIB])
        want = lm.match_chunked(window)
        check(all(isinstance(sc, K1.PlanShardScanner)
                  for sc in lm._get_scanners()),
              "lower50k's matcher took another kernel than plan")
        check(np.array_equal(got, want),
              "pair path != the matcher's plan-kernel result")
        got_set = set(map(tuple, got.tolist()))
        missing = [p for p in lower["planted"] if p not in got_set]
        check(not missing,
              f"lower50k: planted matches missing {missing[:5]}")
        emit("pair_path", dictionary="lower50k", corpus_bytes=len(window),
             truncation="none", seconds=secs, matches=len(got),
             identical_to_plan_matcher=True,
             planted_found=len(lower["planted"]),
             launches=launches["pair_path"])

        # ---- 4c. the banked-PHF kernels' path: the CLI's segment cut ----
        reset_launches()
        t0 = time.perf_counter()
        got = phf_matcher.match_chunked(clam["corpus"],
                                        input_size=len(clam["corpus"]))
        secs = time.perf_counter() - t0
        launches["phf_path"] = read_launches()  # the matcher's: K5 only
        # K4's path is its scanner class: the first window per shard,
        # held to the rows K5 gives for the same window
        _cnt, bits0 = phf_multi.scan(clam["phf_data"], clam_n, clam["cfg"],
                                     clam_ms)
        for si, sc in enumerate(phf_singles):
            _cnt, b = sc.scan(clam["phf_data"], clam_n, clam["cfg"], clam_ms)
            check(torch.equal(b, bits0[si]),
                  f"phf path shard {si}: K4's bitmap != K5's row")
        launches["phf_path"]["phf_scan"] = K4.launches
        check(launches["phf_path"]["phf_scan_multi"] > 0,
              "the matcher's all-None route never ran the multi kernel")
        check(K4.launches > 0, "the one-shard PHF kernel never ran")
        check(np.array_equal(got, clam["got"]),
              "phf path != the plan kernel's CLI output")
        del bits0
        emit("phf_path", dictionary="clamav5k",
             corpus_bytes=len(clam["corpus"]), seconds=secs,
             matches=len(got), identical_to_cli_output=True,
             launches=launches["phf_path"])

        # ---- 4d. the torch-op engines through the CLI ----
        pat_file, in_file = clam["files"]
        engines = {}
        out = os.path.join(tmp, "clamav5k.turbo.out")
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        engines["turbo_seconds"] = run_cli(
            [pat_file, 1, 4096, in_file, "-o", out, "--quiet", "--escapes",
             "--engine", "turbo"])
        engines["turbo_peak_bytes"] = torch.cuda.max_memory_allocated()
        check(not any(read_launches().values()),
              "--engine turbo launched a kernel: it is the torch-op engine")
        engines["turbo_corpus_bytes"] = len(clam["corpus"])
        with open(out, "rb") as f, open(clam["out"], "rb") as g:
            check(f.read() == g.read(),
                  "--engine turbo output differs from --engine pallas")
        # --engine jnp keeps [positions, 32] int32 match rows per shard
        # (128 B per position: 8 GiB at 64 MiB), so it runs on a cut
        jsize = min(JNP_MIB * MIB, len(clam["corpus"]))
        j_in = os.path.join(tmp, "clamav5k.jnp.in")
        with open(j_in, "wb") as f:
            f.write(clam["corpus"][:jsize] + b"\n")
        outs = {}
        for engine in ("pallas", "jnp"):
            outs[engine] = os.path.join(tmp, f"clamav5k.{engine}.small.out")
            torch.cuda.reset_peak_memory_stats()
            secs = run_cli([pat_file, 1, 4096, j_in, "-o", outs[engine],
                            "--quiet", "--escapes", "--engine", engine])
            engines[f"{engine}_small_seconds"] = secs
            engines[f"{engine}_small_peak_bytes"] = \
                torch.cuda.max_memory_allocated()
        engines["jnp_corpus_bytes"] = jsize
        with open(outs["jnp"], "rb") as f, open(outs["pallas"], "rb") as g:
            check(f.read() == g.read(),
                  "--engine jnp output differs from --engine pallas")
        counts = clam["matcher"].count_matches(
            clam["corpus"], input_size=len(clam["corpus"]))
        check(int(counts.sum()) == len(clam["got"]),
              f"count_matches sums to {int(counts.sum())}, the CLI wrote "
              f"{len(clam['got'])} lines")
        sh0 = clam["compiled"].shards[0]
        best = engine_select.best_count_scanner(
            sh0, clam_ms, train=clam["corpus"][:MIB], device=device)
        check(isinstance(best, K1.PlanCountScan),
              "best_count_scanner: not the plan kernel for clamav5k")
        staged = best.prepare(clam["phf_data"], clam_n)
        total = int(best.scan(staged, clam_n, 0))
        check(total == int(K1.plan_scan_plain(staged, best.scanner.tables,
                                              emit="count")),
              "best_count_scanner != its plain count")
        check(total == int(engine_select.xla_count_scanner(
            sh0, clam_ms, device=device)(clam["phf_data"], clam_n, 0)),
              "best_count_scanner != the torch-op count scanner")
        del staged
        emit("engines", dictionary="clamav5k", identical_to_pallas=True,
             count_matches_sum=int(counts.sum()),
             best_count_scanner=type(best).__name__,
             shard0_count_first_window=total, **engines)

        # per-shard seconds of the two torch-op engines on their own
        cfg = clam["cfg"]
        tt = turbo.build_turbo_tables(sh0)
        engine_secs = dict(
            turbo_bytes=clam_n,
            scan_shard_turbo=host_seconds(lambda: turbo.scan_shard_turbo(
                sh0, clam["phf_data"], clam_n, cfg, max_steps=clam_ms,
                turbo_tables=tt, device=device)))
        small = padded_window(clam["corpus"][:jsize], clam_ms, device)
        limits = walk_limits(small.shape[0] - clam_ms, jsize,
                             sh0.max_pat_len, cfg)
        engine_secs.update(
            reference_bytes=jsize,
            reference_scan_shard=host_seconds(lambda: reference.scan_shard(
                sh0, small, limits, jsize, slots=sh0.max_pat_len,
                device=device)))
        del small

        # ---- 4e. the compacted plan scan: parity, then its path ----
        for name, d in dicts.items():
            rows, overflow = compact_parity(name, d, device)
            emit("compact_parity", dictionary=name,
                 kernels=["plan_scan_compact_a", "planb_scan"],
                 modes=["bitmap+segment", "bitmap+exact", "count"],
                 equal=True, equal_to_plan_scan=True, cases=rows,
                 forced_overflow=overflow)
        for name, d in dicts.items():
            reset_launches()
            r = compact_path(name, d, device, matcher_mod)
            launches[f"compact_path/{name}"] = r["launches"]
            emit("compact_path", **r)

        # ---- 4f. the rest of the single-device surface ----
        # built plan tables ride along from here on, as --load-tables
        # gives them to a fresh process
        for d in dicts.values():
            d["compiled"].plan_tables = d["matcher"].built_plan_tables()
        ascii_d = dicts["ascii50k"]
        emit("device_data", dictionary="ascii50k",
             corpus_bytes=len(ascii_d["corpus"]),
             **device_data_phase(ascii_d))
        emit("stream", dictionary="clamav5k",
             **stream_phase(clam, clam["cfg"], clam["corpus"], FEED, device))
        exact = PfacConfig(width=4096, num_shards=4, truncation="none")
        emit("stream", dictionary="ascii50k",
             **stream_phase(ascii_d, exact, ascii_d["corpus"][:CHUNK], FEED,
                            device))
        emit("match_many", dictionary="clamav5k",
             **match_many_phase(clam, rng, device))
        for name, d in dicts.items():
            emit("tables", **tables_phase(name, d, tmp))
        emit("charset", **charset_phase(
            np.random.default_rng(args.seed + 2), tmp, device))

        # ---- 4g. the probe kernels: parity, then their sweeps ----
        emit("probe_parity", **probe_parity(device))
        g_rows, c_rows, probe_launches, p1, p2 = probes_phase(device)
        launches["probes"] = probe_launches
        emit("probes", gather=g_rows, compact=c_rows,
             launches=probe_launches,
             kernels_line=dict(probe_gather=p1, probe_compact=p2))

        # ---- 4h. the mesh, two ranks, --profile, the dry run ----
        r, launches["mesh"] = mesh_phase(dicts, device, reset_launches,
                                         read_launches)
        emit("mesh", **r, launches=launches["mesh"])
        _build.build_all()  # the ranks find every kernel built
        emit("distributed", dictionary="clamav5k",
             **distributed_phase(clam, tmp))
        emit("profile", dictionary="clamav5k", **profile_phase(clam, tmp))
        from phfpfac_tpu_torch.dryrun import dryrun_multichip

        t0 = time.perf_counter()
        dry = dryrun_multichip(4, devices=cell_devices())
        emit("dryrun", cells=cell_devices(),
             seconds=time.perf_counter() - t0, **dry)

    # ---- 4i. the soak: random dictionaries through the scan kernels ----
    emit("soak", **soak_phase(device))

    # ---- 5. times ----
    ct = {name: compact_times(name, d) for name, d in dicts.items()}
    for name, r in ct.items():
        emit("compact_times", dictionary=name,
             per="16 MiB chunk, 4 shards", **r)
    k3, k4, k5 = time_new_kernels(lower["recs"], phf_singles, phf_multi,
                                  clam["phf_data"], clam_n, clam_ms)
    for label, r, per in (
            ("pair_scan/lower50k", k3, "16 MiB chunk, 4 shards"),
            ("phf_scan/clamav5k", k4, "16 MiB chunk, 4 shards"),
            ("phf_scan_multi/clamav5k", k5,
             "16 MiB chunk, one launch for 4 shards")):
        emit("times", kernel=label, per=per, **r)
    emit("times", kernel="torch engines, one shard of clamav5k",
         **engine_secs)
    k1, _ = time_kernels(dicts["ascii50k"]["recs"], [])
    k1c, k2 = time_kernels(clam["recs"], clam["depth_recs"])
    gb = gather_bounds(g_rows, dicts, lower, ct, phf_singles, device)
    geometry = K1.plan_kernel_geometry(device)
    for name, r in (("ascii50k", k1), ("clamav5k", k1c)):
        # K1 beside both bounds: bytes and dependent gathers, per mode
        r.update(gather_bound_ms=gb[f"plan_scan/{name}"]["gather_bound_ms"],
                 count_gather_bound_ms=gb[f"plan_scan_count/{name}"][
                     "gather_bound_ms"],
                 share_of_bytes_bound=r["bound_ms"] / r["ms"],
                 count_share_of_bytes_bound=r["count_bound_ms"]
                 / r["count_ms"], geometry=geometry)
    for label, r in (("plan_scan/ascii50k", k1), ("plan_scan/clamav5k", k1c),
                     ("depth_scan/clamav5k", k2)):
        emit("times", kernel=label, per="16 MiB chunk, 4 shards", **r)
    for name, d in dicts.items():
        emit("times", kernel="cli", dictionary=name,
             seconds=d["cli_seconds"],
             gb_per_s=len(d["corpus"]) / d["cli_seconds"] / 1e9)

    measured = {"plan_scan/ascii50k": k1["ms"], "plan_scan/clamav5k":
                k1c["ms"], "plan_scan_count/ascii50k": k1["count_ms"],
                "plan_scan_count/clamav5k": k1c["count_ms"],
                "depth_scan/clamav5k": k2["ms"],
                "pair_scan/lower50k": k3["ms"], "phf_scan/clamav5k":
                k4["ms"], "phf_scan_multi/clamav5k": k5["ms"]}
    for name, r in ct.items():
        measured[f"plan_scan_compact_a/{name}"] = r["a_ms"]
        measured[f"planb_scan/{name}"] = r["b_ms"]
    for label, r in gb.items():
        r["ms"] = measured[label]
    emit("gather_bounds", per="16 MiB chunk, 4 shards",
         rate="per table (the prologue's and each step's, at its own "
              "size): the best rate probe_gather measured for int32 over "
              "the swept tables no larger than it", **gb)
    emit("lane_stats", modelled=True,
         source="the plain versions' live walkers on one 16 MiB window, "
                "4 shards; one walker per thread, 32 positions a warp",
         **walk_lane_stats(clam, lower))
    for label, r in gb.items():
        # a bound that a kernel beats is no bound
        check(r["ms"] >= r["gather_bound_ms"],
              f"{label}: {r['ms']} ms is under its gather bound "
              f"{r['gather_bound_ms']} ms")

    # ---- 6. kernels ----
    kernels = [
        dict(name="plan_scan", route="cuda",
             source="phfpfac_tpu_torch/csrc/plan_scan.cu",
             replaces="phfpfac_tpu/ops/pallas_plan.py:729",
             launches=launches["ascii50k"]["plan_scan"],
             max_abs_err=MAX_ERR["plan_scan"], ms=k1["ms"],
             plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by="bytes", library_ms=None,
             library_note=NO_LIBRARY,
             detail={"ascii50k": k1, "clamav5k": k1c,
                     "launches": launches}),
        dict(name="depth_scan", route="cuda",
             source="phfpfac_tpu_torch/csrc/depth_scan.cu",
             replaces="phfpfac_tpu/ops/pallas_depth.py:113",
             launches=launches["depth_path"]["depth_scan"],
             max_abs_err=MAX_ERR["depth_scan"], ms=k2["ms"],
             plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by="bytes", library_ms=None,
             library_note=NO_LIBRARY, detail={"clamav5k": k2}),
        dict(name="pair_scan", route="cuda",
             source="phfpfac_tpu_torch/csrc/pair_scan.cu",
             replaces="phfpfac_tpu/ops/pallas_pair.py:119",
             launches=launches["pair_path"]["pair_scan"],
             max_abs_err=MAX_ERR["pair_scan"], ms=k3["ms"],
             plain_ms=k3["plain_ms"],
             bound_ms=k3["bound_ms"], bound_by="bytes", library_ms=None,
             library_note=NO_LIBRARY, detail={"lower50k": k3}),
        dict(name="phf_scan", route="cuda",
             source="phfpfac_tpu_torch/csrc/phf_scan.cu",
             replaces="phfpfac_tpu/ops/pallas_scan.py:132",
             launches=launches["phf_path"]["phf_scan"],
             max_abs_err=MAX_ERR["phf_scan"], ms=k4["ms"],
             plain_ms=k4["plain_ms"],
             bound_ms=k4["bound_ms"], bound_by="bytes", library_ms=None,
             library_note=NO_LIBRARY, detail={"clamav5k": k4}),
        dict(name="phf_scan_multi", route="cuda",
             source="phfpfac_tpu_torch/csrc/phf_scan.cu",
             replaces="phfpfac_tpu/ops/pallas_scan.py:358",
             launches=launches["phf_path"]["phf_scan_multi"],
             max_abs_err=MAX_ERR["phf_scan_multi"], ms=k5["ms"],
             plain_ms=k5["plain_ms"],
             bound_ms=k5["bound_ms"], bound_by="bytes", library_ms=None,
             library_note=NO_LIBRARY, detail={"clamav5k": k5}),
        dict(name="plan_scan_compact_a", route="cuda",
             source="phfpfac_tpu_torch/csrc/plan_scan.cu",
             replaces="phfpfac_tpu/ops/pallas_plan.py:1292",
             launches=launches["compact_path/ascii50k"][
                 "plan_scan_compact_a"],
             max_abs_err=MAX_ERR["plan_scan_compact_a"],
             ms=ct["ascii50k"]["a_ms"],
             plain_ms=ct["ascii50k"]["a_plain_ms"],
             bound_ms=ct["ascii50k"]["a_bound_ms"], bound_by="bytes",
             library_ms=None, library_note=NO_LIBRARY, detail=ct),
        dict(name="planb_scan", route="cuda",
             source="phfpfac_tpu_torch/csrc/planb_scan.cu",
             replaces="phfpfac_tpu/ops/pallas_plan.py:1109",
             launches=launches["compact_path/ascii50k"]["planb_scan"],
             max_abs_err=MAX_ERR["planb_scan"],
             ms=ct["ascii50k"]["b_ms"],
             plain_ms=ct["ascii50k"]["b_plain_ms"],
             bound_ms=ct["ascii50k"]["b_bound_ms"], bound_by="bytes",
             library_ms=None, library_note=NO_LIBRARY,
             detail={"launches": {k: v for k, v in launches.items()
                                  if k.startswith("compact_path")},
                     **{name: {k: v for k, v in r.items()
                               if "b_" in k or k in ("survivors", "cap")}
                        for name, r in ct.items()}}),
    ]
    kernels += [
        dict(name="probe_gather", route="cuda",
             source="phfpfac_tpu_torch/csrc/probe_gather.cu",
             replaces="bench/lane_probe.py:97",
             launches=launches["probes"]["probe_gather"],
             max_abs_err=MAX_ERR["probe_gather"], ms=p1["ms"],
             plain_ms=p1["plain_ms"], bound_ms=p1["bound_ms"],
             bound_by="bytes", library_ms=None,
             library_note="no single PyTorch call computes a chain of "
                          "dependent gathers",
             detail=dict(p1, also_replaces=[
                 "bench/lane_probe.py:133", "bench/ilp_probe.py:65",
                 "bench/micro_tpu.py:113", "bench/micro_tpu.py:155",
                 "bench/micro_tpu.py:208", "bench/lane_iso.py:35"])),
        dict(name="probe_compact", route="cuda",
             source="phfpfac_tpu_torch/csrc/probe_compact.cu",
             replaces="bench/pack_probe.py:171",
             launches=launches["probes"]["probe_compact"],
             max_abs_err=MAX_ERR["probe_compact"], ms=p2["ms"],
             plain_ms=p2["plain_ms"], bound_ms=p2["bound_ms"],
             bound_by="bytes", library_ms=p2["library_ms"],
             library_note="boolean indexing, disp[disp != 0]: one "
                          "compaction of the whole input, not per tile",
             detail=dict(p2, also_replaces=["bench/pack_probe.py:201"],
                         launches=launches["probes"])),
    ]
    on_its_data = {"plan_scan": "plan_scan/ascii50k",
                   "depth_scan": "depth_scan/clamav5k",
                   "pair_scan": "pair_scan/lower50k",
                   "phf_scan": "phf_scan/clamav5k",
                   "phf_scan_multi": "phf_scan_multi/clamav5k",
                   "plan_scan_compact_a": "plan_scan_compact_a/ascii50k",
                   "planb_scan": "planb_scan/ascii50k"}
    for k in kernels:
        k.update({key: v for key, v in
                  gb.get(on_its_data.get(k["name"]), {}).items()
                  if key not in ("ms", "lane_stats")})
        check(k["launches"] > 0, f"{k['name']}: no launch on its path")
    for name in ("plan_scan", "plan_scan_compact_a", "planb_scan",
                 "depth_scan"):
        check(launches["mesh"].get(name, 0) > 0,
              f"{name}: no launch on the mesh path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
