"""The ordered multi-shard decode (``Matcher._dispatch`` with a chunk,
``ops/bitmap.py::decode_hits`` over every shard, the native
``pfac_decode_ordered``): its rows equal the oracle's and those of the
per-shard composition it replaces (each shard's hits decoded alone, cut
to the chunk's body and moved to its base, then ``merge_flat_matches``),
whatever the shard count, cut, chunk size or thread count; and it
engages only where every shard takes it."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from phfpfac_tpu_torch import Matcher, PfacConfig, compile_patterns
from phfpfac_tpu_torch.compile import native
from phfpfac_tpu_torch.compile.tables import compile_class_patterns
from phfpfac_tpu_torch.frontend import charset as tcs
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops.bitmap import decode_hits, fetch_hit_bits
from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
from phfpfac_tpu_torch.ops.staging import to_device_bytes
from phfpfac_tpu_torch.oracle.ac import match_oracle, match_oracle_charset
from phfpfac_tpu_torch.parallel.matcher import _POS_PAD
from phfpfac_tpu_torch.parallel.merge import merge_flat_matches
from phfpfac_tpu_torch.utils import profile as P

ALPHA = np.frombuffer(b"abcdef .", dtype=np.uint8)
# (config keyword arguments, chunk sizes that put matches across edges)
MODES = {
    "segment": (dict(truncation="segment", segment_bytes=512,
                     halo_bytes=8), (1024, 1536)),
    "exact": (dict(truncation="none"), (1000, 1777)),
}


def _words(seed, n=150):
    rng = np.random.default_rng(seed)
    return list(dict.fromkeys(
        bytes(ALPHA[rng.integers(0, len(ALPHA), int(rng.integers(1, 14)))])
        for _ in range(n)))


def _text(seed, size=6000):
    rng = np.random.default_rng(seed)
    return bytes(ALPHA[rng.integers(0, len(ALPHA), size)])


def _matcher(words, shards, mode):
    cfg = PfacConfig(width=256, num_shards=shards, **MODES[mode][0])
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    return Matcher(compile_patterns(pats, cfg), cfg, device="cpu"), pats, cfg


def captured(fn):
    """(fn's result, the counters it recorded)."""
    before = P.snapshot()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, P.difference(before, P.snapshot())["counters"]


def composed(m, data, chunk_bytes):
    """The per-shard composition, called directly: each chunk's window
    scanned by each shard, its hits decoded alone (``decode_hits``), cut
    to the body and moved to the base, the shards merged last."""
    chunk, overlap, _wpad = m._chunk_geometry(chunk_bytes)
    max_steps = padded_steps(m.compiled.max_pat_len)
    per_shard = [[] for _ in m.compiled.shards]
    for base in range(0, len(data), chunk):
        body = min(chunk, len(data) - base)
        window = data[base:base + body + overlap]
        padded = to_device_bytes(pad_input(window, _POS_PAD, max_steps),
                                 "cpu")
        for s, (ds, shard) in enumerate(zip(m._get_scanners(),
                                            m.compiled.shards)):
            _cnt, _bits, verify = ds.scan_async(padded, len(window),
                                                m.config, max_steps)
            pos, hb = fetch_hit_bits(verify()[1], len(window))
            f = decode_hits(hb, pos, window, len(window), shard, max_steps)
            f = f[f[:, 0] < body]
            f[:, 0] += base
            per_shard[s].append(f)
    return merge_flat_matches(
        m.compiled, [np.concatenate(p) for p in per_shard], len(data))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shards", [1, 4, 7])
def test_equals_oracle_and_per_shard_composition(shards, mode):
    m, pats, cfg = _matcher(_words(5), shards, mode)
    text = _text(6)
    want = np.asarray(match_oracle(pats, text, cfg), np.int64)
    got, counters = captured(lambda: m.match(text))
    np.testing.assert_array_equal(got, want)
    assert counters["merge.ordered"] == 1
    for chunk in MODES[mode][1]:
        got, counters = captured(
            lambda: m.match_chunked(text, chunk_bytes=chunk))
        np.testing.assert_array_equal(got, want)
        assert counters["merge.ordered"] == 1
        assert not {"merge.inorder", "merge.argsort",
                    "merge.lexsort"} & set(counters)
        np.testing.assert_array_equal(composed(m, text, chunk), want)
    assert len(want) > 1000


@pytest.mark.parametrize("case", ["straddling_duplicate", "silent_shard"])
def test_shard_edge_cases(case):
    """A pattern twice, once each side of a shard boundary, gives a row in
    each shard; a shard whose patterns never occur gives none."""
    if case == "straddling_duplicate":
        # sorted: ab abc b | b bc c -- one "b" in each shard
        words, shards = [b"b", b"ab", b"bc", b"b", b"abc", b"c"], 2
    else:
        # sorted: a.. b.. | zq zr zz -- the second shard is never hit
        words, shards = [b"ab", b"a", b"ba", b"zq", b"zr", b"zz"], 2
    m, pats, cfg = _matcher(words, shards, "exact")
    text = _text(7, 4000)
    want = np.asarray(match_oracle(pats, text, cfg), np.int64)
    for chunk in MODES["exact"][1]:
        got = m.match_chunked(text, chunk_bytes=chunk)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(composed(m, text, chunk), want)
    if case == "straddling_duplicate":
        ids = {p.pattern_id for p in pats if p.data == b"b"}
        at = want[np.isin(want[:, 1], list(ids))]
        assert len(ids) == 2 and len(at) == 2 * len(np.unique(at[:, 0]))
    else:
        assert not np.isin(want[:, 1], [4, 5, 6]).any() and len(want)


def _bitmaps(shards, text, rng, junk):
    """Each shard's hits over ``text``: bit t at p where a pattern of
    length t + 1 starts at p, plus ``junk`` bits no pattern holds (the
    decode drops them: gaps in its output slices)."""
    arr = np.frombuffer(text, np.uint8)
    out = []
    for sh in shards:
        bits = np.zeros(len(arr), np.uint32)
        for pat in sh.patterns:
            L = len(pat)
            win = np.lib.stride_tricks.sliding_window_view(arr, L)
            hit = (win == np.frombuffer(pat, np.uint8)).all(axis=1)
            bits[:len(hit)][hit] |= np.uint32(1 << (L - 1))
        bits[rng.integers(0, len(arr), junk)] |= np.uint32(1 << 30)
        pos = np.nonzero(bits)[0].astype(np.int64)
        out.append((pos, bits[pos]))
    return out


def test_threaded_split_is_exact():
    """Above the threading threshold (65,536 hits) the ordered decode's
    rows do not depend on the thread count, and equal each shard's hash
    decode, its ids mapped, merged in (pos, shard, step) order."""
    if not native.available():
        pytest.skip("the native library is not built")
    rng = np.random.default_rng(11)
    words = [b"a", b"ab", b"abc", b"b", b"ba", b"c", b"ca", b"cab", b"a"]
    cfg = PfacConfig(width=256, num_shards=3)
    compiled = compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)], cfg)
    text = bytes(np.frombuffer(b"abc", np.uint8)[
        rng.integers(0, 3, 100_000)])
    hits = _bitmaps(compiled.shards, text, rng, junk=500)
    assert sum(len(p) for p, _ in hits) >= 1 << 16
    arr = np.frombuffer(text, np.uint8)
    flats = [native.decode_hits_hash_native(hb, pos, arr, sh, 32)
             for (pos, hb), sh in zip(hits, compiled.shards)]
    want = merge_flat_matches(compiled, flats, len(text))
    want[:, 0] += 1000
    for threads in (1, 3, 8):
        got = native.decode_ordered_native(
            [hb for _p, hb in hits], [p for p, _hb in hits], arr,
            compiled.shards, 32, base=1000, n_threads=threads)
        np.testing.assert_array_equal(got, want)
    assert len(want) > 1 << 16


def _class_route(monkeypatch):
    pats = [tcs.parse_class_pattern(s, i + 1) for i, s in
            enumerate([b"[ab]c", b"bc", b"c", b"[a-c]b", b"ab"])]
    cfg = PfacConfig(width=512, num_shards=2)
    data = bytes(np.random.default_rng(3).integers(97, 100, 3000)
                 .astype(np.uint8))
    return (Matcher(compile_class_patterns(pats, cfg), cfg, device="cpu"),
            data, match_oracle_charset(pats, data, cfg), "merge.charset")


def _split_route(monkeypatch):
    words = _words(8, 60)
    long = b"abcdef" * 6  # 36 B: the shard splits, a host literal tail
    text = bytearray(_text(9, 5000))
    text[700:700 + len(long)] = long
    text = bytes(text)
    m, pats, cfg = _matcher(words + [long], 2, "exact")
    return m, text, match_oracle(pats, text, cfg), "merge.argsort"


def _multi_route(monkeypatch):
    """No shard offered a scanner of its own: the multi kernel."""
    monkeypatch.setattr(Matcher, "_shard_scanner_one",
                        lambda self, shard, pt=None: None)
    words = _words(10, 60)
    cfg = PfacConfig(width=256, num_shards=3)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    text = _text(12, 5000)
    return (Matcher(compile_patterns(pats, cfg), cfg, device="cpu"), text,
            match_oracle(pats, text, cfg), "merge.argsort")


@pytest.mark.parametrize("route", [_class_route, _split_route, _multi_route],
                         ids=["charset", "split_shard", "multi"])
def test_old_routes_keep_their_merge(route, monkeypatch):
    m, data, want, path = route(monkeypatch)
    for call in (lambda: m.match(data),
                 lambda: m.match_chunked(data, chunk_bytes=1024)):
        got, counters = captured(call)
        assert [tuple(x) for x in got.tolist()] == \
            [tuple(x) for x in want]
        assert "merge.ordered" not in counters
        assert counters[path] == 1, counters
    kind, entries = m._get_pallas_scanner()
    assert not m._takes_ordered(kind, entries)
