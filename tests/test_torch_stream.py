"""Streaming and batched serving (phfpfac_tpu_torch.parallel.stream) vs
the JAX package's StreamMatcher / match_many and the oracle, on
generated data.  (position, pattern id) lists, compared exactly."""

import numpy as np
import pytest

from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.parallel.matcher import Matcher as JaxMatcher
from phfpfac_tpu.parallel.stream import StreamMatcher as JaxStreamMatcher
from phfpfac_tpu.parallel.stream import match_many as jax_match_many
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import Matcher, PfacConfig, compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import plan as tplan
from phfpfac_tpu_torch.oracle.ac import match_oracle
from phfpfac_tpu_torch.parallel import matcher as tmatcher
from phfpfac_tpu_torch.parallel.stream import StreamMatcher, match_many


def _corpus(seed=5, size=6000, n_words=120):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcde t.", dtype=np.uint8)
    words = [
        bytes(alpha[rng.integers(0, len(alpha), int(rng.integers(1, 12)))])
        for _ in range(n_words)
    ] + [b"the", b"there", b"cat", b"aaaa", b"aa", b"a"]
    words = list(dict.fromkeys(words))
    data = b"aaathe cat aaaa" * 20 + bytes(
        alpha[rng.integers(0, len(alpha), size)])
    return words, data


def _mk(words, *, shards=2, jax_too=False, **kw):
    kw = {"width": 256, "num_shards": shards, "truncation": "none", **kw}
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    cfg = PfacConfig(**kw)
    compiled = compile_patterns(pats, cfg)
    if not jax_too:
        return pats, cfg, compiled
    jcfg = JaxConfig(**kw)
    jcompiled = jax_compile(
        [JaxPattern(i + 1, w) for i, w in enumerate(words)], jcfg)
    return pats, cfg, compiled, jcfg, jcompiled


def _tuples(a):
    return [tuple(x) for x in np.asarray(a).tolist()]


@pytest.mark.parametrize("engine", ["pallas", "turbo"])
@pytest.mark.parametrize("chunk_size", [1, 7, 100, 1000, 5000])
def test_stream_equals_whole_buffer(chunk_size, engine):
    words, data = _corpus()
    if chunk_size == 1:
        data = data[:700]
    pats, cfg, compiled = _mk(words)
    sm = StreamMatcher(compiled, cfg, engine=engine, device="cpu")
    got = []
    for i in range(0, len(data), chunk_size):
        got += _tuples(sm.feed(data[i: i + chunk_size]))
    want = match_oracle(pats, data, cfg)
    # exactly once, every match, in order of arrival of the last byte
    assert sorted(got) == sorted(want) and len(want) > 100
    assert len(got) == len(set(got))
    assert sm.finish().shape == (0, 2)


@pytest.mark.parametrize("chunk_size", [100, 1500])
def test_stream_feeds_equal_jax_feeds(chunk_size):
    words, data = _corpus(seed=6, size=3000)
    _pats, cfg, compiled, jcfg, jcompiled = _mk(words, jax_too=True)
    sm = StreamMatcher(compiled, cfg, device="cpu")
    jsm = JaxStreamMatcher(jcompiled, jcfg)
    assert sm.matcher.engine == "pallas"  # the port's Matcher default
    n = 0
    for i in range(0, len(data), chunk_size):
        chunk = data[i: i + chunk_size]
        mine = _tuples(sm.feed(chunk))
        assert mine == _tuples(jsm.feed(chunk))
        n += len(mine)
    assert n > 100


def test_stream_match_straddles_feeds():
    _pats, cfg, compiled = _mk([b"straddlingmatch"], shards=1)
    sm = StreamMatcher(compiled, cfg, device="cpu")
    a = sm.feed(b"xxxxstraddl")
    b = sm.feed(b"ingmatchyyy")
    assert a.size == 0
    assert _tuples(b) == [(4, 1)]
    assert sm.feed(b"").shape == (0, 2)


@pytest.mark.parametrize("engine", ["pallas", "turbo"])
@pytest.mark.parametrize("chunk_size", [61, 512, 700, 5000])
def test_stream_segment_mode_equals_one_shot(chunk_size, engine):
    """Union of the feeds + finish() == one scan with the same segment
    geometry, exactly once."""
    words, data = _corpus(seed=8, size=9000)
    _pats, cfg, compiled = _mk(words, truncation="segment",
                               segment_bytes=512, halo_bytes=64)
    sm = StreamMatcher(compiled, cfg, engine=engine, device="cpu")
    got = []
    for i in range(0, len(data), chunk_size):
        got += _tuples(sm.feed(data[i: i + chunk_size]))
    flushed = _tuples(sm.finish())
    assert flushed  # the last partial segment waits for finish()
    got += flushed
    want = _tuples(Matcher(compiled, cfg, engine=engine, device="cpu")
                   .match(data))
    assert sorted(got) == sorted(want) and len(want) > 100
    assert len(got) == len(set(got))


def test_stream_segment_mode_equals_jax():
    words, data = _corpus(seed=9, size=4000)
    _pats, cfg, compiled, jcfg, jcompiled = _mk(
        words, jax_too=True, truncation="segment", segment_bytes=512,
        halo_bytes=32)
    sm = StreamMatcher(compiled, cfg, device="cpu")
    jsm = JaxStreamMatcher(jcompiled, jcfg)
    for i in range(0, len(data), 777):
        assert _tuples(sm.feed(data[i: i + 777])) == \
            _tuples(jsm.feed(data[i: i + 777]))
    last = _tuples(sm.finish())
    assert last and last == _tuples(jsm.finish())


@pytest.mark.parametrize("engine", ["pallas", "turbo"])
def test_feed_async_pipelines(engine):
    """Several feeds dispatched before any resolves: the results equal
    the synchronous feed sequence."""
    words, _ = _corpus()
    data = b"the cat dog aaaa " * 300
    pats, cfg, compiled = _mk(words)
    sync = StreamMatcher(compiled, cfg, engine=engine, device="cpu")
    pipe = StreamMatcher(compiled, cfg, engine=engine, device="cpu")
    chunks = [data[i: i + 997] for i in range(0, len(data), 997)]
    want = []
    for c in chunks:
        want += _tuples(sync.feed(c))
    resolvers = [pipe.feed_async(c) for c in chunks]
    got = []
    for r in resolvers:
        got += _tuples(r())
    assert got == want
    assert sorted(got) == sorted(match_oracle(pats, data, cfg))


def test_feed_async_dispatches_before_it_resolves(monkeypatch):
    """The kernel engine scans at feed time and fetches at resolve
    time: every scan call precedes the first decode."""
    events = []
    scan = tplan.PlanShardScanner.scan_async
    decode = tmatcher.decode_hits
    monkeypatch.setattr(
        tplan.PlanShardScanner, "scan_async",
        lambda self, *a, **k: (events.append("scan"),
                               scan(self, *a, **k))[1])
    monkeypatch.setattr(
        tmatcher, "decode_hits",
        lambda *a, **k: (events.append("decode"), decode(*a, **k))[1])
    _pats, cfg, compiled = _mk([b"the", b"cat", b"aaaa"])  # 2 shards
    sm = StreamMatcher(compiled, cfg, device="cpu")
    r1 = sm.feed_async(b"the cat aaaa " * 40)
    r2 = sm.feed_async(b"cat the aaaa " * 40)
    assert events == ["scan"] * 4  # 2 feeds x 2 shards, nothing decoded
    m1, m2 = r1(), r2()
    assert events[4:] == ["decode"] * 4
    assert m1.size and m2.size


def test_stream_without_a_kernel_path_scans_with_match():
    """Patterns past the 32-step bitmap in every shard: ``_dispatch``
    returns None and the resolver goes through ``Matcher.match``."""
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"abcd", dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(alpha[rng.integers(0, 4, 40)]) for _ in range(30)))
    data = bytearray(alpha[rng.integers(0, 4, 3000)])
    for j, w in enumerate(words[:10]):
        data[250 * j + 230: 250 * j + 230 + len(w)] = w
    data = bytes(data)
    pats, cfg, compiled = _mk(words, shards=1)
    sm = StreamMatcher(compiled, cfg, device="cpu")
    assert sm.matcher._dispatch(data[:500], 500) is None
    got = []
    for i in range(0, len(data), 250):
        got += _tuples(sm.feed(data[i: i + 250]))
    assert sorted(got) == sorted(match_oracle(pats, data, cfg))
    assert len(got) >= 10


def test_match_many_per_buffer():
    words, data = _corpus(seed=10, size=12_000)
    pats, cfg, compiled, jcfg, jcompiled = _mk(words, jax_too=True)
    m = Matcher(compiled, cfg, device="cpu")
    bufs = [data[i * 997: (i + 1) * 997] for i in range(12)]
    outs = match_many(m, bufs)
    jouts = jax_match_many(JaxMatcher(jcompiled, jcfg, engine="turbo"), bufs)
    assert len(outs) == len(bufs)
    for buf, out, jout in zip(bufs, outs, jouts):
        assert _tuples(out) == match_oracle(pats, buf, cfg)
        assert _tuples(out) == _tuples(jout)
    assert sum(len(o) for o in outs) > 100
    assert match_many(m, []) == []


def test_match_many_drops_boundary_straddlers():
    _pats, cfg, compiled = _mk([b"abcd"], shards=1)
    m = Matcher(compiled, cfg, device="cpu")
    outs = match_many(m, [b"xxab", b"cdxx", b"abcd"])
    assert outs[0].size == 0 and outs[1].size == 0
    assert _tuples(outs[2]) == [(0, 1)]
    assert [o.shape for o in match_many(m, [b"xx", b"yy"])] == [(0, 2)] * 2


def test_stream_needs_pattern_bytes():
    _pats, cfg, compiled = _mk([b"abc", b"bcd"], shards=1)
    compiled.shards[0].patterns = None
    m = Matcher(compiled, cfg, engine="turbo", device="cpu")
    with pytest.raises(ValueError, match="match_many needs"):
        match_many(m, [b"abcd", b"bcda"])
    sm = StreamMatcher(compiled, cfg, engine="turbo", device="cpu")
    with pytest.raises(ValueError, match="StreamMatcher needs"):
        sm.feed(b"xabcd")
