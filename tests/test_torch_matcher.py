"""The port's Matcher vs the JAX Matcher (every engine; the Pallas
kernels in interpret mode) and the oracle: exact equality of the
(position, pattern id) lists, the match rows and the counts."""

import numpy as np
import pytest
import torch

from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.parallel.matcher import Matcher as JaxMatcher
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import Matcher, PfacConfig, compile_patterns
from phfpfac_tpu_torch import convert
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops.depth import DepthShardScanner
from phfpfac_tpu_torch.ops.pair import PairShardScanner
from phfpfac_tpu_torch.ops.plan import PlanShardScanner
from phfpfac_tpu_torch.ops.scan import MultiShardScanner
from phfpfac_tpu_torch.ops.turbo import TurboTables
from phfpfac_tpu_torch.oracle.ac import match_oracle


def _corpus(seed, n_long=0, n_words=150, size=5000):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdef .", dtype=np.uint8)
    short = [
        bytes(alpha[rng.integers(0, len(alpha), int(rng.integers(1, 14)))])
        for _ in range(n_words)
    ]
    long = [
        bytes(alpha[rng.integers(0, len(alpha), int(rng.integers(33, 44)))])
        for _ in range(n_long)
    ]
    words = list(dict.fromkeys(short + long))
    text = bytearray(alpha[rng.integers(0, len(alpha), size)])
    for j, w in enumerate(long):
        o = 500 * (j + 1) - 20  # some straddle segment cuts
        text[o:o + len(w)] = w
    return words, bytes(text)


def _cfg(cls, shards, trunc, **kw):
    return cls(width=256, num_shards=shards, truncation=trunc,
               segment_bytes=512, halo_bytes=8, **kw)


def _both(words, data, shards, trunc, chunk=None):
    """(port result, JAX result, oracle) as lists of (pos, id)."""
    tcfg = _cfg(PfacConfig, shards, trunc)
    tm = Matcher(compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)], tcfg), tcfg,
        device="cpu")
    jcfg = _cfg(JaxConfig, shards, trunc, interpret=True)
    jm = JaxMatcher(jax_compile(
        [JaxPattern(i + 1, w) for i, w in enumerate(words)], jcfg), jcfg,
        engine="pallas")
    # the JAX side scans unchunked: match_chunked == match is its own
    # contract, and one scan per shard keeps the interpreter cheap
    got = tm.match_chunked(data, chunk_bytes=chunk) if chunk else \
        tm.match(data)
    want = jm.match(data)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    return ([tuple(x) for x in got.tolist()],
            [tuple(x) for x in want.tolist()],
            match_oracle(pats, data, tcfg), tm)


@pytest.mark.parametrize("trunc", ["segment", "none"])
@pytest.mark.parametrize("shards", [1, 4, 5])
def test_match_equals_jax_and_oracle(shards, trunc):
    words, data = _corpus(shards)
    got, want, oracle, tm = _both(words, data, shards, trunc)
    assert got == want == oracle
    assert all(isinstance(s, PlanShardScanner) for s in tm._get_scanners())


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_match_chunked_equals_jax_and_oracle(trunc):
    words, data = _corpus(9, size=7000)
    got, want, oracle, _tm = _both(words, data, 4, trunc, chunk=1024)
    assert got == want == oracle


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_long_pattern_split_host_tail(trunc):
    words, data = _corpus(41, n_long=3, n_words=40)
    got, want, oracle, tm = _both(words, data, 1, trunc)
    assert got == want == oracle
    (entry,) = tm._get_scanners()
    kind, host_pats = entry[1][4]  # the tail's engine: a host search
    assert entry[0] == "split" and kind == "host" and len(host_pats) == 3


def test_non_power_of_two_segment_rides_the_depth_kernel():
    words, data = _corpus(3)
    cfg = PfacConfig(width=256, num_shards=2, truncation="segment",
                     segment_bytes=500, halo_bytes=20)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    tm = Matcher(compile_patterns(pats, cfg), cfg, device="cpu")
    got = [tuple(x) for x in tm.match_chunked(data, chunk_bytes=1000)]
    assert got == match_oracle(pats, data, cfg)
    assert all(isinstance(s, DepthShardScanner) for s in tm._get_scanners())


def test_compiled_from_jax_npz(tmp_path):
    words, data = _corpus(5)
    jcfg = JaxConfig(width=256, num_shards=3)
    jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                jcfg).save(tmp_path / "d.npz")
    cfg = PfacConfig(width=256, num_shards=3)
    tm = Matcher(convert.compiled_from_npz(tmp_path / "d.npz"), cfg,
                 device="cpu")
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    assert [tuple(x) for x in tm.match(data)] == match_oracle(pats, data,
                                                              cfg)


def test_unported_paths_raise():
    # every single-device Matcher path is ported; what is left to refuse
    # is a staged corpus of another chunk geometry and an unknown engine
    words, data = _corpus(3, n_words=20)
    cfg = PfacConfig(width=256, num_shards=1)
    tm = Matcher(compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)], cfg), cfg,
        device="cpu")
    short = tm.stage_for_chunked(data, chunk_bytes=512)
    with pytest.raises(ValueError, match="device_data too short"):
        tm.match_chunked(data, chunk_bytes=2048, device_data=short)
    with pytest.raises(ValueError, match="engine"):
        Matcher(tm.compiled, cfg, engine="xla", device="cpu")


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_device_resident_chunking_equals_chunked_and_match(trunc):
    """One upload (stage_for_chunked), every window a view of it."""
    words, data = _corpus(12, size=9000)
    cfg = _cfg(PfacConfig, 3, trunc)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    tm = Matcher(compile_patterns(pats, cfg), cfg, device="cpu")
    staged = tm.stage_for_chunked(data, chunk_bytes=1024)
    assert isinstance(staged, torch.Tensor) and staged.dtype == torch.uint8
    windows = []
    real = tm._dispatch
    tm._dispatch = lambda w, n, padded_dev=None, **kw: (
        windows.append(padded_dev) or real(w, n, padded_dev=padded_dev,
                                           **kw))
    got = tm.match_chunked(data, chunk_bytes=1024, device_data=staged)
    assert len(windows) == 9 and len({w.shape for w in windows}) == 1
    assert all(w.untyped_storage().data_ptr()
               == staged.untyped_storage().data_ptr() for w in windows)
    chunked = tm.match_chunked(data, chunk_bytes=1024)
    assert windows[-1] is None  # the plain loop pads and uploads itself
    want = match_oracle(pats, data, cfg)
    assert [tuple(x) for x in got.tolist()] == want
    assert [tuple(x) for x in chunked.tolist()] == want
    assert [tuple(x) for x in tm.match(data).tolist()] == want
    # input_size below the staged length, as the CLI passes it
    part = tm.match_chunked(data, input_size=len(data) - 1,
                            chunk_bytes=1024, device_data=staged)
    assert [tuple(x) for x in part.tolist()] == \
        match_oracle(pats, data[:-1], cfg)


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_compaction_opt_in_gives_the_same_matches(monkeypatch, trunc):
    """With the opt-in set and a trained scanner, "auto" compacts; the
    matches do not change, and without it no compacted scan is made."""
    from phfpfac_tpu_torch.ops import plan as tplan

    words, data = _corpus(21, n_words=200, size=45_000)
    cfg = _cfg(PfacConfig, 2, trunc)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    compiled = compile_patterns(pats, cfg)
    monkeypatch.delenv(tplan.AUTO_OPT_IN, raising=False)
    real, calls = tplan.plan_scan_compact, []
    monkeypatch.setattr(
        tplan, "plan_scan_compact",
        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = Matcher(compiled, cfg, device="cpu", train=data[:8192]).match(data)
    assert not calls
    monkeypatch.setenv(tplan.AUTO_OPT_IN, "1")
    tm = Matcher(compiled, cfg, device="cpu", train=data[:8192])
    got = tm.match(data)
    assert len(calls) == 2  # one per shard
    assert all(isinstance(s, PlanShardScanner) and s.pt.trained
               for s in tm._get_scanners())
    np.testing.assert_array_equal(got, want)
    assert [tuple(x) for x in got.tolist()] == match_oracle(pats, data, cfg)
    # chunks too small to compact (cap * 2 >= n_pos) scan uncompacted
    chunked = tm.match_chunked(data, chunk_bytes=8192)
    assert len(calls) == 2
    np.testing.assert_array_equal(chunked, want)


def _matchers(words, shards, trunc, engine, **kw):
    tcfg = _cfg(PfacConfig, shards, trunc)
    tm = Matcher(compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)], tcfg), tcfg,
        engine=engine, device="cpu", **kw)
    jcfg = _cfg(JaxConfig, shards, trunc, interpret=True)
    jm = JaxMatcher(jax_compile(
        [JaxPattern(i + 1, w) for i, w in enumerate(words)], jcfg), jcfg,
        engine=engine, **kw)
    return tm, jm


def _oracle(words, data, tm):
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    return np.asarray(match_oracle(pats, data, tm.config),
                      np.int64).reshape(-1, 2)


@pytest.mark.parametrize("trunc", ["segment", "none"])
@pytest.mark.parametrize("engine", ["pallas", "turbo", "jnp"])
def test_engines_equal_jax_and_oracle(engine, trunc):
    words, data = _corpus(12, size=3000)
    tm, jm = _matchers(words, 3, trunc, engine)
    got = tm.match(data)
    np.testing.assert_array_equal(got, jm.match(data))
    np.testing.assert_array_equal(got, _oracle(words, data, tm))
    # only the kernel engine chunks; the others fall through to match
    np.testing.assert_array_equal(tm.match_chunked(data, chunk_bytes=1024),
                                  got)
    assert len(got) > 100


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_count_matches_equals_jax(trunc):
    words, data = _corpus(13, size=3000)
    tm, jm = _matchers(words, 3, trunc, "turbo")
    got = tm.count_matches(data)
    np.testing.assert_array_equal(got, jm.count_matches(data))
    assert got.dtype == np.int64 and got.shape == (len(data),)
    assert got.sum() == len(tm.match(data))


def test_count_matches_and_turbo_on_compaction_overflow():
    # every walker survives the full-width steps: the turbo scan reports
    # overflow and the dense engine answers, exactly
    words = [b"a" * k for k in range(1, 13)]
    data = b"a" * 2500
    tm, jm = _matchers(words, 1, "none", "turbo", turbo_cap_frac=64)
    np.testing.assert_array_equal(tm.count_matches(data),
                                  jm.count_matches(data))
    got = tm.match(data)
    np.testing.assert_array_equal(got, jm.match(data))
    np.testing.assert_array_equal(got, _oracle(words, data, tm))


@pytest.mark.parametrize("engine", ["pallas", "turbo", "jnp"])
def test_match_rows_equals_jax(engine):
    words, data = _corpus(14, size=2000)
    tm, jm = _matchers(words, 2, "segment", engine)
    got, want = tm.match_rows(data), jm.match_rows(data)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert (g >= 0).any()


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_long_tail_of_more_than_8_patterns_rides_the_turbo_engine(trunc):
    words, data = _corpus(41, n_long=10, n_words=40)
    tm, jm = _matchers(words, 1, trunc, "pallas")
    got = tm.match(data)
    np.testing.assert_array_equal(got, jm.match(data))
    np.testing.assert_array_equal(got, _oracle(words, data, tm))
    (entry,) = tm._get_scanners()
    assert entry[0] == "split"
    assert isinstance(entry[1][4], TurboTables)
    chunked = tm.match_chunked(data, chunk_bytes=1024)
    np.testing.assert_array_equal(chunked, got)


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_all_long_dictionary_goes_multi_then_turbo(trunc):
    # no bitmap kernel takes any shard -> the multi kernel, which stops
    # at 32 steps -> the turbo engine answers
    rng = np.random.default_rng(8)
    alpha = np.frombuffer(b"abc", dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(alpha[rng.integers(0, 3, int(rng.integers(33, 48)))])
        for _ in range(12)))
    text = bytearray(alpha[rng.integers(0, 3, 3000)])
    for j, w in enumerate(words):
        o = 240 * (j + 1) - 20
        text[o:o + len(w)] = w
    data = bytes(text)
    tm, jm = _matchers(words, 2, trunc, "pallas")
    got = tm.match_chunked(data, chunk_bytes=1024)
    np.testing.assert_array_equal(got, jm.match(data))
    np.testing.assert_array_equal(got, _oracle(words, data, tm))
    assert tm._get_pallas_scanner()[0] == jm._get_pallas_scanner()[0] \
        == "multi"
    assert len(got) >= 6


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_multi_kernel_branch_equals_jax(trunc, monkeypatch):
    # reached by refusing every per-shard scanner in both packages
    words, data = _corpus(15, size=2500)
    tm, jm = _matchers(words, 3, trunc, "pallas")
    monkeypatch.setattr(Matcher, "_shard_scanner_one",
                        lambda self, shard, pt=None: None)
    monkeypatch.setattr(JaxMatcher, "_shard_scanner_one",
                        lambda self, shard, pt=None: None)
    got = tm.match(data)
    assert isinstance(tm._get_pallas_scanner()[1], MultiShardScanner)
    assert jm._get_pallas_scanner()[0] == "multi"
    np.testing.assert_array_equal(got, jm.match(data))
    np.testing.assert_array_equal(got, _oracle(words, data, tm))
    np.testing.assert_array_equal(tm.match_chunked(data, chunk_bytes=1024),
                                  got)


def test_exact_mode_tries_the_pair_kernel_after_plan(monkeypatch):
    from phfpfac_tpu.ops import pallas_plan as jax_plan
    from phfpfac_tpu_torch.compile.pair import PairUnsupported
    from phfpfac_tpu_torch.parallel import matcher as tmatcher

    def refuse(*a, **k):
        raise PairUnsupported("plan tables refused (test)")

    monkeypatch.setattr(tmatcher, "PlanShardScanner", refuse)
    monkeypatch.setattr(jax_plan, "PlanShardScanner", refuse)
    words, data = _corpus(16, size=2500)
    tm, jm = _matchers(words, 2, "none", "pallas")
    got = tm.match_chunked(data, chunk_bytes=1024)
    assert all(isinstance(s, PairShardScanner) for s in tm._get_scanners())
    assert all(type(s).__name__ == "PairShardScanner"
               for s in jm._get_pallas_scanner()[1])
    np.testing.assert_array_equal(got, jm.match(data))
    np.testing.assert_array_equal(got, _oracle(words, data, tm))
    # under the segment cut the pair kernel is not tried: depth takes over
    tm2, _ = _matchers(words, 2, "segment", "pallas")
    assert all(isinstance(s, DepthShardScanner) for s in tm2._get_scanners())


def test_unexpected_scanner_errors_propagate(monkeypatch):
    # the JAX matcher warns and falls back on any exception; the port
    # raises what is not a table build's refusal
    from phfpfac_tpu_torch.parallel import matcher as tmatcher

    def fault(*a, **k):
        raise RuntimeError("a fault, not a refusal")

    monkeypatch.setattr(tmatcher, "PlanShardScanner", fault)
    words, data = _corpus(3, n_words=20)
    tm, _ = _matchers(words, 1, "none", "pallas")
    with pytest.raises(RuntimeError, match="fault"):
        tm.match(data)


@pytest.mark.parametrize("refusal", [False, True])
def test_multi_scanner_refusal_vs_fault(refusal, monkeypatch):
    # only the banked-PHF tables' own refusal sends the dictionary to
    # the turbo engine; a plain ValueError from the build is a fault
    from phfpfac_tpu_torch.ops.scan import PhfUnsupported
    from phfpfac_tpu_torch.parallel import matcher as tmatcher

    exc = PhfUnsupported if refusal else ValueError

    def build(*a, **k):
        raise exc("multi build (test)")

    monkeypatch.setattr(Matcher, "_shard_scanner_one",
                        lambda self, shard, pt=None: None)
    monkeypatch.setattr(tmatcher, "MultiShardScanner", build)
    words, data = _corpus(15, size=2500)
    tm, _ = _matchers(words, 2, "none", "pallas")
    if refusal:
        got = tm.match(data)
        assert tm._get_pallas_scanner()[0] == "turbo"
        np.testing.assert_array_equal(got, _oracle(words, data, tm))
    else:
        with pytest.raises(ValueError, match="multi build"):
            tm.match(data)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PfacConfig(width=256, num_shards=1)
    compiled = compile_patterns([Pattern(1, b"ab")], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Matcher(compiled, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Matcher(compiled, cfg, device="cuda")
    assert Matcher(compiled, cfg, device="cpu").device.type == "cpu"
