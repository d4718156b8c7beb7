"""The port's Matcher vs the JAX Matcher (pallas engine, interpret mode)
and the oracle: exact equality of the (position, pattern id) lists."""

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
from phfpfac_tpu_torch.ops.plan import PlanShardScanner
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
    assert entry[0] == "split" and len(entry[1][3]) == 3


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
    # more than 8 patterns past the bitmap: the turbo tail engine
    words, data = _corpus(41, n_long=10, n_words=40)
    cfg = PfacConfig(width=256, num_shards=1)
    tm = Matcher(compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)], cfg), cfg,
        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.match(data)
    # no shard has a bitmap kernel: the multi-shard kernel K5
    pats = [Pattern(1, b"x" * 40), Pattern(2, b"y" * 50)]
    tm = Matcher(compile_patterns(pats, cfg), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="K5"):
        tm.match(b"x" * 45)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PfacConfig(width=256, num_shards=1)
    compiled = compile_patterns([Pattern(1, b"ab")], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Matcher(compiled, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Matcher(compiled, cfg, device="cuda")
    assert Matcher(compiled, cfg, device="cpu").device.type == "cpu"
