"""The port's turbo mesh (parallel.mesh) against the JAX package's, on an
8-cell CPU mesh: the same seeded bytes and dictionary through both,
results compared exactly (tolerance 0: integers and match lists)."""

import numpy as np
import pytest

from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.parallel import mesh as jax_mesh
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.convert import stacked_tables_from_arrays
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.oracle.ac import match_oracle
from phfpfac_tpu_torch.parallel.matcher import Matcher
from phfpfac_tpu_torch.parallel.mesh import (
    DistributedMatcher,
    make_mesh,
    mesh_blocks,
    stack_tables,
)
from phfpfac_tpu_torch.utils.config import PfacConfig

CPU8 = ["cpu"] * 8
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]


def _words_and_data(n_words=50, data_len=9000, seed=5):
    rng = np.random.default_rng(seed)
    words = list(dict.fromkeys(
        bytes(rng.integers(97, 104, rng.integers(1, 8)).astype(np.uint8))
        for _ in range(n_words)))
    data = bytes(rng.integers(97, 104, data_len).astype(np.uint8))
    return words, data


def _both(words, **cfg_kw):
    """(port patterns, cfg, compiled), (JAX cfg, compiled)."""
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    cfg = PfacConfig(**cfg_kw)
    jcfg = JaxConfig(**cfg_kw)
    jcomp = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                        jcfg)
    return (pats, cfg, compile_patterns(pats, cfg)), (jcfg, jcomp)


def _tuples(m):
    return [tuple(x) for x in np.asarray(m).tolist()]


@pytest.mark.parametrize("num_shards", [1, 4])
def test_stack_tables_equal_to_jax(num_shards):
    words, _ = _words_and_data(n_words=120)
    (_p, _cfg, comp), (_jcfg, jcomp) = _both(words, width=512,
                                              num_shards=num_shards)
    mine, theirs = stack_tables(comp), jax_mesh.stack_tables(jcomp)
    for f in ("s0", "r", "tbl_a", "tbl_b", "width_bit", "row_bits", "dead",
              "num_final"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f), f)
    assert mine.is_packed == theirs.is_packed
    assert mine.max_pat_len == theirs.max_pat_len
    carried = stacked_tables_from_arrays(**vars(theirs))
    np.testing.assert_array_equal(carried.tbl_a, mine.tbl_a)


@pytest.mark.parametrize("truncation", ["segment", "none"])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_match_and_count_equal_to_jax(mesh_shape, truncation):
    n_data, n_pat = mesh_shape
    words, data = _words_and_data()
    kw = dict(width=512, num_shards=n_pat, truncation=truncation,
              segment_bytes=1024, halo_bytes=4)
    (pats, cfg, comp), (jcfg, jcomp) = _both(words, **kw)
    dm = DistributedMatcher(comp, cfg, make_mesh(n_data, n_pat, CPU8))
    jm = jax_mesh.DistributedMatcher(jcomp, jcfg,
                                     jax_mesh.make_mesh(n_data, n_pat))
    got = dm.match(data)
    np.testing.assert_array_equal(got, np.asarray(jm.match(data)))
    assert _tuples(got) == match_oracle(pats, data, cfg)
    np.testing.assert_array_equal(dm.count_matches(data),
                                  jm.count_matches(data))


def test_matches_single_device_turbo_engine():
    words, data = _words_and_data(seed=9)
    (_p, cfg, comp), _ = _both(words, width=512, num_shards=4)
    dm = DistributedMatcher(comp, cfg, make_mesh(2, 4, CPU8))
    sm = Matcher(comp, cfg, engine="turbo", device="cpu")
    np.testing.assert_array_equal(dm.match(data), sm.match(data))


def test_several_shards_per_cell():
    words, data = _words_and_data(seed=13)
    (pats, cfg, comp), (jcfg, jcomp) = _both(words, width=512, num_shards=8)
    dm = DistributedMatcher(comp, cfg, make_mesh(4, 2, CPU8))
    assert dm.shards_per_cell == 4
    jm = jax_mesh.DistributedMatcher(jcomp, jcfg, jax_mesh.make_mesh(4, 2))
    got = dm.match(data, input_size=len(data) - 7)
    np.testing.assert_array_equal(
        got, np.asarray(jm.match(data, input_size=len(data) - 7)))
    assert _tuples(dm.match(data)) == match_oracle(pats, data, cfg)


@pytest.mark.parametrize("block_end", [2048, 4096, 6144])
def test_match_straddling_a_block_boundary(block_end):
    pat = b"straddle"
    (_p, cfg, comp), _ = _both([pat], width=256, num_shards=1)
    buf = bytearray(b"." * (8 * 2048))
    start = block_end - 3
    buf[start:start + len(pat)] = pat
    dm = DistributedMatcher(comp, cfg, make_mesh(8, 1, CPU8))
    assert _tuples(dm.match(bytes(buf))) == [(start, 1)]


def test_halo_is_the_right_neighbours_head_and_wraps():
    import torch

    corpus = torch.arange(32, dtype=torch.uint8)
    ext = mesh_blocks(make_mesh(4, 2, CPU8), corpus, 8, 3)
    assert ext[0][1].tolist() == list(range(8)) + [8, 9, 10]
    assert ext[3][0].tolist() == list(range(24, 32)) + [0, 1, 2]


@pytest.mark.parametrize("counts", [False, True])
def test_overflow_goes_to_the_dense_fallback(counts, monkeypatch):
    words, data = [b"z" * 20], b"z" * 4096
    (pats, cfg, comp), (jcfg, jcomp) = _both(words, width=256, num_shards=1)
    dm = DistributedMatcher(comp, cfg, make_mesh(8, 1, CPU8), cap_frac=64)
    jm = jax_mesh.DistributedMatcher(jcomp, jcfg, jax_mesh.make_mesh(8, 1),
                                     cap_frac=64)
    calls = []
    real = DistributedMatcher._dense_fallback
    monkeypatch.setattr(
        DistributedMatcher, "_dense_fallback",
        lambda self, *a: calls.append(1) or real(self, *a))
    if counts:
        np.testing.assert_array_equal(dm.count_matches(data),
                                      jm.count_matches(data))
    else:
        got = dm.match(data)
        np.testing.assert_array_equal(got, np.asarray(jm.match(data)))
        assert _tuples(got) == match_oracle(pats, data, cfg)
    assert calls == [1]


def test_shard_count_must_divide_the_patterns_axis():
    words, _ = _words_and_data()
    (_p, cfg, comp), _ = _both(words, width=512, num_shards=3)
    with pytest.raises(ValueError, match="not divisible"):
        DistributedMatcher(comp, cfg, make_mesh(4, 2, CPU8))


def test_make_mesh_names_only_the_devices_given():
    import torch

    mesh = make_mesh(2, 2, ["cpu"] * 5)
    assert mesh.shape == {"data": 2, "patterns": 2}
    assert mesh.device(1, 1) == torch.device("cpu")
    with pytest.raises(ValueError, match="need 8 devices, have 5"):
        make_mesh(4, 2, ["cpu"] * 5)
    if not torch.cuda.is_available():  # no device is made up
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            make_mesh(1, 1)
