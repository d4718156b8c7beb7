"""Charset-class frontend of the port (frontend.charset,
compile.tables.compile_class_patterns) vs the JAX package's: parsed
classes, determinised tries and compiled tables array for array, and the
matches of every engine against the JAX matcher and the oracle.  All
integer, compared exactly."""

import dataclasses

import numpy as np
import pytest

from phfpfac_tpu.compile.tables import (
    compile_class_patterns as jax_compile_class,
)
from phfpfac_tpu.frontend import charset as jcs
from phfpfac_tpu.parallel.matcher import Matcher as JaxMatcher
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import Matcher, PfacConfig
from phfpfac_tpu_torch.compile.tables import (
    CompiledDictionary,
    compile_class_patterns,
)
from phfpfac_tpu_torch.frontend import charset as tcs
from phfpfac_tpu_torch.oracle.ac import match_oracle_charset

SPECS = [
    b"abc", b"[a-c]x", rb"[^\x00-\xfe]", b"[ace-g]", rb"\[x\]",
    rb"[\x41\x43]", b"[a-]", rb"a\x41[b-d]\n", b"[ab]c", b"bc", b"c",
    b"[a-z][a-z][0-9]", b"ab[0-9]", b"b7", rb"[^\x00]\x00", rb"\x00\x00",
]


def _random_specs(seed=31, n=12):
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(n):
        spec = b""
        for _ in range(int(rng.integers(1, 5))):
            if rng.random() < 0.4:
                lo = int(rng.integers(97, 110))
                spec += b"[%c-%c]" % (lo, lo + int(rng.integers(1, 5)))
            else:
                spec += bytes([int(rng.integers(97, 115))])
        specs.append(spec)
    return specs


def _parse(mod, specs):
    return [mod.parse_class_pattern(s, i + 1) for i, s in enumerate(specs)]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_equals_jax(spec):
    mine = tcs.parse_class_pattern(spec, 7)
    theirs = jcs.parse_class_pattern(spec, 7)
    assert mine.pattern_id == theirs.pattern_id == 7
    assert [sorted(c) for c in mine.classes] == \
        [sorted(c) for c in theirs.classes]
    assert len(mine.classes) >= 1


def test_parse_refuses_what_jax_refuses():
    for bad in (b"[abc", b"[]", b""):
        raised = []
        for mod in (tcs, jcs):
            try:
                mod.parse_class_pattern(bad, 1)
                raised.append(None)
            except ValueError as e:
                raised.append(str(e))
        assert raised[0] == raised[1], bad
    with pytest.raises(ValueError, match="unterminated"):
        tcs.parse_class_pattern(b"[abc", 1)


def test_read_class_patterns_equals_jax(tmp_path):
    path = tmp_path / "classes.txt"
    path.write_bytes(b"\n".join(SPECS) + b"\n")
    mine = tcs.read_class_patterns(str(path))
    theirs = jcs.read_class_patterns(str(path))
    assert [(p.pattern_id, [sorted(c) for c in p.classes]) for p in mine] \
        == [(p.pattern_id, [sorted(c) for c in p.classes]) for p in theirs]
    assert len(mine) == len(SPECS)


SHARD_FIELDS = ("state_num", "final_state_num", "max_pat_len", "width",
                "ht_size", "s0", "r", "ht", "val", "pattern_id_map",
                "patterns", "output_lists", "final_depths")


def _assert_same_fields(a, b, where, names=None):
    names = names or [f.name for f in dataclasses.fields(a)]
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f"{where}.{name}")
            assert x.dtype == y.dtype, f"{where}.{name}"
        else:
            assert x == y, f"{where}.{name}"


@pytest.mark.parametrize("specs", [SPECS, _random_specs(),
                                   [b"ab", b"[ab]b", b"xy", b"xy"]],
                         ids=["specs", "random", "multi_output"])
def test_build_class_trie_equals_jax(specs):
    mine = tcs.build_class_trie(_parse(tcs, specs))
    theirs = jcs.build_class_trie(_parse(jcs, specs))
    _assert_same_fields(mine, theirs, "ClassTrie")
    assert mine.initial_state == mine.final_state_num + 1


def test_multi_output_final():
    ct = tcs.build_class_trie(_parse(tcs, [b"ab", b"[ab]b"]))
    multi = [ids for ids in ct.output_lists.values() if len(ids) > 1]
    assert multi == [[1, 2]]


@pytest.mark.parametrize("shards", [1, 2, 5])
def test_compile_class_patterns_equals_jax(shards):
    specs = SPECS + _random_specs()
    mine = compile_class_patterns(
        _parse(tcs, specs), PfacConfig(width=512, num_shards=shards))
    theirs = jax_compile_class(
        _parse(jcs, specs), JaxConfig(width=512, num_shards=shards))
    assert mine.charset and theirs.charset
    assert (mine.max_pat_len, mine.num_patterns, mine.width) == \
        (theirs.max_pat_len, theirs.num_patterns, theirs.width)
    assert len(mine.shards) == len(theirs.shards) == shards
    for i, (a, b) in enumerate(zip(mine.shards, theirs.shards)):
        _assert_same_fields(a, b, f"shard{i}", SHARD_FIELDS)
        assert a.output_lists is not None and a.final_depths is not None


TEXT = b"ab7 xy9 ab12 zb7b7 acbc ccc abcbc"
BINARY = b"\x01\x00\x00\x00a\x00\xff\xfe\x00\x00"


@pytest.mark.parametrize("engine", ["pallas", "turbo", "jnp"])
@pytest.mark.parametrize("specs,data", [
    ([b"[a-z][a-z][0-9]", b"ab[0-9]", b"b7", b"[ab]c", b"bc", b"c"],
     TEXT * 20),
    ([rb"[^\x00]\x00", rb"\x00\x00", rb"[\xfe\xff][^a]"], BINARY * 40),
    ([b"xy", b"xy", b"[xz]y"], b"xyxyzy" * 30),
], ids=["text", "binary", "duplicates"])
def test_matches_equal_jax_and_oracle(specs, data, engine):
    pats = _parse(tcs, specs)
    cfg = PfacConfig(width=256, num_shards=2)
    m = Matcher(compile_class_patterns(pats, cfg), cfg, engine=engine,
                device="cpu")
    got = [tuple(x) for x in m.match(data).tolist()]
    assert got == match_oracle_charset(pats, data, cfg) and len(got) > 50
    jcfg = JaxConfig(width=256, num_shards=2, interpret=True)
    jm = JaxMatcher(jax_compile_class(_parse(jcs, specs), jcfg), jcfg,
                    engine="turbo")
    assert got == [tuple(x) for x in jm.match(data).tolist()]


def test_random_class_dictionary():
    rng = np.random.default_rng(31)
    pats = _parse(tcs, _random_specs())
    data = bytes(rng.integers(97, 115, 3000).astype(np.uint8))
    cfg = PfacConfig(width=512, num_shards=1)
    want = match_oracle_charset(pats, data, cfg)
    compiled = compile_class_patterns(pats, cfg)
    for engine in ("jnp", "turbo", "pallas"):
        m = Matcher(compiled, cfg, engine=engine, device="cpu")
        assert [tuple(x) for x in m.match(data).tolist()] == want, engine
    chunked = Matcher(compiled, cfg, device="cpu").match_chunked(
        data, chunk_bytes=512)
    assert [tuple(x) for x in chunked.tolist()] == want


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 9])
def test_shard_count_invariance(shards):
    """Class dictionaries shard like every other kind; the canonical
    (pos, length, id) merge order makes the output identical for any
    shard count, with multi-output finals and with empty shards."""
    rng = np.random.default_rng(77)
    pats = _parse(tcs, [b"[ab]c", b"bc", b"c", b"[a-c]b", b"ab",
                        b"[bc][bc]", b"abc"])
    data = bytes(rng.integers(97, 100, 2000).astype(np.uint8))
    want = match_oracle_charset(pats, data,
                                PfacConfig(width=512, num_shards=1))
    cfg = PfacConfig(width=512, num_shards=shards)
    compiled = compile_class_patterns(pats, cfg)
    assert compiled.charset and compiled.num_shards == shards
    for engine in ("turbo", "pallas"):
        m = Matcher(compiled, cfg, engine=engine, device="cpu")
        assert [tuple(x) for x in m.match(data).tolist()] == want, engine


def test_sharded_save_load_round_trip(tmp_path):
    pats = _parse(tcs, [b"[ab]c", b"bc", b"[a-c]b", b"[bc]c"])
    data = b"abcbcbabcb" * 30
    cfg = PfacConfig(width=512, num_shards=2)
    compiled = compile_class_patterns(pats, cfg)
    assert any(len(v) > 1 for sh in compiled.shards
               for v in sh.output_lists.values())  # multi-output finals
    compiled.save(tmp_path / "cs.npz")
    loaded = CompiledDictionary.load(tmp_path / "cs.npz")
    assert loaded.charset
    assert loaded.shards[0].final_depths is not None
    want = match_oracle_charset(pats, data, cfg)
    for engine in ("turbo", "pallas"):
        m = Matcher(loaded, cfg, engine=engine, device="cpu")
        assert [tuple(x) for x in m.match(data).tolist()] == want
