"""The word-dictionary regimes (``chip_e2e.py --dict words``) on the CPU
at small sizes: the generators are deterministic by seed and english
lands on its state target; a title dictionary in one shard, exact mode,
gives the same rows from the JAX package's Matcher, the port's Matcher
on the plain versions and ``oracle/ac.py``, and the port's CLI at
streamnum 1 writes the byte-identical file; the result file's
native render equals printf's form and the JAX package's; every
arm of the word regimes runs once through ``chip_e2e.main``."""

import json

import numpy as np
import pytest

import chip_e2e
import chip_smoke as cs
from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.parallel.matcher import Matcher as JaxMatcher
from phfpfac_tpu.parallel.merge import render_result_file as jax_render
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import Matcher, cli, compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.oracle.ac import match_oracle
from phfpfac_tpu_torch.parallel import merge

KIB = 1 << 10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread here and in the CLI processes these tests start:
    they run beside other files' workers, and threads that outnumber the
    host's cores wait on each other many times over."""
    import os

    import torch

    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def test_generators_are_deterministic_by_seed():
    def draw(seed):
        rng = np.random.default_rng(seed)
        words = cs.make_english_words(rng, 500)
        return (words, cs.make_titles(rng, 3000),
                cs.make_english_text(rng, words, 32 * KIB))

    a, b, c = draw(5), draw(5), draw(6)
    assert a == b and a != c
    words, titles, text = a
    assert len(words) == len(set(words)) == 500
    assert len(titles) == len(set(titles)) == 3000
    assert len(text) == 32 * KIB
    assert all(w.islower() for w in words if w.isalpha())
    assert all(len(t) <= 32 for t in titles[:-3])
    assert all(33 <= len(t) <= 64 for t in titles[-3:])
    # a list is the head of a longer one (big's titles are full's first)
    head = cs.make_titles(np.random.default_rng(7), 2000)[:-3]
    assert cs.make_titles(np.random.default_rng(7), 6000)[:len(head)] == head


def test_english_lands_on_its_state_target():
    """7,977 words in one shard: the state count within 25% of the 23,951
    of ``bench.py``'s english (BENCH_r05.json)."""
    words = cs.make_english_words(np.random.default_rng([0, 2]))
    assert len(words) == 7_977
    cfg = chip_e2e.word_config()
    shard, = compile_patterns([Pattern(i + 1, w) for i, w in
                               enumerate(words)], cfg).shards
    want = chip_e2e.WORD_COUNTS["english"][1]
    assert abs(shard.state_num / want - 1) <= chip_e2e.STATE_TOLERANCE


@pytest.fixture(scope="module")
def titles_over_text():
    """2,000 titles over 64 KiB of English-like text with plants."""
    rng = np.random.default_rng(11)
    words = cs.make_english_words(rng)
    titles = cs.make_titles(rng, 2000)
    text = cs.make_english_text(rng, words, 64 * KIB)
    corpus, planted = cs.make_corpus(rng, titles, len(text), plants=100,
                                     base=text)
    return titles, corpus, planted


def test_titles_in_one_shard_equal_the_jax_matcher_and_the_oracle(
        titles_over_text):
    """One shard, width 4096, exact mode: the port's match_chunked in
    16 KiB chunks (plain versions) against the JAX Matcher (its default
    engine, as its own tests run it on the CPU) and the oracle;
    tolerance 0."""
    titles, corpus, planted = titles_over_text
    cfg = chip_e2e.word_config()
    pats = [Pattern(i + 1, p) for i, p in enumerate(titles)]
    port = Matcher(compile_patterns(pats, cfg), cfg, device="cpu")
    assert chip_e2e.routes(port) == ["split/plan"]  # the 3 long titles
    got = np.asarray(port.match_chunked(corpus, chunk_bytes=16 * KIB),
                     np.int64)
    jcfg = chip_e2e.word_config(JaxConfig)
    jm = JaxMatcher(jax_compile([JaxPattern(i + 1, p) for i, p in
                                 enumerate(titles)], jcfg), jcfg)
    want = np.asarray(jm.match(corpus), np.int64).reshape(-1, 2)
    assert np.array_equal(got, want)
    oracle = np.asarray(match_oracle(pats, corpus, cfg),
                        np.int64).reshape(-1, 2)
    assert np.array_equal(got, oracle)
    found = set(map(tuple, got.tolist()))
    assert all(p in found for p in planted)


def test_the_cli_at_streamnum_1_writes_the_one_shard_file(titles_over_text,
                                                          tmp_path):
    """The CLI's 4 shards under its default cut: the file byte-identical
    to the one-shard exact-mode rows rendered."""
    titles, corpus, _planted = titles_over_text
    pat_file, in_file = cs.write_inputs(str(tmp_path), "t", titles, corpus,
                                        False)
    out = tmp_path / "out.txt"
    assert cli.main([pat_file, "1", "4096", in_file, "-o", str(out),
                     "--quiet", "--device", "cpu"]) == 0
    cfg = chip_e2e.word_config()
    one = Matcher(compile_patterns([Pattern(i + 1, p) for i, p in
                                    enumerate(titles)], cfg), cfg,
                  device="cpu")
    want = merge.render_result_file(one.match_chunked(corpus))
    assert out.read_text() == want and want.count("\n") > 100


@pytest.mark.parametrize("native", [True, False])
def test_render_equals_printf_and_the_jax_package(native, monkeypatch):
    """The native render against printf's ``%4d`` / ``%d`` form (the JAX
    package's f-strings, and the port's own without the native helper):
    padded positions under 1,000, every digit count, ids past 2^32,
    blocks that split the rows."""
    from phfpfac_tpu_torch.compile import native as lib

    assert lib.available()
    monkeypatch.setattr(merge, "RENDER_BLOCK", 3)
    if not native:
        monkeypatch.setattr(lib, "available", lambda: False)
    rng = np.random.default_rng(3)
    pos = np.concatenate([[0, 9, 10, 999, 1000, 9999, 10 ** 12],
                          rng.integers(0, 10 ** rng.integers(1, 10, 2000))])
    ids = np.concatenate([[1, 10, 2 ** 32, 7, 99, 100, 3],
                          rng.integers(1, 10 ** rng.integers(1, 8, 2000))])
    m = np.stack([pos, ids], 1)
    want = "".join(f"At position {p:4d}, match pattern {i}\n"
                   for p, i in m.tolist())
    assert merge.render_result_file(m) == want == jax_render(m)
    assert merge.render_result_file(np.empty((0, 2), np.int64)) == ""
    neg = np.array([[-5, 3]])
    assert merge.render_result_file(neg) == jax_render(neg)


def test_every_word_arm_runs_once(capsys, monkeypatch):
    """english (e2e, stages, compact, kernels) and big's stream through
    ``main`` on the CPU at 2,000 patterns and 0.25 MiB, 64 KiB chunks."""
    monkeypatch.setattr(chip_e2e, "CHUNK", 64 * KIB)
    monkeypatch.setattr(chip_e2e, "FEEDS", (32 * KIB, 64 * KIB))
    monkeypatch.setattr(chip_e2e, "WINDOW", 16 * KIB)
    tiny = ["--device", "cpu", "--mib", "0.25", "--patterns", "2000",
            "--reps", "1"]
    assert chip_e2e.main([*tiny, "--dict", "english"]) == 0
    assert chip_e2e.main([*tiny, "--dict", "big", "--arm", "stream"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    arms = [(r["arm"], r["dictionary"]) for r in lines if "arm" in r]
    assert arms == [("e2e", "english"), ("stages", "english"),
                    ("compact", "english"), ("kernels", "english"),
                    ("stream", "big")]
    by = {r["arm"]: r for r in lines if "arm" in r}
    assert all(r["ok"] and r["calibration"]["states"] > 0
               for r in by.values())
    e2e = by["e2e"]
    assert e2e["routes"] == ["plan"] and e2e["states"] > 0
    assert e2e["count_total"] == e2e["matches"] > 0
    assert e2e["cli"]["byte_identical"] and e2e["cli"]["num_shards"] == 4
    assert e2e["calibrated"]["matches_per_byte"]
    assert by["stages"]["chunks"] == 4 and by["stages"]["equal"]
    assert by["compact"]["engaged"] and by["compact"]["equal"]
    k = by["kernels"]
    assert k["max_abs_err"] == dict(plan_scan=0, plan_scan_compact_a=0,
                                    planb_scan=0)
    assert k["matches"] > 0 and not k["overflowed"]
    s = by["stream"]
    assert s["equal"] and s["feeds"] == 8 and s["truncation"] == "none"
    assert [r["ok"] for r in lines if r.get("summary")] == [True, True]


def test_the_smoke_words_phase(tmp_path, monkeypatch):
    """``chip_smoke.py``'s words phase at 2,000 titles over 256 KiB."""
    monkeypatch.setattr(cs, "WORDS_MIB", 0.25)
    r = cs.words_phase("cpu", str(tmp_path), patterns=2000)
    assert r["routes"] == ["split/plan"] and r["patterns"] == 2000
    assert r["planted_found"] > 0 and r["matches"] > 0


def test_a_split_shards_matches_arrive_in_pos_step_order():
    """A shard with patterns past 32 B splits: its long matches (host
    search) join the short ones (K1's plain version) in (pos, step)
    order, the order ``merge_flat_matches`` takes its fast path on;
    the merged rows stay the oracle's."""
    rng = np.random.default_rng(4)
    words = cs.make_english_words(rng, 300)
    long = b" ".join(words[:12])[:40]
    pats = [*words, long]
    text = cs.make_english_text(rng, words, 16 * KIB)
    corpus = long + text[len(long):8 * KIB] + long + text[8 * KIB:]
    cfg = chip_e2e.word_config()
    ps = [Pattern(i + 1, p) for i, p in enumerate(pats)]
    m = Matcher(compile_patterns(ps, cfg), cfg, device="cpu")
    assert chip_e2e.routes(m) == ["split/plan"]
    flat, = [r() for r in m._dispatch(corpus, len(corpus))]
    assert (flat[:, 2] >= 0).all() and len(flat) > 2
    key = flat[:, 0] * 64 + flat[:, 1]
    assert (np.diff(key) > 0).all()
    want = np.asarray(match_oracle(ps, corpus, cfg), np.int64)
    assert np.array_equal(np.asarray(m.match(corpus), np.int64), want)
    assert (want[:, 1] == len(pats)).sum() == 2
