"""The end-to-end harness (chip_e2e.py) on the CPU at tiny sizes: every
arm's line and the summary, the stage wrappers reach every stage and
leave the rows as they were, an injected fault fails the run, there is
no CPU fallback, and the slice (the harness's deployments through the
port's match_chunked) equals the JAX package's Matcher."""

import dataclasses
import json

import numpy as np
import pytest

import chip_e2e
from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.parallel.matcher import Matcher as JaxMatcher
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch import Matcher, compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.parallel import matcher as tmatcher

KIB = 1 << 10
TINY = ["--device", "cpu", "--mib", "0.25", "--patterns", "2000",
        "--reps", "2"]
# the fields each arm's line carries, and where its sample counts sit
FIELDS = {
    "e2e": ("scan", "match", "chunked", "device_chunked",
            "device_chunked_over_scan", "cli"),
    "stages": ("stages", "serial_wall", "serial_wall_wrapped",
               "pipelined_wall", "unaccounted", "unaccounted_share",
               "trace", "reached"),
    "stream": ("host_fed_16384", "matches", "oracle_windows",
               "match_chunked_uploaded_seconds"),
    "coldstart": ("wall", "steps", "interpreter_and_exit",
                  "equal_to_phase_0", "plan_tables_carried"),
}


@pytest.fixture(autouse=True)
def tiny_geometry(monkeypatch):
    """16 MiB chunks, 1 / 16 MiB feeds, 64 KiB oracle windows and the
    8 MiB first result, cut to the tiny corpus."""
    monkeypatch.setattr(chip_e2e, "CHUNK", 64 * KIB)
    monkeypatch.setattr(chip_e2e, "FEEDS", (16 * KIB, 64 * KIB))
    monkeypatch.setattr(chip_e2e, "WINDOW", 16 * KIB)
    monkeypatch.setattr(chip_e2e, "FIRST", 128 * KIB)


def _lines(capsys) -> list:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def _timings(obj):
    """Every timing in a result, found by its keys."""
    if isinstance(obj, dict):
        if {"n", "median", "q1", "q3"} <= set(obj):
            yield obj
        else:
            for v in obj.values():
                yield from _timings(v)


@pytest.mark.parametrize("name", chip_e2e.DICTS)
@pytest.mark.parametrize("arm", chip_e2e.ARMS)
def test_every_arm_at_a_tiny_size(arm, name, capsys):
    assert chip_e2e.main([*TINY, "--arm", arm, "--dict", name]) == 0
    lines = _lines(capsys)
    assert len(lines) == 3
    assert lines[0]["device"]["name"] == "cpu"
    r, summary = lines[1], lines[-1]
    assert (r["arm"], r["dictionary"], r["ok"]) == (arm, name, True)
    assert set(FIELDS[arm]) <= set(r)
    assert summary["summary"] and summary["ok"] and not summary["failed"]
    del r["at_seconds"]
    assert summary["arms"] == {arm: {name: r}}
    found = list(_timings(r))
    assert found and all(t["median"] is None or
                         t["q1"] <= t["median"] <= t["q3"] for t in found)
    if arm == "e2e":
        for t in (r["match"]["seconds"], r["chunked"]["seconds"],
                  r["device_chunked"]["seconds"], r["scan"]["host"],
                  r["cli"]["subprocess_wall"], r["cli"]["split_wall"],
                  r["cli"]["subprocess_import"]):
            assert t["n"] == 2
        split = r["cli"]["split"]
        assert set(split) == {*chip_e2e.CLI_STEPS, "exit"}
        for k, t in split.items():  # no card: no CUDA init, no library
            assert t["n"] == (0 if k in ("cuda_init", "library_load") else 2)
        assert r["cli"]["byte_identical"]
    elif arm == "stages":
        assert r["chunks"] == 4 and r["equal"]
        for k in chip_e2e.STAGES:
            assert r["stages"][k]["seconds_per_chunk"]["n"] == 2
        assert r["serial_wall"]["n"] == r["pipelined_wall"]["n"] == 2
    elif arm == "stream":
        feeds = r["host_fed_16384"]
        assert feeds["feeds"] == r["bytes"] // (16 * KIB)
        assert feeds["seconds_per_feed"]["n"] == feeds["feeds"]
        assert feeds["equal"] and r["planted"] > 0
        if name == "clamav5k":
            assert r["device_resident"]["seconds"]["n"] == 2
            assert r["host_fed_65536"]["feeds"] == 4
        else:
            assert r["truncation"] == "none"
    else:
        assert r["wall"]["n"] == r["steps"]["import"]["n"] == 2
        assert r["steps"]["cuda_init"]["n"] == 0  # no card
        assert r["equal_to_phase_0"]


def test_stats_takes_the_tail_from_a_hundred_samples():
    s = chip_e2e.stats(np.arange(1024.0))
    assert s["n"] == 1024 and s["tail_pct"] == 99  # 10.24 samples beyond
    assert s["median"] == 511.5 and s["q1"] == 255.75
    assert chip_e2e.stats(np.arange(256.0))["tail_pct"] == 96
    assert "tail" not in chip_e2e.stats(np.arange(99.0))
    assert chip_e2e.stats([None, 2.0])["n"] == 1
    assert chip_e2e.stats([])["median"] is None


@pytest.mark.parametrize("name", chip_e2e.DICTS)
def test_stage_wrappers_reach_every_stage(name, tmp_path):
    run = chip_e2e.Run("cpu", reps=1, mib=0.25, patterns=2000,
                       tmp=str(tmp_path))
    d = run.deployment(name)
    names = {"fetch_hit_bits": tmatcher.fetch_hit_bits,
             "merge_flat_matches": tmatcher.merge_flat_matches,
             "_dispatch": tmatcher.Matcher._dispatch}
    r = chip_e2e.stages(run, d, reps=1)
    # ascii50k's long patterns take the split shards' host tail
    want = set(chip_e2e.WRAPPED)
    if name == "clamav5k":
        want.discard("_host_literal_one")
    assert {k for k, v in r["reached"].items() if v} == want
    for k in chip_e2e.STAGES:
        assert (r["stages"][k]["calls_per_chunk"] > 0) == \
            (k != "host_tail" or name == "ascii50k")
    # the package is as it was, and its rows with and without wrappers
    assert tmatcher.fetch_hit_bits is names["fetch_hit_bits"]
    assert tmatcher.merge_flat_matches is names["merge_flat_matches"]
    assert tmatcher.Matcher._dispatch is names["_dispatch"]
    assert not hasattr(tmatcher, "bytes")
    kw = dict(chunk_bytes=chip_e2e.CHUNK, max_outstanding=0)
    clock = chip_e2e.StageClock(False, sync=True)
    timed = chip_e2e.TimedCorpus(d.corpus)
    timed.clock = clock
    with chip_e2e.stage_wrappers(clock):
        got = d.matcher.match_chunked(timed, **kw)
    assert clock.calls["window"] == r["chunks"]
    assert np.array_equal(got, d.matcher.match_chunked(d.corpus, **kw))
    assert np.array_equal(got, chip_e2e.cli_rows(run, d))


def test_a_dropped_row_fails_the_run(monkeypatch, capsys):
    real = tmatcher.merge_flat_matches
    monkeypatch.setattr(tmatcher, "merge_flat_matches",
                        lambda *a, **kw: real(*a, **kw)[1:])
    assert chip_e2e.main([*TINY, "--arm", "stages", "--dict",
                          "clamav5k"]) == 1
    lines = _lines(capsys)
    r, summary = lines[1], lines[-1]
    assert r["arm"] == "stages" and not r["ok"]
    assert "planted matches missing" in r["error"]
    assert summary["failed"] == ["stages:clamav5k"] and not summary["ok"]


def test_no_card_no_fallback(capsys):
    assert chip_e2e.main([]) == 1
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", chip_e2e.DICTS)
def test_the_slice_equals_the_jax_matcher(name):
    """The harness's generators at a few hundred patterns over 16 KiB:
    the port's match_chunked at the CLI's 4 shards in 4 KiB chunks
    (plain versions) against the JAX Matcher's kernels in interpret mode,
    unchunked, on one shard (the merged output does not depend on the
    shard count; interpret mode traces each shard's kernel for seconds);
    tolerance 0."""
    pats, corpus, planted, _ = chip_e2e.generate(name, 3, 16 * KIB, 300)
    tcfg = chip_e2e.cli_config()
    port = Matcher(compile_patterns(
        [Pattern(i + 1, p) for i, p in enumerate(pats)], tcfg), tcfg,
        device="cpu")
    got = port.match_chunked(corpus, chunk_bytes=4 * KIB)
    assert port._chunk_geometry(4 * KIB)[0] * 3 < len(corpus)
    jcfg = dataclasses.replace(chip_e2e.cli_config(JaxConfig),
                               num_shards=1, interpret=True)
    jm = JaxMatcher(jax_compile(
        [JaxPattern(i + 1, p) for i, p in enumerate(pats)], jcfg), jcfg,
        engine="pallas")
    want = np.asarray(jm.match(corpus), np.int64)
    assert np.array_equal(np.asarray(got, np.int64), want)
    found = set(map(tuple, want.tolist()))
    assert planted and all(p in found for p in planted)


def test_trace_by_stage_leaves_out_the_programs_spans():
    """The program's own ``stage:`` spans sit inside the harness's stage
    ranges: they neither count twice nor raise (on the card only, where
    the trace is read by stage)."""
    import types

    import torch

    def event(name, seconds):
        return types.SimpleNamespace(
            name=name, device_type=torch.autograd.DeviceType.CPU,
            device_time_total=seconds * 1e6)

    mt = types.SimpleNamespace(prof=types.SimpleNamespace(events=lambda: [
        event("stage:fetch", 2.0), event("stage:result.fetch", 2.0),
        event("stage:chunk.window", 1.0), event("stage:decode", 0.5)]))
    out = chip_e2e.trace_by_stage(mt, {"anon::plan_scan_kernel": 0.25})
    assert out["fetch"] == 2.0 and out["decode"] == 0.5
    assert out["k1"] == 0.25 and set(out) == set(chip_e2e.STAGES)
