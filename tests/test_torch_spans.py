"""The port's spans and counters (``utils/profile.py``): recorded only
under a ``torch.profiler`` capture, on the profiler's timeline, one call
a unit of work, never nested, and changing no answer."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phfpfac_tpu_torch import Matcher, PfacConfig, compile_patterns
from phfpfac_tpu_torch.cli import main
from phfpfac_tpu_torch.compile.plan import build_plan_tables
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops.bitmap import fetch_hit_bits
from phfpfac_tpu_torch.ops.plan import PlanShardScanner
from phfpfac_tpu_torch.parallel.merge import merge_flat_matches
from phfpfac_tpu_torch.utils import profile as P

SHARDS = 4
CHUNK = 1536  # three segments: 4 chunks of the 5,000 B corpus
# spans a match_chunked call opens, by path: "ordered" (the ordered
# decode, every shard a plain plan shard) and "per_shard" (the hash
# decode turned off: each shard decoded, cut and merged on its own)
MATCH_SPANS = {
    "ordered": ("chunk.window", "input.upload", "input.stage",
                "scan.launch", "result.fetch", "result.decode",
                "merge.concat"),
    "per_shard": ("chunk.window", "input.upload", "input.stage",
                  "scan.launch", "result.fetch", "result.decode",
                  "chunk.cut", "chunk.concat", "merge.ids", "merge.concat",
                  "merge.order", "merge.emit"),
}


def _words_and_text(seed=5, size=5000):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdef .", dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(alpha[rng.integers(0, len(alpha), int(rng.integers(1, 14)))])
        for _ in range(150)))
    return words, bytes(alpha[rng.integers(0, len(alpha), size)])


@pytest.fixture(scope="module")
def setup():
    words, text = _words_and_text()
    cfg = PfacConfig(width=256, num_shards=SHARDS, truncation="segment",
                     segment_bytes=512, halo_bytes=8)
    compiled = compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)], cfg)
    m = Matcher(compiled, cfg, device="cpu")
    want = m.match_chunked(text, chunk_bytes=CHUNK)  # builds the tables
    assert all(isinstance(s, PlanShardScanner) for s in m._get_scanners())
    return m, text, want


@pytest.fixture(autouse=True)
def clean():
    P.reset()
    yield
    P.reset()


def captured(fn):
    """(fn's result, what it recorded, the profiler's raw events)."""
    before = P.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, P.difference(before, P.snapshot()), \
        prof.profiler.kineto_results.events()


def test_no_capture_records_nothing(setup):
    m, text, want = setup
    got = m.match_chunked(text, chunk_bytes=CHUNK)
    np.testing.assert_array_equal(got, want)
    assert P.snapshot() == {"spans": {}, "counters": {}}
    with P.span("stage:x.y"):
        P.count("x.y", 3)
    assert P.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("path", ["ordered", "per_shard"])
def test_match_chunked_spans(setup, path, monkeypatch):
    m, text, want = setup
    if path == "per_shard":
        monkeypatch.setenv("PHFPFAC_NO_HASH_DECODE", "1")
    got, rec, events = captured(
        lambda: m.match_chunked(text, chunk_bytes=CHUNK))
    np.testing.assert_array_equal(got, want)  # the same rows
    chunks = -(-len(text) // CHUNK)
    assert chunks >= 3
    per_chunk = {"chunk.window": 1, "input.upload": 1}
    if path == "ordered":
        per_chunk["result.decode"] = 1  # every shard's hits at once
    per_request = {"chunk.concat", "merge.ids", "merge.concat",
                   "merge.order", "merge.emit"}
    spans = rec["spans"]
    assert set(spans) == {f"stage:{name}" for name in MATCH_SPANS[path]}
    for name in MATCH_SPANS[path]:
        calls = spans[f"stage:{name}"][1]
        if name in per_request:
            assert calls == 1, name
        else:
            assert calls == chunks * per_chunk.get(name, SHARDS), name
        assert spans[f"stage:{name}"][0] > 0
    c = rec["counters"]
    if path == "ordered":
        # only a chunk's own hits are fetched: each row decoded once
        assert c["result.rows"] == len(want) and c["merge.ordered"] == 1
    else:
        # rows decoded: the overlap's are decoded twice and cut once
        assert c["result.rows"] >= len(want) and c["merge.argsort"] == 1
    assert c["fetch.bytes"] == 16 * c["result.hits"] > 0
    # each span lies on the profiler's timeline, and none nests another
    cpu = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CPU
           and e.name().startswith("stage:")]
    assert {e.name() for e in cpu} == set(spans)
    assert len(cpu) == sum(v[1] for v in spans.values())
    by_thread = {}
    for e in cpu:
        by_thread.setdefault(e.start_thread_id(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    for ranges in by_thread.values():
        ranges.sort()
        for (_s0, e0), (s1, _e1) in zip(ranges, ranges[1:]):
            assert s1 >= e0


def test_match_trace_program(setup):
    """``trace`` keeps what the program recorded inside its block; on the
    CPU its device reading is empty, not zero."""
    m, text, want = setup
    with P.trace(device="cpu") as mt:
        got = m.match_chunked(text, chunk_bytes=CHUNK)
    np.testing.assert_array_equal(got, want)
    assert mt.program["spans"]["stage:merge.concat"][1] == 1
    assert mt.program["counters"]["merge.ordered"] == 1
    assert mt.program == P.difference({"spans": {}, "counters": {}},
                                      P.snapshot())
    assert mt.device_events() == []
    s = mt.summary()
    assert s["device_busy_seconds"] is None and s["wall_seconds"] > 0


def test_nested_span_records_nothing():
    def nest():
        with P.span("stage:a.outer"):
            with P.span("stage:a.inner"):
                P.count("a.inner")
        with P.span("stage:a.inner"):
            pass

    _, rec, _ = captured(nest)
    assert rec["spans"].keys() == {"stage:a.outer", "stage:a.inner"}
    assert rec["spans"]["stage:a.inner"][1] == 1
    assert rec["counters"] == {"a.inner": 1}


def test_merge_paths(setup):
    m, text, want = setup
    flats = m._match_flat_pallas(text, len(text))
    assert sum(len(f) for f in flats) == len(want)
    one = [flats[0]] + [f[:0] for f in flats[1:]]
    shuffled = list(flats)
    shuffled[1] = flats[1][::-1].copy()  # out of (pos, step) order
    for parts, path in ((one, "merge.inorder"), (flats, "merge.argsort"),
                        (shuffled, "merge.lexsort")):
        got, rec, _ = captured(
            lambda parts=parts: merge_flat_matches(m.compiled, parts,
                                                   len(text)))
        assert rec["counters"] == {path: 1}, path
        assert rec["spans"]["stage:merge.order"][1] == 1
        if path != "merge.inorder":
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [True, False])
def test_plan_table_phases(setup, train):
    m, text, _want = setup
    shard = m.compiled.shards[0]
    pt, rec, _ = captured(lambda: build_plan_tables(
        shard, train=text if train else None))
    names = {"levels", "minimize", "layout", "fill"} | (
        {"train"} if train else set())
    assert set(rec["spans"]) == {f"stage:tables.{n}" for n in names}
    assert all(v[1] == 1 for v in rec["spans"].values())
    assert pt.trained == train


def test_fetch_bytes_a_hit():
    bits = torch.zeros(100, dtype=torch.int32)
    bits[[3, 17, 60]] = torch.tensor([1, 6, 0x40000000], dtype=torch.int32)
    (pos, hb), rec, _ = captured(lambda: fetch_hit_bits(bits, 64))
    assert pos.tolist() == [3, 17, 60]
    assert hb.tolist() == [1, 6, 0x40000000]
    assert rec["counters"] == {"fetch.bytes": 48, "result.hits": 3}
    assert rec["spans"]["stage:result.fetch"][1] == 1


def test_profile_writes_the_spans_file(tmp_path):
    words, text = _words_and_text(seed=9)
    pat, inp = tmp_path / "pat.txt", tmp_path / "in.txt"
    pat.write_bytes(b"\n".join(words) + b"\n")
    inp.write_bytes(text + b"\n")
    traced, plain, prof = (tmp_path / n for n in ("t.txt", "p.txt", "prof"))
    common = [str(pat), "1", "256", str(inp), "--quiet", "--device", "cpu"]
    assert main([*common, "-o", str(traced), "--profile", str(prof)]) == 0
    assert main([*common, "-o", str(plain)]) == 0
    assert traced.read_bytes() == plain.read_bytes()
    (trace,) = prof.glob("match_*.trace.json")
    (spans,) = prof.glob("match_*.spans.json")
    assert trace.name.split(".")[0] == spans.name.split(".")[0]
    got = json.loads(spans.read_text())
    assert got["wall_seconds"] > 0
    for name in ("tables.fill", "input.upload", "scan.launch",
                 "result.fetch", "result.decode"):
        assert got["spans"][f"stage:{name}"][1] >= 1, name
    assert got["counters"]["merge.ordered"] >= 1
    assert got["counters"]["fetch.bytes"] == 16 * got["counters"][
        "result.hits"]
