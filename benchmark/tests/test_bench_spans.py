"""The result path's readers of the program's spans and counters
(``spans.result_window``: ``result.decode_ms``, ``result.join_ms``,
``result.fetch_ms``, ``result.fetch_MB``) read on both of the program's
result paths, each the window's spans over its chunks, and nothing where
the spans do not cover every request and chunk of the window."""

import pytest

from benchmark import run, spec
from benchmark.tests.test_bench_faults import small

SEED = 2**31 + 43
READERS = ("result.decode_ms", "result.join_ms", "result.fetch_ms",
           "result.fetch_MB")


def readings(r):
    return {name: spec.reader(name)(r) for name in READERS}


@pytest.mark.parametrize("path", ["ordered", "per_shard"])
def test_result_readers_on_both_paths(path, monkeypatch):
    from phfpfac_tpu_torch.utils import profile

    if path == "per_shard":
        monkeypatch.setenv("PHFPFAC_NO_HASH_DECODE", "1")
    profile.reset()
    r = run.Run(small("englishdic.text"), seed=SEED, seconds=0.3,
                trace=True, device="cpu")
    assert r.go()["correct"]
    snap = profile.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    n = len(r.loop.requests)
    chunks, shards = n * r.loop.chunks, r.cell.config["num_shards"]
    assert r.loop.chunks > 1 and r.launches == 0  # the CPU launches none
    if path == "ordered":
        assert counters["merge.ordered"] == n
        assert "stage:chunk.cut" not in spans
        assert spans["stage:result.decode"][1] == chunks
        # a run whose scans launched no kernel reads nothing here
        assert set(readings(r).values()) == {None}
        r.launches = chunks * shards  # as the card's counters read
        gap = "stage:result.decode"
    else:
        assert "merge.ordered" not in counters
        assert spans["stage:chunk.cut"][1] == chunks * shards
        assert spans["stage:chunk.concat"][1] == n
        gap = "stage:chunk.cut"
    join = sum(spans[k][0] for k in ("stage:merge.concat",
                                     "stage:chunk.concat") if k in spans)
    want = {"result.decode_ms": spans["stage:result.decode"][0],
            "result.join_ms": join,
            "result.fetch_ms": spans["stage:result.fetch"][0]}
    got = readings(r)
    for name, seconds in want.items():
        assert got[name] == pytest.approx(seconds / chunks * 1e3), name
        assert got[name] > 0, name
    assert got["result.fetch_MB"] == pytest.approx(
        counters["fetch.bytes"] / chunks / 1e6)
    with profile._lock:  # one request's worth fewer: not covered
        profile._spans[gap][1] -= 1
    assert set(readings(r).values()) == {None}
    profile.reset()
    assert set(readings(r).values()) == {None}
