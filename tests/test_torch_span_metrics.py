"""The benchmark's readers of the program's spans (``benchmark/metrics/``,
``"source": "program_span"``): the chunked cell's four read under their
guard where each shard's rows are cut and joined (the per-shard path),
and nothing where the ordered decode leaves nothing to cut, as in a
rehearsal of ``benchmark/run.py``; the invocation cell's four read the
plan-table build's phases where the run is on the card.  On the card,
``MatchTrace`` counts the scan kernels the benchmark's trace reader
counts."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TEXT = ("matcher.rows_ms", "result.merge_order_ms", "result.merge_rows_ms",
        "result.fetch_MB")
INVOKE = ("compile.plan_minimize_s", "compile.plan_train_s",
          "compile.plan_layout_s", "compile.plan_fill_s")
SEED = 2**31 + 41


def rehearse(cell, trace):
    p = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         cell, "--seed", str(SEED), "--seconds", "1", "--trace", trace,
         "--rehearse"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    return out["metrics"]


@pytest.mark.parametrize("cell", ["englishdic.text", "englishdic.invoke"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_rehearsal_prints_what_it_reads(cell, trace):
    """Neither cell prints the eight on the CPU: the text cell takes the
    ordered decode, which opens no ``stage:chunk.cut`` (the guard of the
    four), and the invocation cell's are read on the card only."""
    metrics = rehearse(cell, trace)
    for name in TEXT + INVOKE:
        assert name not in metrics, name


def test_text_guard():
    """The readers read nothing where the spans do not hold one cut a
    shard, chunk and request, or where the program has no spans.  The
    cell as it runs takes the ordered decode: the merge counts
    ``merge.ordered`` once a request, no cut opens, and the four read
    nothing.  Spans of the per-shard path's shape (one cut a shard, chunk
    and request, one concatenation a request, the merge's) are read; one
    cut fewer reads nothing."""
    from benchmark import run, spec
    from phfpfac_tpu_torch.utils import profile

    profile.reset()
    cell = run.shrink(spec.cell("englishdic.text"), run.REHEARSAL)
    r = run.Run(cell, seed=SEED, seconds=0.3, trace=True, device="cpu")
    out = r.go()
    assert out["correct"]
    snap = profile.snapshot()
    n, chunks = len(r.loop.requests), r.loop.chunks
    assert snap["counters"]["merge.ordered"] == n
    assert "merge.argsort" not in snap["counters"]
    assert not {"stage:chunk.cut", "stage:chunk.concat",
                "stage:merge.order"} & set(snap["spans"])
    assert not set(TEXT) & set(out["metrics"])
    assert all(spec.reader(name)(r) is None for name in TEXT)
    with profile._lock:  # the per-shard path's spans, as it records them
        profile._spans.update({
            "stage:chunk.cut": [0.4, n * chunks * 4],
            "stage:chunk.concat": [0.1, n], "stage:merge.ids": [0.2, n],
            "stage:merge.order": [0.3, n], "stage:merge.emit": [0.2, n]})
    for name in TEXT:
        assert spec.reader(name)(r) > 0, name
    assert spec.reader("matcher.rows_ms")(r) == pytest.approx(
        0.5 / (n * chunks) * 1e3)
    with profile._lock:
        profile._spans["stage:chunk.cut"][1] -= 1
    assert all(spec.reader(name)(r) is None for name in TEXT)
    profile.reset()
    assert all(spec.reader(name)(r) is None for name in TEXT)


def test_invoke_readers():
    """On a run that counts as the card's, the invocation cell's readers
    read each phase, the six ``stage:tables.*`` spans cover most of the
    swapped build clock, and one shard's build fewer reads nothing."""
    from benchmark import run, spec
    from phfpfac_tpu_torch.utils import profile

    profile.reset()
    cell = run.shrink(spec.cell("englishdic.invoke"), run.REHEARSAL)
    r = run.Run(cell, seed=SEED, seconds=0.5, trace=True, device="cpu")
    out = r.go()
    assert not set(INVOKE) & set(out["metrics"])  # not on the CPU
    inv = r.loop.invocations
    spans = profile.snapshot()["spans"]
    assert spans["stage:tables.fill"][1] == len(inv) * 4
    r.card = True
    for name in INVOKE:
        phase = name.split("_")[1]
        got = spec.reader(name)(r)
        assert got == pytest.approx(
            spans[f"stage:tables.{phase}"][0] / len(inv)), name
        assert got > 0
    tables = sum(v[0] for k, v in spans.items()
                 if k.startswith("stage:tables."))
    assert 0.8 < tables / sum(i["tables_s"] for i in inv) <= 1.0
    with profile._lock:
        profile._spans["stage:tables.fill"][1] -= 1
    assert all(spec.reader(name)(r) is None for name in INVOKE)
    profile.reset()


@pytest.mark.cuda
def test_match_trace_reads_every_scan_kernel():
    """On the card: ``MatchTrace`` counts, in one capture, the scan-kernel
    launches ``benchmark/trace.py`` counts, one a shard and chunk."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from benchmark import trace as tr
    from phfpfac_tpu_torch import Matcher, PfacConfig, compile_patterns
    from phfpfac_tpu_torch.frontend.patterns import Pattern
    from phfpfac_tpu_torch.utils import profile

    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"abcdef .", dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(alpha[rng.integers(0, len(alpha), int(rng.integers(1, 14)))])
        for _ in range(150)))
    text = bytes(alpha[rng.integers(0, len(alpha), 1 << 20)])
    cfg = PfacConfig(width=256, num_shards=4, truncation="segment",
                     segment_bytes=512, halo_bytes=8)
    m = Matcher(compile_patterns(
        [Pattern(i + 1, w) for i, w in enumerate(words)], cfg), cfg,
        device="cuda")
    chunk = 256 << 10
    want = m.match_chunked(text, chunk_bytes=chunk)  # builds, warms up
    with profile.trace(device="cuda") as mt:
        with tr.window():
            got = m.match_chunked(text, chunk_bytes=chunk)
            torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    t = tr.reduce(mt.prof.profiler.kineto_results.events())
    mine = [d for d in mt.device_events() if tr.SCAN_KERNEL in d[2]]
    assert len(mine) == t.scan_kernels == 4 * 4
    assert sum(e - s for s, e, _n in mine) / 1e9 == pytest.approx(t.scan_s)
    assert mt.summary()["device_busy_seconds"] > 0
