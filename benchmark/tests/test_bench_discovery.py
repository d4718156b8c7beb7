"""Cells are found by name: a configuration file, a traffic file, a loop
file, a dictionary kind, a corpus kind and a plain reference dropped into
the benchmark's folder, and their entries in ``BENCHMARK.json``, make a
cell that runs, with no code edited."""

import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

import pytest

from benchmark import run, spec

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_every_cell_and_metric_is_found():
    s = spec.load()
    for w in s["workloads"]:
        c = spec.cell(w["name"])
        assert c.config["name"] == w["config"]
        assert spec.loop(c.traffic["loop"]).kind == c.traffic["loop"]
        assert callable(spec.dictionary(c.config["dictionary"]["kind"]).make)
        assert callable(spec.corpus(c.traffic["corpus"]))
        assert spec.reference(c.config).__name__ == "Automaton"
        assert c.end_to_end and c.per_layer
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_dropped_in_files_make_a_cell(tmp_path):
    bench = tmp_path / HERE.name
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    config = json.loads((HERE / "configs" / "englishdic.json").read_text())
    config["dictionary"] = dict(kind="english_words", count=200,
                                text_words=200, seed=[9, 9])
    (bench / "configs" / "tinydic.json").write_text(json.dumps(config))
    # a loop of its own: the chunked loop reading its ring from the start
    (bench / "loops" / "fromzero.py").write_text(
        "from benchmark.loops.chunked import Chunked\n\n\n"
        "class FromZero(Chunked):\n"
        "    @classmethod\n"
        "    def key(cls, traffic, n, k):\n"
        "        return 0\n\n\n"
        "LOOP = FromZero\n")
    (bench / "traffic" / "bytes.json").write_text(json.dumps(dict(
        loop="fromzero", corpus="random", corpus_bytes=1 << 17,
        chunk_bytes=1 << 15, plants_per_64mib=2_000_000)))
    s = json.loads((ROOT / "BENCHMARK.json").read_text())
    s["configs"].append(dict(name="tinydic", source="a test",
                             file=f"{HERE.name}/configs/tinydic.json",
                             reduced=[], why="a test"))
    s["workloads"].append(dict(name="tinydic.bytes", config="tinydic",
                               traffic="bytes", chips=1, why="a test"))
    for m in s["end_to_end"] + s["per_layer"]:
        if m["name"] in ("scan_GBps", "matcher.input_ms"):
            m["workloads"].append("tinydic.bytes")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))

    cell = spec.cell("tinydic.bytes", tmp_path)
    assert cell.config["dictionary"]["count"] == 200
    assert cell.traffic["corpus"] == "random"
    assert spec.loop("fromzero", tmp_path).__name__ == "FromZero"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "scan_GBps"]
    r = run.Run(cell, seed=17, seconds=0.5, trace=True, device="cpu")
    out = r.go(tmp_path)
    assert out["correct"] and out["attempted"] > 0
    assert {r.key for r in r.loop.requests} == {0}
    assert set(out["metrics"]) == {"matcher.input_ms"}


# A deployment whose every part is new: binary signatures in an escaped
# pattern file, more than 8 a shard longer than the 32-step bitmap (so each
# shard splits and its long tail goes to the turbo engine), some holding
# byte 0x0A; an executable-like corpus; a reference of its own.
SIGNATURES = '''"""Seeded binary signatures, a third over 32 B."""

import numpy as np

REHEARSAL = {}


def make(d):
    rng = np.random.default_rng(d["seed"])
    pats, seen = [], set()
    while len(pats) < d["count"]:
        k = len(pats)
        n = int(rng.integers(33, d["longest"] + 1) if k % 3 == 0
                else rng.integers(4, 33))
        p = bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        if k % 5 == 0:
            p[2] = 0x0A
        if bytes(p) not in seen:
            seen.add(bytes(p))
            pats.append(bytes(p))
    return pats, []
'''

EXECUTABLE = '''"""Random bytes, a third of them zero, as in code and data sections."""

import numpy as np


def make(rng, config, traffic, pats, words):
    buf = rng.integers(0, 256, traffic["corpus_bytes"], dtype=np.uint8)
    buf[rng.random(buf.size) < 0.3] = 0
    return buf.tobytes()
'''

NAIVE = '''"""Each pattern searched for with bytes.find, one by one."""

import numpy as np


class Naive:
    def __init__(self, patterns):
        self.patterns = [bytes(p) for p in patterns]
        self.max_len = max(map(len, self.patterns))

    def find(self, data, *, segment=None, halo=0, starts_before=None):
        limit = len(data) if starts_before is None else starts_before
        rows = []
        for pid, p in enumerate(self.patterns, 1):
            i = data.find(p)
            while 0 <= i < limit:
                if not segment or i % segment + len(p) <= segment + halo:
                    rows.append((i, len(p), pid))
                i = data.find(p, i + 1)
        rows.sort()
        return np.asarray([(i, pid, n) for i, n, pid in rows],
                          np.int32).reshape(-1, 3)


REFERENCE = Naive
'''


def digests(folder: Path) -> dict:
    return {str(f.relative_to(folder)): hashlib.sha256(f.read_bytes())
            .hexdigest() for f in sorted(folder.rglob("*"))
            if f.is_file() and "__pycache__" not in f.parts}


def test_dropped_in_deployment(tmp_path):
    bench = tmp_path / HERE.name
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = digests(bench)
    config = json.loads((HERE / "configs" / "englishdic.json").read_text())
    config.update(dictionary=dict(kind="sigs", count=180, longest=64,
                                  seed=[7, 1]),
                  pattern_file="escapes", reference="naive")
    added = {
        "configs/sigdic.json": json.dumps(config),
        "gen/dictionaries/sigs.py": SIGNATURES,
        "gen/corpora/executable.py": EXECUTABLE,
        "reference/naive.py": NAIVE,
        "traffic/exe.json": json.dumps(dict(
            loop="chunked", corpus="executable", corpus_bytes=1 << 17,
            chunk_bytes=1 << 15, plants_per_64mib=200_000)),
    }
    for name, text in added.items():
        (bench / name).write_text(text)
    s = json.loads((ROOT / "BENCHMARK.json").read_text())
    s["configs"].append(dict(name="sigdic", source="a test",
                             file=f"{HERE.name}/configs/sigdic.json",
                             reduced=[], why="a test"))
    s["workloads"].append(dict(name="sigdic.exe", config="sigdic",
                               traffic="exe", chips=1, why="a test"))
    for m in s["end_to_end"] + s["per_layer"]:
        if m["name"] in ("scan_GBps", "kernel.scan_roofline_pct",
                         "result.fetch_MB", "matcher.input_ms"):
            m["workloads"].append("sigdic.exe")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))

    from phfpfac_tpu_torch.utils import profile

    profile.reset()
    cell = spec.cell("sigdic.exe", tmp_path)
    r = run.Run(cell, seed=2**31 + 23, seconds=0.5, trace=True,
                device="cpu")
    out = r.go(tmp_path)
    assert out["correct"] and out["attempted"] > 0, out["compared"]
    pats = r.loop.pats
    assert r.loop.escapes and any(b"\n" in p for p in pats)
    assert type(spec.reference(cell.config, tmp_path)(pats)).__name__ == \
        "Naive"
    # every shard, as the program cuts the sorted list, has more than 8
    # patterns over 32 B: the turbo engine takes each long tail
    k = len(pats) // 4
    ranked = sorted(pats)
    for i in range(4):
        shard = ranked[i * k:] if i == 3 else ranked[i * k:(i + 1) * k]
        assert sum(len(p) > 32 for p in shard) > 8
    # split shards take the per-shard result path, whose spans cover the
    # window on the CPU too; the roofline is the card's alone
    assert "merge.ordered" not in profile.snapshot()["counters"]
    assert set(out["metrics"]) == {"matcher.input_ms", "result.fetch_MB"}
    profile.reset()
    # the roofline's guard against counters as split shards leave them:
    # one launch or more a shard and chunk, as many kernels traced
    r.card = True
    launches = 2 * len(r.loop.requests) * r.loop.chunks * 4 + 3
    r.trace = dataclasses.replace(r.trace, scan_kernels=launches,
                                  scan_s=1e-3)
    r.launches = launches
    assert spec.reader("kernel.scan_roofline_pct", tmp_path)(r) > 0
    r.launches = launches + 1  # a kernel lost from the capture
    assert spec.reader("kernel.scan_roofline_pct", tmp_path)(r) is None
    # the benchmark's files as they were, the dropped-in ones beside them
    after = digests(bench)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(added)


def test_unknown_cell():
    with pytest.raises(KeyError):
        spec.cell("nodic.text")
