"""Cells are found by name: a configuration file, a traffic file and a loop
file dropped into the benchmark's folder, and their entries in
``BENCHMARK.json``, make a cell that runs, with no code edited."""

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


def test_unknown_cell():
    with pytest.raises(KeyError):
        spec.cell("nodic.text")
