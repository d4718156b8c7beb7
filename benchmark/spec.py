"""What a cell is, found by name: ``BENCHMARK.json`` at the root names the
cells, each ``<config>.<traffic>``; a configuration is
``configs/<name>.json`` (its path as ``BENCHMARK.json`` gives it), a
traffic mix ``traffic/<name>.json``, the closed loop it names
``loops/<kind>.py``, the dictionary kind its configuration names
``gen/dictionaries/<kind>.py``, the corpus kind its mix names
``gen/corpora/<kind>.py``, the plain reference its configuration names
``reference/<name>.py`` (``ac`` where it names none), and a metric the
reader ``metrics/<name>.py`` beside this file.  Adding a cell, a mix, a
loop, a dictionary or corpus kind, a reference, a configuration or a
metric adds files and entries; no code names them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, as read
    traffic: dict  # the traffic mix's file, as read
    end_to_end: list  # BENCHMARK.json's metric entries that this cell reports
    per_layer: list
    root: Path = ROOT  # the checkout its files and kinds are read from


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """A metric without ``workloads`` is every cell's."""
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read."""
    root = Path(root)
    spec = load(root) if spec is None else spec
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]][0]
    with open(root / conf["file"]) as f:
        config = dict(json.load(f), name=w["config"])
    with open(root / HERE.name / "traffic" / f"{w['traffic']}.json") as f:
        traffic = dict(json.load(f), name=w["traffic"])
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if reports(m, name)],
                root=root)


def _module(folder: str, name: str, root: Path):
    path = Path(root) / HERE.name / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_" + f"{folder}_{name}".replace("/", "_").replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The function ``read(run) -> number | None`` of
    ``metrics/<metric>.py``."""
    return _module("metrics", metric, root).read


def loop(kind: str, root: Path = ROOT):
    """The ``Loop`` subclass of ``loops/<kind>.py``."""
    return _module("loops", kind, root).LOOP


def dictionary(kind: str, root: Path = ROOT):
    """The module ``gen/dictionaries/<kind>.py``: ``make(d) -> (patterns,
    words)`` from a configuration's ``dictionary`` block, and the sizes
    ``REHEARSAL`` that ``run.py --rehearse`` sets in that block."""
    return _module("gen/dictionaries", kind, root)


def corpus(kind: str, root: Path = ROOT):
    """The function ``make(rng, config, traffic, patterns, words) ->
    bytes`` of ``gen/corpora/<kind>.py``: ``traffic["corpus_bytes"]``
    bytes, before the dictionary's patterns are planted."""
    return _module("gen/corpora", kind, root).make


def reference(config: dict, root: Path = ROOT):
    """The plain reference the configuration names (``"reference"``,
    default ``ac``): the class ``REFERENCE`` of ``reference/<name>.py``,
    built from the patterns, with ``max_len`` and ``find(data, *,
    segment, halo, starts_before)``."""
    return _module("reference", config.get("reference", "ac"),
                   root).REFERENCE
