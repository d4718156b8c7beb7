"""The one general generator: a configuration's dictionary and a traffic
mix's corpus, from their files' parameters and the run's seed.

The dictionary is the deployment's: it comes from the configuration's own
``dictionary.seed`` and is the same in every run.  So are the text's word
frequencies.  The run's seed draws the corpus: which words follow which,
the random bytes, and where the dictionary's patterns are planted.  Every
seed gets the same sizes, the same number of plants and the same mix.

What a dictionary or a corpus is made of is its kind's, a file of its own
found by name (``spec.dictionary``, ``spec.corpus``): the configuration's
``dictionary.kind``, the traffic's ``corpus``.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

from benchmark import spec
from benchmark.gen import words as w

MIB = 1 << 20


def dictionary(config: dict, root: Path = spec.ROOT) -> tuple[list, list]:
    """(patterns, the words a text corpus is made of) of a configuration,
    by its dictionary kind."""
    d = config["dictionary"]
    return spec.dictionary(d["kind"], root).make(d)


def run_rng(seed: int, *names) -> np.random.Generator:
    """The run's generator: its seed (any whole number) and the names of
    what it draws for."""
    return np.random.default_rng([seed % (1 << 64),
                                  *(zlib.crc32(n.encode()) for n in names)])


def corpus(config: dict, traffic: dict, pats: list, words: list,
           seed: int, root: Path = spec.ROOT) -> tuple[bytes, list]:
    """(corpus, planted (position, id)) of ``traffic["corpus_bytes"]``
    bytes of the traffic's corpus kind, with one planted pattern per
    ``64 MiB / plants_per_64mib`` bytes."""
    size = traffic["corpus_bytes"]
    rng = run_rng(seed, config["name"], traffic["name"])
    base = spec.corpus(traffic["corpus"], root)(rng, config, traffic, pats,
                                                words)
    plants = max(1, round(size * traffic["plants_per_64mib"] / (64 * MIB)))
    return w.make_corpus(rng, pats, size, plants=plants, base=base)


def escaped(config: dict) -> bool:
    """Whether the configuration's pattern file is written with escapes
    (``"pattern_file": "escapes"``) and compiled as the CLI's
    ``--escapes`` reads it; without the key it is raw bytes.  Raw stays
    the default: it is the file the upstream's documented ``gphf`` run
    reads, and the program reads it several times faster, which
    ``englishdic.invoke`` pays in every invocation it times."""
    kind = config.get("pattern_file")
    if kind not in (None, "escapes"):
        raise ValueError(f"unknown pattern file format {kind!r}")
    return kind == "escapes"


def pattern_file(pats: list, path: str, escapes: bool = False) -> str:
    """The patterns as the CLI reads them: one a line, in id order; with
    ``escapes`` every byte as ``\\xNN``, so that any byte, a newline too,
    can be in a pattern."""
    if escapes:
        lines = ["".join(f"\\x{b:02x}" for b in p).encode() for p in pats]
    elif any(b"\n" in p for p in pats):
        raise ValueError("a pattern holds a newline")
    else:
        lines = pats
    with open(path, "wb") as f:
        f.write(b"".join(p + b"\n" for p in lines))
    return path
