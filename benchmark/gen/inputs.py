"""The one general generator: a configuration's dictionary and a traffic
mix's corpus, from their files' parameters and the run's seed.

The dictionary is the deployment's: it comes from the configuration's own
``dictionary.seed`` and is the same in every run.  So are the text's word
frequencies.  The run's seed draws the corpus: which words follow which,
the random bytes, and where the dictionary's patterns are planted.  Every
seed gets the same sizes, the same number of plants and the same mix.
"""

from __future__ import annotations

import zlib

import numpy as np

from benchmark.gen import words as w

MIB = 1 << 20


def dictionary(config: dict) -> tuple[list, list]:
    """(patterns, the words the text is made of) of a configuration:
    ``english_words`` (the words are the patterns) or ``titles`` (titles
    over the same words' text)."""
    d = config["dictionary"]
    rng = np.random.default_rng(d["seed"])
    words = w.make_english_words(rng, d["text_words"])
    if d["kind"] == "english_words":
        pats = words[:d["count"]]
    elif d["kind"] == "titles":
        pats = w.make_titles(rng, d["count"], n_long=d["long"])
    else:
        raise ValueError(f"unknown dictionary kind {d['kind']!r}")
    return pats, words


def run_rng(seed: int, *names) -> np.random.Generator:
    """The run's generator: its seed (any whole number) and the names of
    what it draws for."""
    return np.random.default_rng([seed % (1 << 64),
                                  *(zlib.crc32(n.encode()) for n in names)])


def corpus(config: dict, traffic: dict, pats: list, words: list,
           seed: int) -> tuple[bytes, list]:
    """(corpus, planted (position, id)) of ``traffic["corpus_bytes"]``
    bytes: ``text`` over the configuration's words at their frequencies,
    or ``random`` bytes, with one planted pattern per
    ``64 MiB / plants_per_64mib`` bytes."""
    size = traffic["corpus_bytes"]
    rng = run_rng(seed, config["name"], traffic["name"])
    base = None
    if traffic["corpus"] == "text":
        rank = np.random.default_rng([*np.atleast_1d(
            config["dictionary"]["seed"]).tolist(), 1])
        base = w.make_english_text(rng, words, size, rank_rng=rank)
    elif traffic["corpus"] != "random":
        raise ValueError(f"unknown corpus kind {traffic['corpus']!r}")
    plants = max(1, round(size * traffic["plants_per_64mib"] / (64 * MIB)))
    return w.make_corpus(rng, pats, size, plants=plants, base=base)


def pattern_file(pats: list, path: str) -> str:
    """The patterns as the CLI reads them: one a line, in id order."""
    if any(b"\n" in p for p in pats):
        raise ValueError("a pattern holds a newline")
    with open(path, "wb") as f:
        f.write(b"".join(p + b"\n" for p in pats))
    return path
