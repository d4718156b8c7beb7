"""``text``: the configuration's words at Zipf frequencies
(``words.make_english_text``).  The ranking of the words comes from the
dictionary's own seed, so every run seed gives the same frequencies in
another order."""

import numpy as np

from benchmark.gen import words as w


def make(rng, config: dict, traffic: dict, pats: list, words: list) -> bytes:
    rank = np.random.default_rng([*np.atleast_1d(
        config["dictionary"]["seed"]).tolist(), 1])
    return w.make_english_text(rng, words, traffic["corpus_bytes"],
                               rank_rng=rank)
