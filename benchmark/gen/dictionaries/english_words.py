"""``english_words``: the seeded English-like word model's words, the first
``count`` of them the patterns, the first ``text_words`` the words a
``text`` corpus is made of (``words.make_english_words``)."""

import numpy as np

from benchmark.gen import words as w

REHEARSAL = dict(count=400, text_words=400)


def make(d: dict) -> tuple[list, list]:
    words = w.make_english_words(np.random.default_rng(d["seed"]),
                                 d["text_words"])
    return words[:d["count"]], words
