"""``titles``: ``count`` seeded titles in families of a head word and its
forms, ``long`` of them over 32 B (``words.make_titles``), over the text
of ``text_words`` English-like words drawn first from the same
generator."""

import numpy as np

from benchmark.gen import words as w

REHEARSAL = dict(count=400, text_words=400)


def make(d: dict) -> tuple[list, list]:
    rng = np.random.default_rng(d["seed"])
    words = w.make_english_words(rng, d["text_words"])
    return w.make_titles(rng, d["count"], n_long=d["long"]), words
