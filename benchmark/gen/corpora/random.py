"""``random``: uniform random bytes over the whole byte alphabet."""

import numpy as np


def make(rng, config: dict, traffic: dict, pats: list, words: list) -> bytes:
    return rng.integers(0, 256, traffic["corpus_bytes"],
                        dtype=np.uint8).tobytes()
