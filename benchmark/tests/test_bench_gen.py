"""The generators repeat byte for byte per seed; the deployment's
dictionary is the same in every run, the corpus the seed's."""

import hashlib

import numpy as np
import pytest

from benchmark.gen import inputs
from benchmark.gen import words as w

CONFIG = dict(name="d", dictionary=dict(kind="titles", count=3000, long=3,
                                        text_words=600, seed=[0, 3]))
TRAFFIC = dict(name="t", corpus="text", corpus_bytes=1 << 18,
               plants_per_64mib=100_000)


def digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else repr(p).encode())
    return h.hexdigest()


def test_generators_repeat_per_seed():
    def make(seed):
        rng = np.random.default_rng(seed)
        words = w.make_english_words(rng, 500)
        titles = w.make_titles(rng, 2000)
        text = w.make_english_text(rng, words, 1 << 16)
        corpus, planted = w.make_corpus(rng, titles, 1 << 16, plants=50,
                                        base=text)
        rand, planted2 = w.make_corpus(rng, words, 1 << 16, plants=50)
        return digest(b"".join(words), b"".join(titles), corpus, planted,
                      rand, planted2)

    assert make(5) == make(5)
    assert make(5) != make(6)


def test_english_text_rank_rng():
    """With one ``rank_rng`` seed, two run seeds give the same word
    frequencies in another order."""
    words = w.make_english_words(np.random.default_rng(1), 300)

    def top(run_seed):
        text = w.make_english_text(np.random.default_rng(run_seed), words,
                                   1 << 18, rank_rng=np.random.default_rng(9))
        counts = {}
        for t in text.lower().replace(b".", b" ").split():
            counts[t] = counts.get(t, 0) + 1
        return text, [t for t, _ in sorted(counts.items(),
                                           key=lambda kv: -kv[1])[:5]]

    (a, top_a), (b, top_b) = top(2), top(3)
    assert a != b and top_a == top_b


def test_dictionary_fixed_corpus_by_seed():
    p1, words1 = inputs.dictionary(CONFIG)
    p2, words2 = inputs.dictionary(CONFIG)
    assert p1 == p2 and words1 == words2
    assert len(p1) == 3000 and len(set(p1)) == 3000
    assert sum(len(p) > 32 for p in p1) == 3  # the host tail's
    c1, pl1 = inputs.corpus(CONFIG, TRAFFIC, p1, words1, 2**31 + 7)
    c1b, pl1b = inputs.corpus(CONFIG, TRAFFIC, p1, words1, 2**31 + 7)
    c2, pl2 = inputs.corpus(CONFIG, TRAFFIC, p1, words1, 2**31 + 8)
    assert c1 == c1b and pl1 == pl1b
    assert c1 != c2 and len(c1) == len(c2) == 1 << 18
    assert len(pl1) == len(pl2) == round((1 << 18) * 100_000 / (64 << 20))


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40, -3])
def test_any_whole_seed(seed):
    rng = inputs.run_rng(seed, "a", "b")
    assert 0 <= rng.integers(0, 10) < 10


def test_pattern_file(tmp_path):
    path = inputs.pattern_file([b"ab", b"c d"], str(tmp_path / "p.txt"))
    assert open(path, "rb").read() == b"ab\nc d\n"
    with pytest.raises(ValueError):
        inputs.pattern_file([b"a\nb"], str(tmp_path / "q.txt"))


def test_deployments_keep_the_sources_lengths():
    """No pattern over 32 B: bench.py cuts the title list to 32 B, and the
    English words are shorter; so no shard splits off a host tail."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "configs"
    for name in ("englishdic", "bigenglishdic"):
        config = json.loads((root / f"{name}.json").read_text())
        pats, _words = inputs.dictionary(dict(config, name=name))
        assert len(pats) == config["dictionary"]["count"]
        assert max(map(len, pats)) <= 32, name
