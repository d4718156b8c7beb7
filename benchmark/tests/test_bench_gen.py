"""The generators repeat byte for byte per seed; the deployment's
dictionary is the same in every run, the corpus the seed's."""

import hashlib
import json
from pathlib import Path

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


def test_escaped_pattern_file(tmp_path):
    """With ``"pattern_file": "escapes"`` every byte is written as
    ``\\xNN``, a newline too, and the program's reader with ``escapes``
    (the CLI's ``--escapes``) gives the patterns back."""
    from phfpfac_tpu_torch.frontend.patterns import read_patterns

    pats = [b"a\nb", b"\x00\xff\\", b"\r\n\n"]
    assert inputs.escaped(dict(pattern_file="escapes"))
    assert not inputs.escaped({})
    with pytest.raises(ValueError):
        inputs.escaped(dict(pattern_file="hex"))
    path = inputs.pattern_file(pats, str(tmp_path / "p.txt"), escapes=True)
    assert open(path, "rb").read().split(b"\n")[0] == b"\\x61\\x0a\\x62"
    got = read_patterns(path, escapes=True)
    assert [p.data for p in got] == pats
    assert [p.pattern_id for p in got] == [1, 2, 3]


# sha256 of each configuration's dictionary and of the two corpus kinds (1
# MiB, two seeds), taken before the kinds moved into files of their own
# (benchmark/gen/dictionaries/, benchmark/gen/corpora/): the move changed
# no byte of what any cell generates
PINNED = {
    "englishdic":
        "de883b614049cdf1d728082c42b87c5327f2dec31fed5aaea19cae47d03579ff",
    "bigenglishdic":
        "f779469f4aa986b7909951030052debeea955ac50371583f0cbb711718b63bd1",
    "text.7":
        "2963cbc0b67fa681978d09caf6f2841d51167d21077a9efe7b015a64e11f0136",
    "text.2147483655":
        "0495cff342eaa24b17b73a564def1c9e1c619acb786a3f2a488c078b39ed13eb",
    "random.7":
        "adf185ba47ab75e8be168bc46628527132b972c817b8a94b66a0d2d2d8094a1a",
    "random.2147483655":
        "db9b13ba11e847ba75db19bc742d71e2dab8c60d2dbc0c5ea614ca4372f40b9e",
}


def configuration(name):
    root = Path(__file__).resolve().parents[1] / "configs"
    return dict(json.loads((root / f"{name}.json").read_text()), name=name)


@pytest.mark.parametrize("name", ["englishdic", "bigenglishdic"])
def test_dictionaries_pinned(name):
    pats, words = inputs.dictionary(configuration(name))
    assert digest(b"\n".join(pats), b"\n".join(words)) == PINNED[name]


@pytest.mark.parametrize("seed", [7, 2**31 + 7])
@pytest.mark.parametrize("kind", ["text", "random"])
def test_corpora_pinned(kind, seed):
    config = configuration("englishdic")
    pats, words = inputs.dictionary(config)
    traffic = dict(name=kind, corpus=kind, corpus_bytes=1 << 20,
                   plants_per_64mib=100_000)
    corpus, planted = inputs.corpus(config, traffic, pats, words, seed)
    assert digest(corpus, planted) == PINNED[f"{kind}.{seed}"]


def test_unknown_kind():
    with pytest.raises(FileNotFoundError):
        inputs.dictionary(dict(dictionary=dict(kind="nokind", seed=1)))


def test_deployments_keep_the_sources_lengths():
    """No pattern over 32 B: bench.py cuts the title list to 32 B, and the
    English words are shorter; so no shard splits off a host tail."""
    for name in ("englishdic", "bigenglishdic"):
        config = configuration(name)
        pats, _words = inputs.dictionary(config)
        assert len(pats) == config["dictionary"]["count"]
        assert max(map(len, pats)) <= 32, name
