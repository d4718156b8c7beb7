"""Seeded generators of the benchmark's dictionaries and corpora.

Frozen copies of ``chip_smoke.py``'s ``make_corpus``, ``make_english_words``,
``make_titles`` and ``make_english_text`` (with the helpers they use), as
calibrated on the card against the counts of the upstream's word lists
(7,977 English words: 23,884 states, 0.507 matches a byte of their text;
156,000 titles: 441,253 states, 0.366).  Kept here so that a change to
the smoke script never changes what the benchmark measures.  Two
departures: ``make_corpus`` takes its plant count as an argument, and
``make_english_text`` can draw its word ranking from a generator of its
own (``rank_rng``).
"""

from __future__ import annotations

import numpy as np


def make_corpus(rng, pats, size, alphabet=None, plants=1, base=None):
    """``size`` bytes (random over ``alphabet``, or ``base``'s) with
    ``plants`` dictionary patterns at known places; returns (corpus,
    planted (pos, 1-based id) pairs)."""
    if base is not None:
        buf = np.frombuffer(base, np.uint8)[:size].copy()
    elif alphabet is None:
        buf = rng.integers(0, 256, size, dtype=np.uint8)
    else:
        buf = rng.choice(alphabet, size)
    slot = size // plants
    ids = rng.integers(0, len(pats), plants)
    ids[: min(3, plants)] = np.arange(len(pats) - 3, len(pats))  # long ones
    planted = []
    for k, i in enumerate(ids):
        p = pats[int(i)]
        pos = k * slot + int(rng.integers(0, slot - len(p)))
        buf[pos: pos + len(p)] = np.frombuffer(p, np.uint8)
        planted.append((pos, int(i) + 1))
    return buf.tobytes(), planted


# The word-dictionary regimes (``bench.py``'s english, big, full, random):
# word-like strings from one letter chain (letters at English frequencies,
# mostly alternating vowels and consonants), so that the dictionaries share
# prefixes as real ones do and the text holds their words.
LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
LETTER_FREQ = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3,
                        4.0, 2.8, 2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0,
                        0.8, 0.15, 0.15, 0.1, 0.07]) / 100.35
SUFFIXES = (b"s", b"ed", b"ing", b"er", b"ly", b"es", b"ers", b"ness",
            b"tion", b"al", b"ment")
SUFFIX_P = np.array([30, 14, 14, 8, 6, 6, 3, 3, 3, 3, 2]) / 92
TITLE_FORMS = (b"s", b"es", b"er", b"ers", b"ing", b"ed", b" 2", b" 3",
               b" II", b" I")
TITLE_QUALIFIERS = (b" (film)", b" (band)", b" (album)", b" River",
                    b" County", b" (disambiguation)")
FULL_TITLES = 466_543  # the short lowercase titles spread over this many


def letter_chain(seed: int = 12345) -> np.ndarray:
    """Cumulative next-letter probabilities, [27, 26] (row 26: a word's
    first letter), over ``LETTERS``: English letter frequencies times a
    fixed random preference per letter, vowel after vowel and consonant
    after consonant four times less likely."""
    r = np.random.default_rng(seed)
    vowel = np.isin(LETTERS, np.frombuffer(b"aeiouy", np.uint8))
    t = np.empty((27, 26))
    for i in range(27):
        w = LETTER_FREQ * r.dirichlet(np.full(26, 0.3)) ** 0.5
        if i < 26:
            w = w * np.where(vowel == vowel[i], 0.25, 1.0)
        t[i] = w / w.sum()
    return np.cumsum(t, 1)


def chain_words(rng, lengths, cdf) -> list[bytes]:
    """One word from the letter chain ``cdf`` per entry of ``lengths``."""
    n, m = len(lengths), int(max(lengths, default=0))
    cur, out = np.full(n, 26), np.empty((n, m), np.uint8)
    for j in range(m):
        u = rng.random(n)
        cur = np.minimum((cdf[cur] < u[:, None]).sum(1), 25)
        out[:, j] = LETTERS[cur]
    return [row[:k].tobytes() for row, k in zip(out, lengths.tolist())]


def word_lengths(rng, n: int) -> np.ndarray:
    """Stem lengths: 3 + Poisson(4.5) up to 12, one in a hundred 2."""
    lengths = np.minimum(3 + rng.poisson(4.5, n), 12)
    lengths[rng.random(n) < 0.01] = 2
    return lengths


def capital(w: bytes) -> bytes:
    return w[:1].upper() + w[1:]


def make_english_words(rng, count: int = 7_977) -> list[bytes]:
    """``count`` distinct lowercase words (``bench.py``'s english has
    7,977): "a", "i", then stems from the letter chain, each with a
    Poisson(1.8) number of its inflections (-s, -ed, -ing, ...)."""
    cdf = letter_chain()
    words = dict.fromkeys([b"a", b"i"])
    while len(words) < count:
        stems = chain_words(rng, word_lengths(rng, count), cdf)
        forms = rng.poisson(1.8, count)
        for stem, k in zip(stems, forms.tolist()):
            words[stem] = None
            for j in rng.choice(len(SUFFIXES), size=min(k, 4), replace=False,
                                p=SUFFIX_P):
                words[stem + SUFFIXES[j]] = None
            if len(words) >= count:
                break
    return list(words)[:count]


def short_titles(cdf) -> list[bytes]:
    """The one- and two-letter lowercase titles: every letter and the
    10 likeliest two-letter strings of the chain, ordered so that any
    prefix of the list holds about its share of their weight (a letter's
    frequency; a pair's, times the chain's next-letter probability)."""
    step = np.diff(cdf, prepend=0.0, axis=1)
    weight = {bytes([c]): f for c, f in zip(LETTERS.tolist(), LETTER_FREQ)}
    pairs = {bytes([a, b]): LETTER_FREQ[i] * step[i, j]
             for i, a in enumerate(LETTERS.tolist())
             for j, b in enumerate(LETTERS.tolist())}
    for p in sorted(pairs, key=lambda p: -pairs[p])[:10]:
        weight[p] = pairs[p]
    left = sorted(weight, key=lambda w: -weight[w])
    total, have, out = sum(weight.values()), 0.0, []
    while left:  # greedily, the one that keeps the running sum on the line
        goal = total * (len(out) + 1) / len(weight)
        best = min(left, key=lambda w: abs(have + weight[w] - goal))
        left.remove(best)
        out.append(best)
        have += weight[best]
    return out


def make_titles(rng, count: int, n_long: int = 3) -> list[bytes]:
    """``count`` distinct title-like patterns of at most 32 B, then
    ``n_long`` of 33-64 B (the long-pattern split; ``bench.py``'s full
    has one).  Titles come in families from one head word of the letter
    chain (capitalized, or lowercase one time in three where it has 6
    letters or more, as shorter ones would match text often): the head, some
    of its forms (``TITLE_FORMS``), sometimes the head and a second word
    from a shared pool of 2,000, or a qualifier, as a title list's
    entries share their prefixes.  The one- and two-letter lowercase
    titles (``short_titles``) arrive one per ``FULL_TITLES // 36``
    titles, so a list's share of them, and its matches a byte of text,
    grow with its length; the first ``count`` of a longer list are this
    list."""
    cdf = letter_chain()
    short = short_titles(cdf)
    every = FULL_TITLES // len(short)
    pool = [capital(w) for w in chain_words(rng, word_lengths(rng, 2000),
                                            cdf)]
    pool_p = 1.0 / (np.arange(1, len(pool) + 1) + 2.7)
    pool_p /= pool_p.sum()
    out: dict[bytes, None] = {}
    want = count - n_long
    while len(out) < want:
        n = 10_000  # a round's draws, whatever ``count`` is
        lengths = word_lengths(rng, n)
        heads = chain_words(rng, lengths, cdf)
        lower = (rng.random(n) < 1 / 3) & (lengths >= 6)
        forms = rng.poisson(3.0, n)
        extra = rng.random(n)
        second = rng.choice(len(pool), n, p=pool_p)
        qual = rng.integers(0, len(TITLE_QUALIFIERS), n)
        for i, h in enumerate(heads):
            head = h if lower[i] else capital(h)
            family = [head] + [head + TITLE_FORMS[j] for j in rng.choice(
                len(TITLE_FORMS), size=min(int(forms[i]), 6), replace=False)]
            if extra[i] < 0.3:
                family.append(head + b" " + pool[second[i]])
            elif extra[i] < 0.4:
                family.append(head + TITLE_QUALIFIERS[qual[i]])
            for t in family:
                if len(out) >= want:
                    break
                k = len(out) // every
                if len(out) % every == every - 1 and k < len(short) and \
                        short[k] not in out:
                    out[short[k]] = None
                elif len(t) <= 32:
                    out[t] = None
    long = []
    while len(long) < n_long:
        t = b" ".join(pool[int(j)] for j in rng.integers(0, len(pool), 8))
        if 33 <= len(t) <= 64 and t not in out:
            long.append(t)
    return list(out)[:want] + long


def make_english_text(rng, words, size: int, rank_rng=None) -> bytes:
    """``size`` bytes of text over ``words`` at Zipf frequencies (rank
    by length with noise: frequent words are short), words separated by
    spaces, one in 14 by a newline, one in 14 ending a sentence with a
    period and the next word capitalized.  ``rank_rng`` draws the noise
    of the ranking (default ``rng``, as in the original): a deployment
    passes its own, so that every seed's text has the same word
    frequencies and only the order of the words changes."""
    lengths = np.array([len(w) for w in words])
    rank = np.empty(len(words), np.int64)
    noise = (rng if rank_rng is None else rank_rng).exponential(
        2.0, len(words))
    rank[np.argsort(lengths + noise, kind="stable")] = np.arange(len(words))
    p = 1.0 / (rank + 3.7)
    p /= p.sum()
    flat = np.frombuffer(b"".join(words), np.uint8)
    start = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    out, have = [], 0
    while have < size:
        idx = rng.choice(len(words), size=200_000, p=p)
        span = lengths[idx] + 1  # the word and its separator
        total = int(span.sum())
        first = np.cumsum(span) - span
        at = np.arange(total) - np.repeat(first, span)
        end = at == np.repeat(span - 1, span)
        buf = flat[np.minimum(np.repeat(start[idx], span) + at,
                              len(flat) - 1)].copy()
        buf[end] = ord(" ")
        ends = np.flatnonzero(end)
        r = rng.random(len(ends))
        buf[ends[r < 1 / 14]] = ord("\n")
        stop = ends[(r >= 1 / 14) & (r < 2 / 14)]
        buf[stop] = ord(".")
        nxt = stop[stop + 1 < total] + 1
        buf[nxt] = np.where((buf[nxt] >= 97) & (buf[nxt] <= 122),
                            buf[nxt] - 32, buf[nxt])
        out.append(buf.tobytes())
        have += total
    return b"".join(out)[:size]
