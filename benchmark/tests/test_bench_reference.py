"""The plain reference against the upstream's own small cases, cases cut
by hand, and a brute force of its definition."""

import numpy as np
import pytest

from benchmark.reference.ac import Automaton, rotated


def pick(rng, alphabet: bytes, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(alphabet, np.uint8), int(n)))


def brute(pats, data, segment=None, halo=0):
    """Every (position, id, length) by the definition, one by one."""
    rows = []
    for i in range(len(data)):
        for pid, p in enumerate(pats, 1):
            end = i + len(p)
            if data[i:end] != p or end > len(data):
                continue
            if segment and end > (i // segment + 1) * segment + halo:
                continue
            rows.append((i, len(p), pid))
    rows.sort()
    return np.asarray([(i, pid, n) for i, n, pid in rows],
                      np.int64).reshape(-1, 3)


def test_overlap_torture():
    """The upstream's experimentpattern (aaaa/aa/a/aaa) over a run of 12
    a's: positions 0-8 report a, aa, aaa, aaaa (ids 3, 2, 4, 1), the
    last three fewer, then the lone a's."""
    pats = [b"aaaa", b"aa", b"a", b"aaa"]
    data = b"a" * 12 + b"bbb" + b"ab" * 5
    got = Automaton(pats).find(data)[:, :2].tolist()
    want = [[p, i] for p in range(9) for i in (3, 2, 4, 1)]
    want += [[9, 3], [9, 2], [9, 4], [10, 3], [10, 2], [11, 3]]
    want += [[p, 3] for p in (15, 17, 19, 21, 23)]
    assert got == want


@pytest.mark.parametrize("start,length,kept", [
    (0, 4, True),        # inside its segment
    (6, 4, True),        # 6 + 4 = 10 <= 8 + 2
    (6, 5, False),       # 11 > 10: past the halo
    (7, 3, True),        # ends on the halo's last byte
    (8, 4, True),        # the next segment's own
    (15, 3, True),       # 18 <= 16 + 2
    (15, 4, False),      # 19 > 18
])
def test_segment_cut_by_hand(start, length, kept):
    """A segment of 8 bytes, a halo of 2: an occurrence at ``start`` of
    ``length`` bytes is kept iff it ends by its segment's end + 2."""
    data = bytearray(b"." * 24)
    data[start:start + length] = b"x" * length
    got = Automaton([b"x" * length]).find(bytes(data), segment=8, halo=2)
    assert (start in got[:, 0].tolist()) == kept


@pytest.mark.parametrize("seed", range(40))
def test_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    alpha = b"abc"[:1 + seed % 3]
    pats = list(dict.fromkeys(pick(rng, alpha, rng.integers(1, 7))
                              for _ in range(int(rng.integers(1, 12)))))
    data = pick(rng, alpha + b"d", rng.integers(1, 300))
    segment = (None, 8, 16)[seed % 3]
    halo = int(rng.integers(0, 4))
    got = Automaton(pats).find(data, segment=segment, halo=halo)
    assert np.array_equal(got, brute(pats, data, segment, halo))


@pytest.mark.parametrize("seed", range(8))
def test_ring_rotations(seed):
    """A ring read from any segment-aligned start: the ring's rows
    rotated and cut equal a search of the rotated bytes."""
    rng = np.random.default_rng(100 + seed)
    pats = list(dict.fromkeys(pick(rng, b"ab", rng.integers(1, 6))
                              for _ in range(6)))
    ring = pick(rng, b"abc", 64)
    ac = Automaton(pats)
    rows = ac.find(ring + ring[:ac.max_len - 1], starts_before=64,
                   segment=8, halo=1)
    for shift in range(0, 64, 8):
        want = brute(pats, ring[shift:] + ring[:shift], 8, 1)
        got = rotated(rows, 64, shift, ac.max_len)
        assert np.array_equal(got, want)


def test_refuses_duplicates():
    with pytest.raises(ValueError):
        Automaton([b"ab", b"ab"])
