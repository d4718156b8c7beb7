"""The plain reference: Aho-Corasick over the whole input in NumPy, with
the upstream's walk cut and output order written from their definitions.

What the upstream tool ``gphf`` reports (``regex_GPU_PHF`` of
mickeyjoe666/PHFPFAC), and so what this module computes:

* Patterns carry 1-based ids in the order of the pattern file.
* Pattern ``p`` of length ``L`` occurs at start position ``i`` of an input
  of ``n`` bytes when ``data[i:i + L] == p`` and ``i + L <= n``.
* The cut (``master_kernel.cu``): a thread block owns a segment of
  ``segment`` bytes and loads a ``halo`` beyond it; a walk that starts at
  ``i`` reads no further than the end of its block's load, so the
  occurrence is reported only when ``i + L <= (i // segment + 1) *
  segment + halo``.  With ``segment=None`` nothing is cut.
* The order: by position, then by length.  The occurrences at one position
  form a prefix chain, and the upstream lists the memcmp-sorted patterns'
  matches shard by shard and step by step, that is, shortest first.

Nothing here imports the program under test; the automaton is built from
the pattern bytes alone.  It is the Aho-Corasick automaton of the reversed
patterns, run over the input from its last byte to its first: it finds
every occurrence at its first byte, each position's occurrences together
from the longest down, so that the upstream's order needs no sort.  A
different route from the program's walks from each start.
"""

from __future__ import annotations

import numpy as np


class Automaton:
    """The Aho-Corasick automaton of ``patterns`` (distinct, non-empty
    byte strings) read backwards, as a complete transition table over
    byte classes."""

    def __init__(self, patterns):
        patterns = [bytes(p)[::-1] for p in patterns]
        if not patterns or not all(patterns):
            raise ValueError("need non-empty patterns")
        if len(set(patterns)) != len(patterns):
            raise ValueError("patterns must be distinct")
        used = sorted(set(b"".join(patterns)))
        # class 0: every byte no pattern holds; it leads back to the root
        self.byte_class = np.zeros(256, np.int32)
        self.byte_class[used] = np.arange(1, len(used) + 1)
        n_cls = len(used) + 1
        cls_of = self.byte_class.tolist()

        # the trie: node 0 is the root
        children = [{}]
        parent, via, depth, final = [0], [0], [0], [0]
        for pid, p in enumerate(patterns, 1):
            node = 0
            for b in p:
                c = cls_of[b]
                nxt = children[node].get(c)
                if nxt is None:
                    nxt = len(children)
                    children.append({})
                    children[node][c] = nxt
                    parent.append(node)
                    via.append(c)
                    depth.append(depth[node] + 1)
                    final.append(0)
                node = nxt
            final[node] = pid
        n = len(children)
        parent = np.asarray(parent, np.int64)
        via = np.asarray(via, np.int64)
        self.depth = np.asarray(depth, np.int32)
        self.final = np.asarray(final, np.int32)  # pattern id, 0 = none
        self.states = n
        self.max_len = int(self.depth.max())

        # goto completed by the failure function, a level at a time
        goto = np.zeros((n, n_cls), np.int32)
        fail = np.zeros(n, np.int64)
        by_depth = np.argsort(self.depth, kind="stable")
        bounds = np.searchsorted(self.depth[by_depth],
                                 np.arange(self.max_len + 2))
        for d in range(self.max_len + 1):
            level = by_depth[bounds[d]:bounds[d + 1]]
            if d >= 2:
                fail[level] = goto[fail[parent[level]], via[level]]
            if d >= 1:
                goto[level] = goto[fail[level]]
            kids = by_depth[bounds[d + 1]:bounds[d + 2]] if d < self.max_len \
                else by_depth[:0]
            goto[parent[kids], via[kids]] = kids
        self.goto = goto
        self.fail = fail
        # the nearest proper suffix that is a pattern (0: none)
        link = np.zeros(n, np.int32)
        for d in range(2, self.max_len + 1):
            level = by_depth[bounds[d]:bounds[d + 1]]
            f = fail[level]
            link[level] = np.where(self.final[f] > 0, f, link[f])
        self.link = link
        # occurrences a state reports: itself if final, and its link's
        count = (self.final > 0).astype(np.int32)
        for d in range(2, self.max_len + 1):
            level = by_depth[bounds[d]:bounds[d + 1]]
            count[level] += np.where(link[level] > 0, count[link[level]], 0)
        self.count = count
        self.emits = count > 0

    def states_at(self, data: np.ndarray, lane: int = 1024) -> np.ndarray:
        """The automaton's state after each byte of ``data`` (uint8), run
        in independent lanes of ``lane`` bytes that each start
        ``max_len`` bytes early from the root: after that many bytes the
        state no longer depends on where the walk began."""
        n = len(data)
        m = self.max_len
        lanes = max(-(-n // lane), 1)
        cls = np.zeros(m + lanes * lane, np.int32)
        cls[m:m + n] = self.byte_class[data]
        view = np.lib.stride_tricks.as_strided(
            cls, shape=(lanes, lane + m), strides=(lane * 4, 4),
            writeable=False)
        flat = self.goto.reshape(-1)
        width = self.goto.shape[1]
        state = np.zeros(lanes, np.int64)
        for t in range(m):  # the lead-in
            state = flat[state * width + view[:, t]]
        out = np.empty((lane, lanes), np.int32)
        for t in range(lane):
            state = flat[state * width + view[:, m + t]]
            out[t] = state
        return out.T.reshape(-1)[:n]

    def find(self, data: bytes, *, segment=None, halo=0,
             starts_before=None) -> np.ndarray:
        """Every occurrence in ``data`` (the whole input), cut and ordered
        as the upstream reports them: int32 rows (position, pattern id,
        length).  ``starts_before``: keep only occurrences that start
        before it, so that a caller can pass a ring followed by its own
        first bytes and see the occurrences across the ring's end."""
        n = len(data)
        limit = n if starts_before is None else starts_before
        st = self.states_at(np.frombuffer(data, np.uint8)[::-1])
        # the state after reading back to byte i holds the occurrences
        # that start at i; from the last position read to the first
        q = np.flatnonzero(self.emits[st])[::-1]
        q = q[q > n - 1 - limit]
        first = st[q]
        count = self.count[first]
        slot = np.cumsum(count) - 1  # where each start's longest goes
        node = np.where(self.final[first] > 0, first, self.link[first])
        nodes = np.empty(int(slot[-1]) + 1 if len(slot) else 0, np.int32)
        while node.size:  # the longest last, each shorter one before it
            nodes[slot] = node
            node = self.link[node]
            more = node > 0
            node, slot = node[more], slot[more] - 1
        rows = np.empty((len(nodes), 3), np.int32)
        rows[:, 0] = np.repeat((n - 1 - q).astype(np.int32), count)
        rows[:, 1] = self.final[nodes]
        rows[:, 2] = self.depth[nodes]
        if segment and self.max_len > halo + 1:  # else nothing is cut
            rows = rows[rows[:, 0] % segment + rows[:, 2] <= segment + halo]
        return rows


def rotated(rows: np.ndarray, n: int, shift: int,
            max_len: int) -> np.ndarray:
    """The rows of an input that is a ring of ``n`` bytes read from
    ``shift`` on (``ring[shift:] + ring[:shift]``), in order, from
    ``rows``: the ring's own occurrences found across its end (``find``
    over the ring and its first ``max_len - 1`` bytes, with
    ``starts_before=n``), already cut.  Those that would run past the
    rotated input's end are left out; where ``shift`` and ``n`` are whole
    segments, every other keeps its place in its segment, and so its cut."""
    pos, length = rows[:, 0], rows[:, 2]
    at = int(np.searchsorted(pos, shift))
    # only rows that start within max_len of the end can run past it
    a_end = max(at, int(np.searchsorted(pos, n + shift - max_len)))
    b_end = int(np.searchsorted(pos[:at], shift - max_len))
    a_tail = rows[a_end:][pos[a_end:] - shift + length[a_end:] <= n]
    b_tail = rows[b_end:at][pos[b_end:at] + length[b_end:at] <= shift]
    pieces = [(rows[at:a_end], -shift), (a_tail, -shift),
              (rows[:b_end], n - shift), (b_tail, n - shift)]
    out = np.empty((sum(len(p) for p, _ in pieces), 3), rows.dtype)
    i = 0
    for p, d in pieces:
        out[i:i + len(p)] = p
        out[i:i + len(p), 0] += d
        i += len(p)
    return out


REFERENCE = Automaton
