"""The yardstick of the scan kernels: the least bytes any scan of a corpus
must move, and the chip's peak rate to move them at.

A scan of ``n`` bytes against a dictionary reads the corpus once, reads
the dictionary's automaton once and writes every result row once.  The
automaton is the whole dictionary's trie, counted at 4 B a state, the
least that a table of its goto edges (one a state but the root) can
hold: however the patterns are split into shards, the shards' tries
hold at least its states.  A row is 8 B, a 4-byte position and a 4-byte
pattern id.  That count holds for any layout of the tables or the
output, any number of shards and any number of passes, so a redesign of
the kernels cannot make it stale.
"""

from __future__ import annotations

import os

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet
STATE_BYTES = 4
ROW_BYTES = 8


def trie_states(patterns: list) -> int:
    """States of the trie of ``patterns``: the root and one a distinct
    non-empty prefix."""
    pats = sorted(set(patterns))
    states, prev = 1, b""
    for p in pats:
        states += len(p) - len(os.path.commonprefix([prev, p]))
        prev = p
    return states


def scan_bytes(corpus_bytes: int, states: int, rows: int) -> int:
    return corpus_bytes + STATE_BYTES * states + ROW_BYTES * rows


def least_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
