"""Failureless Aho-Corasick trie construction.

Replicates the numbering contract of ``patternsToPFAC``
(CreateTable/create_table_reorder.c:277-378), which the device kernel
relies on (master_kernel.cu:12, :44, :67):

* patterns arrive sorted (prefixes before extensions);
* final state for the shard's i-th pattern is literally ``i``
  (0 <= i < k), written by overwriting the last transition
  (create_table_reorder.c:366) — so a duplicate pattern later in sorted
  order steals the final state of the earlier one;
* ``initial_state = k + 1`` (state ``k`` is never used);
* interior states are allocated from ``k + 2`` upward in insertion
  order;
* the dense table is ``int32[state_count, 256]`` with -1 = no
  transition; transitions *out of* final states are real rows
  (0..k-1), which is how overlapping prefixes keep matching mid-walk.

This NumPy builder is the portable path; ``phfpfac_tpu_torch.compile._native``
provides a C++ drop-in for Snort-scale dictionaries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.utils.config import CHAR_SET

# Reference MAX_STATE = INT_MAX (ctdef.h:9); state-count overflow check
# at create_table_reorder.c:371-374.
MAX_STATE = 2**31 - 1


@dataclass
class TrieTables:
    """Dense PFAC transition table for one dictionary shard."""

    table: np.ndarray  # int32 [state_count, 256], -1 = dead
    state_num: int  # total allocated states (== table.shape[0])
    final_state_num: int  # k: final states are 0..k-1
    max_pat_len: int
    pattern_id_map: np.ndarray  # int32 [k]: shard-local final state -> global id

    @property
    def initial_state(self) -> int:
        return self.final_state_num + 1

    @property
    def s0(self) -> np.ndarray:
        """Initial-state row (the reference uploads it separately as
        s0Table, main.cc:200)."""
        return self.table[self.initial_state]


def build_pfac_trie(
    shard_patterns: list[Pattern], *, use_native: bool | None = None
) -> TrieTables:
    """Build the failureless-AC dense table for one shard of sorted patterns.

    Uses the C++ implementation (compile.native) when available — the
    per-byte trie insertion is the reference's host hot path
    (create_table_reorder.c:315-375) — with this NumPy version as the
    portable fallback and semantics oracle.
    """
    k = len(shard_patterns)
    if use_native is not False and k:
        from phfpfac_tpu_torch.compile import native

        if native.available():
            table, state_num, max_len = native.build_trie_native(
                [p.data for p in shard_patterns]
            )
            return TrieTables(
                table=table,
                state_num=state_num,
                final_state_num=k,
                max_pat_len=max_len,
                pattern_id_map=np.array(
                    [p.pattern_id for p in shard_patterns], dtype=np.int32
                ),
            )
    initial_state = k + 1
    state_count = initial_state + 1  # next state to allocate

    # Grow-on-demand dense table.  Start with a generous estimate:
    # sum of pattern lengths bounds interior states.
    cap = state_count + sum(len(p) for p in shard_patterns) + 1
    table = np.full((cap, CHAR_SET), -1, dtype=np.int32)

    pattern_id_map = np.empty(k, dtype=np.int32)
    max_pat_len = 0

    for i, pat in enumerate(shard_patterns):
        data = pat.data
        pattern_id_map[i] = pat.pattern_id
        if len(data) > max_pat_len:
            max_pat_len = len(data)
        state = initial_state
        # interior transitions for all but the last byte
        # (create_table_reorder.c:325-359)
        for j in range(len(data) - 1):
            ch = data[j]
            nxt = table[state, ch]
            if nxt == -1:
                table[state, ch] = state_count
                state = state_count
                state_count += 1
                if state_count > MAX_STATE:
                    raise OverflowError(
                        "State number overflow; reduce patterns per shard "
                        "(create_table_reorder.c:371-374)"
                    )
            else:
                state = nxt
        # last byte transitions to the final state == pattern index
        # (create_table_reorder.c:362-366; overwrites on duplicates)
        table[state, data[-1]] = i

    table = table[:state_count]
    return TrieTables(
        table=table,
        state_num=state_count,
        final_state_num=k,
        max_pat_len=max_pat_len,
        pattern_id_map=pattern_id_map,
    )
