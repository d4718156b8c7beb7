"""Shard-result merge + output rendering.

Reproduces the reference host merge (main.cc:303-324): for every input
position, concatenate each shard's non-(-1) match entries in shard
order, remapping shard-local final states to global 1-based pattern ids
via ``patternIdMap`` (main.cc:314).  Because sorted patterns are split
contiguously and the matches at any single position form a prefix
chain, the merged per-position order equals global
increasing-match-length order — invariant to the shard count (the
``xxxposition`` vs ``allposition`` experiment, SURVEY.md §4).

Output format parity target (main.cc:335-350):
``At position %4d, match pattern %d\n`` per match.
"""

from __future__ import annotations

import numpy as np

from phfpfac_tpu_torch.compile.tables import CompiledDictionary, ShardTables


def _map_ids(shard: ShardTables, local: np.ndarray):
    """Map shard-local final states to global ids, expanding charset
    multi-output finals (frontend.charset).  Returns (take, ids, sub,
    sub_base): row m of the input expands to rows where take==m, with
    output-list order in ``sub`` and ``sub_base`` > max(sub) for
    overflow-free tiebreak keys."""
    if not shard.output_lists:
        take = np.arange(len(local), dtype=np.int64)
        return (
            take,
            shard.pattern_id_map[local].astype(np.int64),
            np.zeros(len(local), dtype=np.int64),
            1,
        )
    take, ids, sub = [], [], []
    for m, st in enumerate(local):
        lst = shard.output_lists.get(int(st))
        if lst is None:
            lst = [int(shard.pattern_id_map[st])]
        for j, pid in enumerate(lst):
            take.append(m)
            ids.append(pid)
            sub.append(j)
    sub_base = max(
        (len(v) for v in shard.output_lists.values()), default=0
    ) + 1
    return (
        np.asarray(take, dtype=np.int64),
        np.asarray(ids, dtype=np.int64),
        np.asarray(sub, dtype=np.int64),
        sub_base,
    )


def merge_match_rows(
    compiled: CompiledDictionary,
    shard_rows: list[np.ndarray],  # per shard: int32 [n_pos, slots], -1 padded
    input_size: int,
) -> np.ndarray:
    """Merge per-shard match rows into a flat [(pos, global id)] array.

    Returns int64 [n_matches, 2] sorted by (pos, shard, slot) — the
    reference's shard-major merge order.  Charset dictionaries sort by
    the canonical (pos, match length, id) instead (see _merge_charset).
    """
    if getattr(compiled, "charset", False):
        parts = []
        for s, rows in enumerate(shard_rows):
            rows = np.asarray(rows)[:input_size]
            p, j = np.nonzero(rows >= 0)
            if p.size == 0:
                continue
            parts.append((compiled.shards[s], p, rows[p, j]))
        return _merge_charset(parts)
    pos_parts, id_parts, shard_parts, slot_parts = [], [], [], []
    for s, rows in enumerate(shard_rows):
        rows = np.asarray(rows)
        rows = rows[:input_size]
        p, j = np.nonzero(rows >= 0)
        if p.size == 0:
            continue
        local = rows[p, j]
        take, ids, sub, sub_base = _map_ids(compiled.shards[s], local)
        pos_parts.append(p[take])
        id_parts.append(ids)
        shard_parts.append(np.full(take.size, s, dtype=np.int64))
        slot_parts.append(j[take] * sub_base + sub)
    if not pos_parts:
        return np.empty((0, 2), dtype=np.int64)
    pos = np.concatenate(pos_parts)
    ids = np.concatenate(id_parts)
    shard = np.concatenate(shard_parts)
    slot = np.concatenate(slot_parts)
    order = np.lexsort((slot, shard, pos))
    return np.stack([pos[order], ids[order]], axis=1)


def _merge_charset(parts) -> np.ndarray:
    """Canonical (pos, match length, pattern id) merge for charset
    dictionaries — the only order invariant to how class patterns were
    sharded (they have no memcmp sort, so the plain contiguous-prefix
    argument in the module docstring does not apply).  Equals the
    single-shard shard-major order: a DFA final's output list is
    ascending-pid and all its patterns share one length
    (frontend.charset.build_class_trie).

    ``parts``: [(shard, pos array, local-final array)] per shard."""
    pos_parts, len_parts, id_parts = [], [], []
    for sh, p, local in parts:
        take, ids, _sub, _base = _map_ids(sh, local)
        pos_parts.append(p[take].astype(np.int64))
        id_parts.append(ids)
        len_parts.append(
            sh.final_depths[np.asarray(local)[take]].astype(np.int64)
        )
    if not pos_parts:
        return np.empty((0, 2), dtype=np.int64)
    pos = np.concatenate(pos_parts)
    ids = np.concatenate(id_parts)
    ln = np.concatenate(len_parts)
    # 3-key lexsort: acceptable here (unlike the plain flat merge,
    # which replaced it — charset dictionaries are NFA->DFA class
    # rulesets, orders of magnitude smaller than the match-dense
    # plain-dict merges that motivated the stable-runs fast path;
    # revisit if charset serving ever reaches millions of matches)
    order = np.lexsort((ids, ln, pos))
    return np.stack([pos[order], ids[order]], axis=1)


def merge_flat_matches(
    compiled: CompiledDictionary,
    shard_flat: list[np.ndarray],  # per shard: int64 [m, 3] (pos, step, local)
    input_size: int,
) -> np.ndarray:
    """Merge per-shard flat (pos, step, local-state) matches.

    Same ordering contract as merge_match_rows: (pos, shard, step);
    charset dictionaries use the canonical (pos, length, id) order."""
    if getattr(compiled, "charset", False):
        parts = []
        for s, m in enumerate(shard_flat):
            if m.size == 0:
                continue
            m = m[m[:, 0] < input_size]
            if len(m):
                parts.append((compiled.shards[s], m[:, 0], m[:, 2]))
        return _merge_charset(parts)
    pos_parts, id_parts, shard_parts, step_parts = [], [], [], []
    for s, m in enumerate(shard_flat):
        if m.size == 0:
            continue
        keep = m[:, 0] < input_size
        if not keep.all():  # padding-region hits only; usually none
            m = m[keep]
        sh = compiled.shards[s]
        if not sh.output_lists:
            # plain-dictionary fast path: _map_ids' take is the
            # identity, so skip the 3 pointless fancy-gathers (they
            # were ~half the merge time at millions of matches on
            # this rig's first-touch-fault-heavy memory)
            pos_parts.append(m[:, 0])
            step_parts.append(m[:, 1])
            id_parts.append(sh.pattern_id_map[m[:, 2]].astype(np.int64))
            shard_parts.append(np.full(len(m), s, dtype=np.int64))
            continue
        take, ids, sub, sub_base = _map_ids(sh, m[:, 2])
        pos_parts.append(m[take, 0])
        step_parts.append(m[take, 1] * sub_base + sub)
        id_parts.append(ids)
        shard_parts.append(np.full(take.size, s, dtype=np.int64))
    if not pos_parts:
        return np.empty((0, 2), dtype=np.int64)

    def _part_sorted(p, st):
        """Part already (pos, step)-sorted? (decode_hits contract;
        verified, not assumed — the turbo engine shares this merge).
        Written with slice views, not np.diff — every intermediate
        allocation here costs real time at millions of rows on this
        rig's first-touch-fault-heavy memory."""
        if p.size < 2:
            return True
        a, b = p[:-1], p[1:]
        if (b < a).any():
            return False
        same = a == b
        return not same.any() or bool(
            (st[1:][same] >= st[:-1][same]).all()
        )

    # single part: no concat copies needed at all
    if len(pos_parts) == 1:
        pos, ids = pos_parts[0], id_parts[0]
    else:
        pos = np.concatenate(pos_parts)
        ids = np.concatenate(id_parts)
    # per-shard flats arrive (pos, step)-sorted (decode_hits contract),
    # so the (pos, shard, step) ordering reduces to ONE stable sort by
    # pos over the shard-major concat — stability preserves shard then
    # step order at equal pos, and timsort's run detection makes
    # sorting a concat of sorted runs near-linear (the 3-key lexsort
    # was the match-dense merge bottleneck at ~14M rows)
    if all(map(_part_sorted, pos_parts, step_parts)):
        if len(pos_parts) == 1 or bool((np.diff(pos) >= 0).all()):
            # already in (pos, shard, step) order (equal positions
            # across shards land in concat = shard order): emit
            # without sorting or permuting — at 14M match-dense rows
            # the order-gathers alone cost seconds on this rig
            return np.stack([pos, ids], axis=1)
        order = np.argsort(pos, kind="stable")
    else:
        shard = np.concatenate(shard_parts)
        step = np.concatenate(step_parts)
        order = np.lexsort((step, shard, pos))
    return np.stack([pos[order], ids[order]], axis=1)


def render_result_file(matches: np.ndarray) -> str:
    """Render ``GPU_match_result.txt`` content (main.cc:335-350)."""
    return "".join(
        f"At position {int(p):4d}, match pattern {int(i)}\n" for p, i in matches
    )
