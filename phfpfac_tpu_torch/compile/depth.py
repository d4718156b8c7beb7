"""Depth-stratified PFAC tables — the layout behind the fast TPU kernel.

The banked-LUT probe cost on TPU is linear in the probed table's size
(ops.pallas_scan._lut: ~3 vector ops per 128 table entries), and the
reference-shaped PHF (one table for the whole automaton,
master_kernel.cu:52-64) makes every walk step pay for the WHOLE
dictionary.  But a PFAC trie is a tree: after t probes a live walk is
at depth exactly t+1, so step t can only ever probe transitions out of
depth-t states.  Stratifying the transition table by depth means a
full walk pays the total table cost once, spread across steps, instead
of per step — an asymptotic win of ~(average walk depth)x.

Two further layout tricks remove the r[] displacement lookup entirely:

* **Distinct displacements.**  The per-depth FFDM variant here forbids
  two rows (states) from sharing a displacement.  Then a slot index
  ``disp + c`` uniquely determines the owning (state, char) key, so
  probe verification reduces to comparing the stored char — no row id
  needed (the reference verifies with HT[idx] == row,
  master_kernel.cu:56-64).
* **Displacement chaining.**  Each table value carries the NEXT
  state's displacement into the next depth's table (instead of the
  state id), so the device walk is
      idx = disp + c;  g = T_t[idx]
      hit = g >= 0 and (g & 0xFF) == c
      disp' = g >> 9;  final = (g >> 8) & 1
  with no separate r[] gather per step.

Entry layout (int32): ``(next_disp << 9) | (is_final << 8) | char``,
with ``next_disp == DISP_MISS`` (all-ones, 22 bits) for walks that
must die next step (leaf states, deepest level).  Empty slots are -1;
the verify char can never equal the miss sentinel's low byte because
the ``g >= 0`` term rejects it first.

Applies to any leveled-acyclic automaton: plain-pattern tries
directly, and charset-class DFAs (DAGs) by listing a state in every
level it reaches — multi-output final expansion stays in the host
merge (parallel.merge).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from phfpfac_tpu_torch.compile.tables import ShardTables

_LANE = 128

DISP_BITS = 22
DISP_MISS = (1 << DISP_BITS) - 1
MAX_DEPTH_STEPS = 32  # bitmap width; matches ops.pallas_scan.MAX_BITMAP_STEPS


class DepthUnsupported(ValueError):
    """The automaton cannot be depth-stratified (not a tree / too deep)."""


_EMPTY = -(1 << 60)  # "row has no keys" sentinel in _layout_distinct


@dataclass
class DepthTables:
    """Banked per-depth tables for the depth kernel (one shard)."""

    s0_banks: np.ndarray  # int32 (2, 128): (disp<<1)|fin per char, -1 none
    packed_banks: np.ndarray  # int32 (NB, 128): concat of T_1..T_{D-1}
    offs: tuple  # bank offset of T_t within packed_banks, t = 1..D-1
    nbs: tuple  # bank count of T_t
    k0s: tuple  # leading trimmed banks per T_t (ops.pallas_scan._lut k0)
    n_steps: int  # D = deepest pattern length = total walk steps (incl s0)
    max_pat_len: int
    num_final: int


def _reconstruct_dense(shard: ShardTables) -> np.ndarray:
    """Dense int32 [state_num, 256] table, inverted from the PHF.

    Every occupied hash slot i encodes exactly one key: the owning row
    is ht[i] and its column is i - r[row] (the displacement identity,
    phf.c:211-216) — so the sparse table recovers in O(ht_size)
    instead of probing all state_num * 256 candidate keys.
    """
    dense = np.full((shard.state_num, 256), -1, dtype=np.int32)
    idx = np.flatnonzero(shard.ht >= 0)
    rows = shard.ht[idx].astype(np.int64)
    cols = idx - shard.r[rows]
    keys = rows * shard.width + cols
    states = keys >> 8
    chars = keys & 255
    # guard against corrupt/truncated tables: negative cols (r[row]
    # past the slot) would otherwise wrap through negative indexing
    keep = (states >= 0) & (states < shard.state_num) & (cols >= 0) \
        & (cols < shard.width)
    dense[states[keep], chars[keep]] = shard.val[idx[keep]]
    return dense


def _bfs_levels(dense: np.ndarray, init: int) -> list[np.ndarray]:
    """Leveled expansion: levels[i] = sorted states reachable at depth
    i+1.

    Plain-pattern tries visit each state at exactly one depth; charset
    DFAs (subset construction) are DAGs whose states may recur at
    several depths — they are simply listed in every level they reach
    (level-local classes keep table sizes in check).  Raises
    DepthUnsupported past MAX_DEPTH_STEPS levels (deeper than the
    match bitmap, or a cyclic automaton — impossible for finite
    dictionaries, but guarded).
    """
    levels: list[np.ndarray] = []
    cur = np.array([init], dtype=np.int64)
    while True:
        rows = dense[cur]
        ns = rows[rows >= 0].astype(np.int64)
        if ns.size == 0:
            break
        uniq = np.unique(ns)
        levels.append(uniq)
        cur = uniq
        if len(levels) > MAX_DEPTH_STEPS:
            raise DepthUnsupported("automaton deeper than the bitmap width")
    return levels


def _layout_distinct(
    cols_list: list[np.ndarray], cap: int, *, colspan: int = 256,
    force_offset: np.ndarray | None = None,
    side_cols_list: list[np.ndarray] | None = None,
    priority: np.ndarray | None = None,
) -> tuple:
    """First-fit-descending row displacement with DISTINCT offsets.

    Same scheme as compile.phf.build_phf (phf.c:151-291) restricted to
    one row per state (col = symbol in [0, colspan)), plus the
    constraint that no two rows share an offset — which is what makes
    symbol-only probe verification sound.  Rows with no cols but
    ``force_offset`` set still receive a fresh distinct offset (needed
    when a side table is keyed by this row's displacement).

    ``side_cols_list`` places a SECOND keyed table at the same
    offsets (compile.pair's odd-completion bytes): its slots occupy a
    separate address space but must also be overwrite-free across
    rows, so they get their own occupancy array.

    Returns (offsets int64 [n] (_EMPTY = no offset), ht_len) with
    offsets rebased to min 0.
    """
    n = len(cols_list)
    counts = np.array([len(c) for c in cols_list], dtype=np.int64)
    if priority is not None:
        order = np.lexsort((-counts, -np.asarray(priority, np.int64)))
    else:
        order = np.argsort(-counts, kind="stable")
    occ = np.zeros(cap + 3 * colspan, dtype=bool)
    side_occ = np.zeros(cap + 3 * colspan, dtype=bool)
    used_off = np.zeros(cap + 2 * colspan, dtype=bool)  # off + colspan
    # raw offsets may be negative (down to -(colspan-1))
    offsets = np.full(n, _EMPTY, dtype=np.int64)
    window = 2048
    # slots below first_free are all occupied, so offsets with
    # offset + cols[0] < first_free are provably blocked — an EXACT
    # skip that keeps the sparse tail of 1-col rows from rescanning
    # the table front (same trick as the native FFDM)
    first_free = 0
    for i in order:
        cols = cols_list[i]
        side = (
            side_cols_list[i]
            if side_cols_list is not None
            else np.empty(0, dtype=np.int64)
        )
        if (
            len(cols) == 0
            and len(side) == 0
            and (force_offset is None or not force_offset[i])
        ):
            continue
        if len(cols):
            while occ[first_free + colspan]:
                first_free += 1
            start = max(-int(cols[0]), first_free - int(cols[0]))
        else:
            start = 0
        offset = None
        while start < cap:
            length = min(window, cap - start)
            bad = used_off[start + colspan : start + colspan + length].copy()
            # occupancy arrays are biased by +colspan so slots from
            # negative candidate offsets index safely
            for c in cols:
                s = start + int(c) + colspan
                bad |= occ[s : s + length]
            for c in side:
                s = start + int(c) + colspan
                bad |= side_occ[s : s + length]
            free = np.flatnonzero(~bad)
            if free.size:
                offset = start + int(free[0])
                break
            start += length
        if offset is None:
            raise RuntimeError("distinct-offset layout overflow")
        if len(cols):
            occ[offset + cols + colspan] = True
        if len(side):
            side_occ[offset + side + colspan] = True
        used_off[offset + colspan] = True
        offsets[i] = offset
    live = offsets != _EMPTY
    if live.any():
        mn = int(offsets[live].min())
        offsets[live] -= mn
        ht_len = int(
            max(
                offsets[i] + (int(cols_list[i][-1]) if len(cols_list[i]) else 0)
                for i in range(n)
                if live[i]
            )
        ) + 1
    else:
        ht_len = 1
    return offsets, ht_len


def _layout_with_growth(
    cols_list: list[np.ndarray], *, colspan: int = 256,
    force_offset: np.ndarray | None = None,
    side_cols_list: list[np.ndarray] | None = None,
    priority: np.ndarray | None = None,
) -> tuple:
    total = int(sum(len(c) for c in cols_list)) + len(cols_list)
    if side_cols_list is not None:
        total += int(sum(len(c) for c in side_cols_list))
    cap = max(2048, 4 * total)
    while True:
        try:
            return _layout_distinct(
                cols_list, cap, colspan=colspan, force_offset=force_offset,
                side_cols_list=side_cols_list, priority=priority,
            )
        except RuntimeError:
            cap *= 2
            if cap > (1 << DISP_BITS):
                raise DepthUnsupported("depth table exceeds disp bits")


def _layout_csr(
    cols_offs: np.ndarray, cols_blob: np.ndarray, *, colspan: int = 256,
    force_offset: np.ndarray | None = None,
    side_offs: np.ndarray | None = None,
    side_blob: np.ndarray | None = None,
    side_alias_mask: int = 0,
    side_span: int = 0,
    priority: np.ndarray | None = None,
) -> tuple:
    """CSR-form distinct-offset layout with capacity growth.

    Same placement as _layout_distinct (the C++ path is exact,
    tests/test_native.py); returns (offsets int64 [n], ht_len).
    ``side_alias_mask`` (native only — callers gate on
    native.available()) adds the anti-aliasing constraints that make
    compact nibble side verification sound.
    """
    from phfpfac_tpu_torch.compile import native

    n = len(cols_offs) - 1
    total = int(len(cols_blob)) + n
    if side_blob is not None:
        total += int(len(side_blob))
    cap = max(2048, 4 * total)
    if native.available():
        while True:
            res = native.layout_distinct_native(
                cols_offs, cols_blob, cap, colspan=colspan,
                force_offset=force_offset, side_offs=side_offs,
                side_blob=side_blob, empty=_EMPTY,
                side_alias_mask=side_alias_mask, side_span=side_span,
                priority=priority,
            )
            if res is not None:
                return res
            cap *= 2
            if cap > (1 << DISP_BITS):
                raise DepthUnsupported("depth table exceeds disp bits")
    if side_alias_mask:
        raise RuntimeError(
            "side_alias_mask layouts require the native library"
        )
    cols_list = [
        cols_blob[cols_offs[i]:cols_offs[i + 1]].astype(np.int64)
        for i in range(n)
    ]
    side_list = None
    if side_blob is not None:
        side_list = [
            side_blob[side_offs[i]:side_offs[i + 1]].astype(np.int64)
            for i in range(n)
        ]
    return _layout_with_growth(
        cols_list, colspan=colspan, force_offset=force_offset,
        side_cols_list=side_list, priority=priority,
    )


def _layout_banks(offsets, csr_offs, cols, div: int = 1) -> int:
    """Post-trim bank count a laid-out table costs the kernel probe.

    Span of occupied slots (divided by ``div`` for packed side words),
    in 128-lane banks.
    """
    cnt = csr_offs[1:] - csr_offs[:-1]
    row = np.repeat(np.arange(len(cnt)), cnt)
    keep = offsets[row] != _EMPTY
    if not keep.any():
        return 0
    slots = (offsets[row][keep] + cols[keep]) // div
    return int(slots.max() // 128 - slots.min() // 128 + 1)


# Kernel grouping threshold (ops.pallas_plan's grouped bank scan and
# the trained DP cost model must agree on which tables group).  8
# (was 16): with the capped unroll keeping probe code small, bounding
# mid-size tables pays off — offline cost sim (bench/costsim.py) puts
# english at 2.55 vs 2.26 GB/s and the 156k dict at 2.0 model-GB/s.
GROUP_MIN_NB = 8

# Minimum size of the FIRST bank group (the one probed
# unconditionally).  2 (was 4): cold steps with hot_nb <= 1 probe two
# banks + one pred instead of four — offline sim worth +4% english,
# flat elsewhere.  ``PHFPFAC_GROUP_FLOOR`` overrides at trace time
# (r5: the lane_probe microbench showed gather triples cost ~4-6
# cycles while ALU ops run ~6/cycle — dropping the floor to 1 trades
# a near-free scalar pred for a whole gather-bank on every deep step
# whose hot span fits one bank; folded into trace_knob_state so AOT
# artifacts can't cross settings).
GROUP_FLOOR = 2


def group_floor() -> int:
    import os

    v = os.environ.get("PHFPFAC_GROUP_FLOOR")
    return int(v) if v else GROUP_FLOOR


def _hot_banks(offsets, csr_offs, cols, w, div: int = 1) -> float:
    """Banks the grouped scan expects to probe for a trained layout:
    the span from the table base to the last slot owned by a
    profile-VISITED row (priority ordering put those rows first)."""
    cnt = csr_offs[1:] - csr_offs[:-1]
    row = np.repeat(np.arange(len(cnt)), cnt)
    placed = offsets[row] != _EMPTY
    if not placed.any():
        return 0.0
    slots = (offsets[row] + cols) // div
    base = slots[placed].min() // 128
    hot = placed & (w[row] > 0)
    if not hot.any():
        return 0.0
    return float(slots[hot].max() // 128 - base + 1)


def _grouped_cost(banks: float, hot: float) -> float:
    """Expected probed banks under the geometric grouped scan: hot
    span rounded up by ~1.5x (group boundaries) plus ~0.6
    bank-equivalents per group check; never worse than the full
    table.  Tables below GROUP_MIN_NB pay full price."""
    if banks < GROUP_MIN_NB:
        return banks
    groups = max(1, int(np.log2(max(banks / 4.0, 1))) + 1)
    return min(banks, 1.5 * hot + 2.0 + 0.6 * groups)


def _to_banks(flat: np.ndarray, fill: int = -1) -> np.ndarray:
    nb = max(1, -(-len(flat) // _LANE))
    out = np.full((nb, _LANE), fill, dtype=np.int32)
    out.ravel()[: len(flat)] = flat
    return out


def _to_banks_trimmed(flat: np.ndarray, fill: int = -1) -> tuple:
    """Bank a table, dropping leading/trailing all-empty banks (the
    ≥0 rebase can strand sparse tables at high slots); returns
    (banks, k0) for _lut's bank-base parameter."""
    banks = _to_banks(flat, fill)
    live = (banks != fill).any(axis=1)
    if not live.any():
        return banks[:1], 0
    k0 = int(np.argmax(live))
    k1 = len(live) - int(np.argmax(live[::-1]))
    return banks[k0:k1], k0


@dataclass
class Levels:
    """Array-form (CSR) level-minimized automaton.

    Per level index li (depth li+1):
      fin[li]      — bool [n_classes] finality of each class
      tr_offs[li]  — int64 [n_classes+1] CSR row offsets
      tr_cols[li]  — int32 [nnz] byte columns, ascending within a row
      tr_child[li] — int32 [nnz] child class index at level li+1
    ``s0_class`` maps depth-1 state -> level-0 class.
    """

    D: int
    fin: list
    tr_offs: list
    tr_cols: list
    tr_child: list
    s0_class: dict
    levels: list = None  # per level: state ids (for corpus profiling)
    inv: list = None  # per level: class of each level-state

    def counts(self, li: int) -> np.ndarray:
        return self.tr_offs[li][1:] - self.tr_offs[li][:-1]

    def n_classes(self, li: int) -> int:
        return len(self.fin[li])

    def class_map(self, li: int, state_num: int) -> np.ndarray:
        """int32 [state_num]: state -> class at level li (-1 outside)."""
        m = np.full(state_num, -1, dtype=np.int32)
        m[self.levels[li]] = self.inv[li]
        return m


def _levels_from_partition(
    dense: np.ndarray,
    levels: list[np.ndarray],
    nf: int,
    inv_by_level: list[np.ndarray],
    rep_by_level: list[np.ndarray],
) -> Levels:
    """Assemble the CSR Levels form from a per-level class partition.

    ``inv_by_level[li][i]`` is the class of levels[li][i];
    ``rep_by_level[li][k]`` indexes the representative of class k into
    levels[li].  Children of level-li states all live at level li+1
    (BFS construction), so child classes resolve through a scatter map
    built from the next level's partition.
    """
    D = len(levels)
    fin_l, offs_l, cols_l, child_l = [], [], [], []
    nxt_map = None  # state -> class at level li+1
    for li in range(D - 1, -1, -1):
        states = levels[li]
        reps = states[rep_by_level[li]]
        rows = dense[reps]  # (n_cls, 256)
        mask = rows >= 0
        cnt = mask.sum(axis=1)
        offs = np.zeros(len(reps) + 1, dtype=np.int64)
        np.cumsum(cnt, out=offs[1:])
        r, c = np.nonzero(mask)
        if li == D - 1:
            child = np.full(len(c), -1, dtype=np.int32)
        else:
            child = nxt_map[rows[r, c]].astype(np.int32)
        fin_l.append(reps < nf)
        offs_l.append(offs)
        cols_l.append(c.astype(np.int32))
        child_l.append(child)
        nxt_map = np.full(dense.shape[0], -1, dtype=np.int32)
        nxt_map[states] = inv_by_level[li]
    fin_l.reverse(); offs_l.reverse(); cols_l.reverse(); child_l.reverse()
    s0_class = {
        int(s): int(k) for s, k in zip(levels[0], inv_by_level[0])
    }
    return Levels(
        D=D, fin=fin_l, tr_offs=offs_l, tr_cols=cols_l, tr_child=child_l,
        s0_class=s0_class, levels=levels, inv=inv_by_level,
    )


def _partition_numpy(dense, levels, nf):
    """np.unique-based per-level partition (portable fallback)."""
    D = len(levels)
    inv_by_level = [None] * D
    rep_by_level = [None] * D
    class_arr = np.full(dense.shape[0], -1, dtype=np.int64)
    for li in range(D - 1, -1, -1):
        states = levels[li]
        rows = dense[states]
        child_cls = np.where(
            rows >= 0, class_arr[np.maximum(rows, 0)], -1
        ).astype(np.int32)
        fin = (states < nf).astype(np.int32)
        sig = np.concatenate([fin[:, None], child_cls], axis=1)
        _uniq, first, inv = np.unique(
            sig, axis=0, return_index=True, return_inverse=True
        )
        class_arr[states] = inv
        inv_by_level[li] = inv.astype(np.int64)
        rep_by_level[li] = first.astype(np.int64)
    return inv_by_level, rep_by_level


def _minimize_levels(
    dense: np.ndarray, levels: list[np.ndarray], nf: int
) -> Levels:
    """Level-wise suffix minimization (leveled DAWG).

    States at the same depth with identical right behavior — same
    finality and transitions leading (recursively) to equivalent
    states — merge into one class.  The device kernel only ever
    observes the per-step final flag along a walk, which equivalence
    preserves exactly; pattern ids are recovered on the host from the
    matched substrings (ops.bitmap), so merging is transparent to
    match extraction.  For natural-language dictionaries this shrinks
    the mid-depth tables severalfold (shared suffixes like "...tion"),
    cutting the banked-LUT probe cost proportionally.

    The hash-partition runs in C++ when available (compile.native);
    the NumPy np.unique(axis=0) path is the portable fallback.  Class
    NUMBERING differs between the two (first-occurrence vs signature-
    lexicographic order) — semantically equivalent partitions; tests
    assert partition equality (tests/test_native.py).
    """
    from phfpfac_tpu_torch.compile import native

    if native.available():
        inv_by_level, rep_by_level = native.minimize_levels_native(
            dense, levels, nf
        )
    else:
        inv_by_level, rep_by_level = _partition_numpy(dense, levels, nf)
    return _levels_from_partition(
        dense, levels, nf, inv_by_level, rep_by_level
    )


def level_visit_counts(
    dense: np.ndarray,
    s0: np.ndarray,
    lv: Levels,
    corpus: bytes | np.ndarray,
    *,
    max_bytes: int = 1 << 20,
    cell_live_out: list | None = None,
    cell_positions: int = 32 * 1024,
) -> list:
    """Per-level class visit counts from walking a profile corpus.

    Walks every corpus position through the dense automaton (one
    vectorized depth at a time) and counts which CLASS each live
    walker occupies at each depth.  The counts drive the
    profile-guided table layout (hot classes get low displacements so
    the kernel's grouped bank scan terminates early); they only
    affect SPEED — results are exact for any input.

    ``cell_live_out`` (optional list) additionally receives, per
    level, the fraction of ``cell_positions``-sized position cells
    with at least one live walker — the empirical (clustering-aware)
    probability that the kernel's cell-level early-exit cond pays for
    a step at that depth.  The step-kind DP prices steps by it.
    """
    arr = (
        np.frombuffer(corpus, dtype=np.uint8)
        if isinstance(corpus, (bytes, bytearray))
        else np.asarray(corpus, dtype=np.uint8)
    )[:max_bytes]
    n = len(arr)
    counts = []
    if n == 0:
        return [np.zeros(lv.n_classes(li), np.int64) for li in range(lv.D)]
    pos = np.arange(n)
    st = np.asarray(s0)[arr].astype(np.int64)
    for li in range(lv.D):
        if li > 0:
            nxt = pos + li
            ch = arr[np.minimum(nxt, n - 1)]
            alive = (st >= 0) & (nxt < n)
            st = np.where(alive, dense[np.maximum(st, 0), ch], -1)
        alive = st >= 0
        if cell_live_out is not None:
            nc = -(-n // cell_positions)
            a = np.zeros(nc * cell_positions, dtype=bool)
            a[:n] = alive
            cell_live_out.append(
                float(a.reshape(nc, cell_positions).any(axis=1).mean())
            )
        if not alive.any():
            counts.append(np.zeros(lv.n_classes(li), np.int64))
            continue
        cmap = lv.class_map(li, dense.shape[0])
        cls = cmap[st[alive]]
        counts.append(
            np.bincount(cls[cls >= 0], minlength=lv.n_classes(li))
            .astype(np.int64)
        )
    return counts


def _identity_levels(dense, levels, nf) -> Levels:
    """One class per level-state (minimize=False)."""
    inv = [np.arange(len(lv), dtype=np.int64) for lv in levels]
    return _levels_from_partition(dense, levels, nf, inv, inv)


def build_depth_tables(
    shard: ShardTables, *, minimize: bool = True, trim: bool = True
) -> DepthTables:
    """Stratify one shard's automaton by depth.

    Raises DepthUnsupported for non-tree automata (charset DFAs) or
    tries deeper than the 32-step bitmap.
    """
    if shard.max_pat_len > MAX_DEPTH_STEPS:
        raise DepthUnsupported("max pattern length exceeds bitmap width")
    nf = shard.final_state_num
    init = nf + 1
    if shard.state_num <= init:
        raise DepthUnsupported("degenerate automaton")
    dense = shard.dense_table()
    dense[init] = shard.s0  # identical by construction; be explicit
    levels = _bfs_levels(dense, init)
    D = len(levels)
    if D == 0:
        raise DepthUnsupported("empty automaton")

    lv = (
        _minimize_levels(dense, levels, nf)
        if minimize
        else _identity_levels(dense, levels, nf)
    )

    # Per-depth layouts for T_d (transitions out of depth-d classes),
    # d = 1..D-1.  Level index d-1 holds the depth-d classes.
    offsets_by_level: list[np.ndarray] = []
    ht_lens: list[int] = []
    for d in range(1, D):
        offsets, ht_len = _layout_csr(lv.tr_offs[d - 1], lv.tr_cols[d - 1])
        if offsets.max(initial=0) >= DISP_MISS:
            raise DepthUnsupported("displacement exceeds disp bits")
        offsets_by_level.append(offsets)
        ht_lens.append(ht_len)

    def disp_map(d: int, cls: np.ndarray) -> np.ndarray:
        """Displacements carried by walkers landing on depth-d classes."""
        if d >= D:
            return np.full(len(cls), DISP_MISS, dtype=np.int64)
        off = offsets_by_level[d - 1][cls]
        return np.where(off != _EMPTY, off, DISP_MISS)

    # Fill the tables (vectorized over the CSR transition arrays).
    tables: list[np.ndarray] = []
    for d in range(1, D):
        offsets = offsets_by_level[d - 1]
        tbl = np.full(ht_lens[d - 1], -1, dtype=np.int32)
        offs = lv.tr_offs[d - 1]
        cols = lv.tr_cols[d - 1].astype(np.int64)
        child = lv.tr_child[d - 1].astype(np.int64)
        row = np.repeat(np.arange(len(offs) - 1), lv.counts(d - 1))
        roff = offsets[row]
        keep = roff != _EMPTY
        dispv = disp_map(d + 1, child)
        fin = lv.fin[d][child].astype(np.int64)
        entry = ((dispv << 9) | (fin << 8) | cols).astype(np.int32)
        tbl[roff[keep] + cols[keep]] = entry[keep]
        tables.append(tbl)

    # s0: (disp into T_1 << 1) | fin, -1 when no depth-1 state.
    s0_flat = np.full(256, -1, dtype=np.int32)
    for c in range(256):
        ns = int(shard.s0[c])
        if ns < 0:
            continue
        cls = lv.s0_class[ns]
        fin = 1 if lv.fin[0][cls] else 0
        s0_flat[c] = (int(disp_map(1, np.array([cls]))[0]) << 1) | fin

    if trim:
        trimmed = [_to_banks_trimmed(t) for t in tables]
    else:  # uniform k0=0 layout (stacked SPMD tables need it)
        trimmed = [(_to_banks(t), 0) for t in tables]
    banked = [b for b, _ in trimmed]
    k0s = tuple(k for _, k in trimmed)
    offs, nbs, acc = [], [], 0
    for b in banked:
        offs.append(acc)
        nbs.append(b.shape[0])
        acc += b.shape[0]
    packed = (
        np.concatenate(banked)
        if banked
        else np.full((1, _LANE), -1, dtype=np.int32)
    )
    return DepthTables(
        s0_banks=_to_banks(s0_flat),
        packed_banks=packed,
        offs=tuple(offs),
        nbs=tuple(nbs),
        k0s=k0s,
        n_steps=D,
        max_pat_len=shard.max_pat_len,
        num_final=nf,
    )
