"""Stride-2 ("pair") depth-stratified PFAC tables.

Builds on compile.depth: the trie is stratified by depth and
level-minimized, then adjacent depth levels are fused so the device
consumes TWO bytes per probe.  Only even-depth states materialize as
table rows — the odd levels exist implicitly inside pair transitions —
which roughly halves both total table size and walk-step count (the
two multiplicative costs of the banked-LUT walk, ops.pallas_scan._lut).

Requires a compact alphabet: the dictionary's distinct bytes map to
codes of CODE_BITS = ceil(log2(sigma+1)) bits, and a pair symbol is
``code1 << CODE_BITS | code2``.  Dictionaries with more than
MAX_SIGMA distinct bytes raise PairUnsupported (callers fall back to
the stride-1 depth kernel).  All non-dictionary bytes (and the
past-input pad) share the reserved miss code, which no stored entry
contains — such probes can never verify.

Per pair step k (covering depths 2k+1 and 2k+2):

* **P_k** — the pair table: rows = depth-2k classes, col = pair
  symbol, FFDM layout with distinct displacements (depth.py).  Entry
  ``(next_disp << (2*CB+1)) | (fin_end << 2*CB) | pair`` — probe
  verification compares the stored pair (sound by displacement
  distinctness), fin_end flags the landed depth-2k+2 class, next_disp
  chains into P_{k+1}.
* **S_k** — the odd-completion side table: records which (row, c1)
  have a FINAL depth-2k+1 child, so matches ending on the odd level
  are emitted even when no pair transition continues the walk.  S_k
  is direct-indexed by ``row_disp + code1`` — it reuses P_k's
  displacement (soundness again from distinctness), so the walker
  carries ONE displacement.  Entries are bytes (code1 + 1; 0 = empty)
  packed 4-per-int32, costing a quarter of a pair-table probe.

Rows that have no pair transitions but DO have final odd children
still get a distinct displacement (force_offset) so S_k can address
them.

The first step fuses depths 1+2 into a dense sigma^2-indexed table
P_0 (entry ``disp << 2 | fin2 << 1 | fin1``, -1 = no depth-1 state),
replacing the s0 row (master_kernel.cu:41).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from phfpfac_tpu_torch.compile.depth import (
    _EMPTY,
    DepthUnsupported,
    Levels,
    MAX_DEPTH_STEPS,
    _bfs_levels,
    _layout_banks,
    _layout_csr,
    _minimize_levels,
    _reconstruct_dense,
    _to_banks,
    _to_banks_trimmed,
)
from phfpfac_tpu_torch.compile.tables import ShardTables

_LANE = 128

MAX_SIGMA = 63  # distinct dictionary bytes; miss code = sigma


class PairUnsupported(DepthUnsupported):
    """Shard cannot use the stride-2 layout (big alphabet, DAG, ...)."""


@dataclass
class PairTables:
    """Banked stride-2 tables for the pair kernel (one shard)."""

    code_of: np.ndarray  # uint8/int32 [256]: byte -> code (miss = sigma)
    code_bits: int  # CB
    p0_banks: np.ndarray  # int32 (2^(2CB)/128, 128) dense depths-1+2 table
    packed_banks: np.ndarray  # int32 (NB, 128): concat P_1..P_K
    side_banks: np.ndarray  # int32 (NS, 128): concat S_1..S_K (4 B/word)
    p_offs: tuple
    p_nbs: tuple
    p_k0s: tuple  # leading trimmed banks per P_k (ops.pallas_scan._lut k0)
    s_offs: tuple
    s_nbs: tuple
    s_k0s: tuple
    n_pair_steps: int  # K+1 = number of pair probes incl the dense P_0
    disp_miss: int  # dead/leaf displacement sentinel (entry-width bound)
    max_pat_len: int
    # per pair step: side entries are 4-bit (code&7)+1 packed 8/word
    # (True) or bytes code+1 packed 4/word (False)
    s_nibbles: tuple = ()


def collect_alphabet(shard: ShardTables, lv: Levels,
                     max_sigma: int = MAX_SIGMA):
    """(code_of int32[256], sigma, cb): compact the dictionary bytes.

    Unused bytes (and the staging pad) map to the reserved miss code
    ``sigma``, which no stored entry contains."""
    used = np.zeros(256, dtype=bool)
    used[np.flatnonzero(np.asarray(shard.s0) >= 0)] = True
    for li in range(lv.D):
        used[lv.tr_cols[li]] = True
    sigma = int(used.sum())
    if sigma > max_sigma:
        raise PairUnsupported(f"alphabet too large ({sigma} > {max_sigma})")
    cb = max(sigma.bit_length(), 1)
    # Keep the miss code strictly below the code-field mask: a missed
    # banked probe returns -1 whose sym field is all-ones, so with
    # sigma < 2^cb - 1 the kernels can verify with a single masked
    # compare (no separate g >= 0 check).
    if sigma == (1 << cb) - 1:
        cb += 1
    code_of = np.full(256, sigma, dtype=np.int32)
    code_of[np.flatnonzero(used)] = np.arange(sigma, dtype=np.int32)
    return code_of, sigma, cb


def build_dense_p0(
    shard: ShardTables, lv: Levels, code_of, cb: int, landing_fn, miss: int,
) -> np.ndarray:
    """Dense depths-1+2 table: entry (disp << 2) | (fin2 << 1) | fin1,
    indexed by pair symbol (code2 << cb) | code1; -1 = no depth-1
    state.  ``landing_fn(cls)`` supplies the displacement stored for a
    depth-2 landing; fin1-only rows backfill EVERY second code
    (including the miss code) because a depth-1 match exists whatever
    follows it."""
    D = lv.D
    p0 = np.full(1 << (2 * cb), -1, dtype=np.int32)
    for c1 in range(256):
        u = int(shard.s0[c1])
        if u < 0:
            continue
        a = int(code_of[c1])
        u_cls = lv.s0_class[u]
        fin1 = 1 if lv.fin[0][u_cls] else 0
        seen_b = set()
        if D >= 2:
            lo, hi = lv.tr_offs[0][u_cls], lv.tr_offs[0][u_cls + 1]
            for j in range(lo, hi):
                c2 = int(lv.tr_cols[0][j])
                v_cls = int(lv.tr_child[0][j])
                bcode = int(code_of[c2])
                seen_b.add(bcode)
                fin2 = 1 if lv.fin[1][v_cls] else 0
                p0[(bcode << cb) | a] = (
                    (landing_fn(v_cls) << 2) | (fin2 << 1) | fin1
                )
        if fin1:
            for bcode in range(1 << cb):
                if bcode not in seen_b:
                    p0[(bcode << cb) | a] = (miss << 2) | fin1
    return p0


def _pair_join(lv: Levels, li: int, code_of: np.ndarray, cb: int):
    """CSR pair transitions + side entries for rows = level-li classes.

    Fuses level li's transitions (rows -> mid classes, one byte) with
    level li+1's (mid -> end, second byte).  Returns
      (p_offs, pair int64[nnz], end int32[nnz],   # sorted per row
       s_offs, side int64[snnz])                  # final odd children
    Pair symbol = (code2 << cb) | code1 so a row's columns spread
    across the whole span instead of clustering in one 2^cb block per
    mid child, which packs far tighter under the distinct-offset
    first-fit.
    """
    n_rows = lv.n_classes(li)
    cnt1 = lv.counts(li)
    cols1 = lv.tr_cols[li].astype(np.int64)
    mid = lv.tr_child[li].astype(np.int64)
    a = code_of[cols1].astype(np.int64)
    row1 = np.repeat(np.arange(n_rows, dtype=np.int64), cnt1)

    # side: first-step codes whose mid (depth 2k+1) class is final
    fin_mid = lv.fin[li + 1][mid]
    s_rows, s_codes = row1[fin_mid], a[fin_mid]
    o = np.lexsort((s_codes, s_rows))
    s_rows, s_codes = s_rows[o], s_codes[o]
    s_offs = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(s_rows, minlength=n_rows), out=s_offs[1:])

    if li + 2 <= lv.D - 1:
        offs2 = lv.tr_offs[li + 1]
        cols2 = lv.tr_cols[li + 1].astype(np.int64)
        end2 = lv.tr_child[li + 1]
        cnt2 = (offs2[mid + 1] - offs2[mid]).astype(np.int64)
        total = int(cnt2.sum())
        rep_j = np.repeat(np.arange(len(mid), dtype=np.int64), cnt2)
        run_starts = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(cnt2)[:-1]]
        )
        within = np.arange(total, dtype=np.int64) - run_starts[rep_j]
        sel2 = offs2[mid][rep_j] + within
        pair = (code_of[cols2[sel2]].astype(np.int64) << cb) | a[rep_j]
        end = end2[sel2]
        prow = row1[rep_j]
        o = np.lexsort((pair, prow))
        prow, pair, end = prow[o], pair[o], end[o]
        p_offs = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(prow, minlength=n_rows), out=p_offs[1:])
    else:
        p_offs = np.zeros(n_rows + 1, dtype=np.int64)
        pair = np.empty(0, dtype=np.int64)
        end = np.empty(0, dtype=np.int32)
    return p_offs, pair, end, s_offs, s_codes


def _layout_pair_step(p_offs, pair, s_offs, side, pair_span, mono_span,
                      priority=None, force_nibble=None):
    """Lay out one pair step, choosing the side-table packing.

    Tries the byte layout (full-code verify) and, when the native
    layout is available, the 4-bit layout (mod-8 verify + anti-alias
    constraints); keeps whichever costs the kernel fewer probe banks —
    TOTAL banks untrained, expected GROUPED banks when a priority
    profile is given (the kernel scans trained tables in groups, so
    the hot span is what matters).  The nibble constraints shrink the
    side table ~2x but can fragment the MAIN table on row-heavy steps
    — measured per step, not assumed.

    Returns (offsets, ht_len, side_nibble, main_banks, side_banks).
    """
    from phfpfac_tpu_torch.compile import native
    from phfpfac_tpu_torch.compile.depth import _grouped_cost, _hot_banks

    force = (s_offs[1:] - s_offs[:-1]) > 0
    modes = [(False, 0, 4)]
    if native.available():
        modes.append((True, 7, 8))
    if force_nibble is not None:
        # stacked multi-shard plans need ONE packing per step across
        # shards (it is a kernel static); the lead shard's choice wins
        modes = [m for m in modes if m[0] == force_nibble] or modes[:1]
    best = best_score = None
    for nib, mask, per in modes:
        offsets, ht_len = _layout_csr(
            p_offs, pair, colspan=pair_span, force_offset=force,
            side_offs=s_offs, side_blob=side,
            side_alias_mask=mask, side_span=mono_span, priority=priority,
        )
        mb = _layout_banks(offsets, p_offs, pair)
        sb = _layout_banks(offsets, s_offs, side, div=per)
        if priority is not None:
            score = _grouped_cost(
                mb, _hot_banks(offsets, p_offs, pair, priority)
            ) + _grouped_cost(
                sb, _hot_banks(offsets, s_offs, side, priority, div=per)
            )
        else:
            score = mb + sb
        if best is None or score < best_score:
            best = (offsets, ht_len, nib, mb, sb)
            best_score = score
    return best


def _fill_pair_table(
    ht_len: int, offsets, p_offs, pair, end, s_offs, side, *,
    disp_next, fin_end, vshift: int, fin_shift: int, mono_span: int,
    side_nibble: bool = False,
):
    """(ptbl int32, side int32) for one pair step.

    ``disp_next[j]``/``fin_end[j]`` are per-transition landing
    displacement and finality; rows with _EMPTY offsets hold no
    transitions by construction.  Side packing: bytes ``code+1``
    (4/word) by default, or nibbles ``(code & 7) + 1`` (8/word) when
    the layout ran with the anti-aliasing constraints that make the
    truncated verify sound (side_nibble).
    """
    n_rows = len(p_offs) - 1
    ptbl = np.full(ht_len, -1, dtype=np.int32)
    row = np.repeat(
        np.arange(n_rows, dtype=np.int64), p_offs[1:] - p_offs[:-1]
    )
    roff = offsets[row]
    keep = roff != _EMPTY
    entry = (
        (disp_next << vshift) | (fin_end.astype(np.int64) << fin_shift) | pair
    ).astype(np.int32)
    ptbl[roff[keep] + pair[keep]] = entry[keep]

    svals = np.zeros(ht_len + mono_span, dtype=np.uint32)
    srow = np.repeat(
        np.arange(n_rows, dtype=np.int64), s_offs[1:] - s_offs[:-1]
    )
    sroff = offsets[srow]
    skeep = sroff != _EMPTY
    if side_nibble:
        svals[sroff[skeep] + side[skeep]] = (side[skeep] & 7) + 1
        per, bits = 8, 4
    else:
        svals[sroff[skeep] + side[skeep]] = side[skeep] + 1
        per, bits = 4, 8
    pad = (-len(svals)) % per
    sv = np.concatenate([svals, np.zeros(pad, np.uint32)]).reshape(-1, per)
    word = np.zeros(len(sv), dtype=np.uint32)
    for j in range(per):
        word |= sv[:, j] << np.uint32(bits * j)
    return ptbl, word.view(np.int32)


def build_pair_tables(shard: ShardTables, *, minimize: bool = True) -> PairTables:
    if shard.max_pat_len > MAX_DEPTH_STEPS:
        raise PairUnsupported("max pattern length exceeds bitmap width")
    nf = shard.final_state_num
    init = nf + 1
    if shard.state_num <= init:
        raise PairUnsupported("degenerate automaton")
    dense = shard.dense_table()
    dense[init] = shard.s0  # identical by construction; be explicit
    levels = _bfs_levels(dense, init)
    D = len(levels)
    if D == 0:
        raise PairUnsupported("empty automaton")
    if not minimize:
        raise PairUnsupported("pair tables require class minimization")
    lv = _minimize_levels(dense, levels, nf)

    # ---- alphabet coding -------------------------------------------------
    code_of, sigma, cb = collect_alphabet(shard, lv)
    pair_span = 1 << (2 * cb)
    mono_span = 1 << cb

    # ---- per-even-level pair transitions + side entries ------------------
    # pair step k >= 1 walks from depth 2k classes.  K = number of
    # non-dense pair tables; step k covers depths 2k+1 (side) / 2k+2.
    K = (D - 1) // 2  # deepest start level with anything to cover: 2K < D
    val_shift = 2 * cb + 1
    # the miss sentinel must survive << val_shift inside an int32 entry
    pair_miss = (1 << (31 - val_shift)) - 1
    joins = [_pair_join(lv, 2 * k - 1, code_of, cb) for k in range(1, K + 1)]

    # ---- layouts (deep -> shallow so next-step disps are known) ----------
    offsets_k: list[np.ndarray] = [None] * (K + 1)  # 1-based
    ht_lens: list[int] = [0] * (K + 1)
    nibbles: list[bool] = [False] * (K + 1)
    for k in range(1, K + 1):
        p_offs, pair, _end, s_offs, side = joins[k - 1]
        offsets, ht_len, nib, _mb, _sb = _layout_pair_step(
            p_offs, pair, s_offs, side, pair_span, mono_span
        )
        offsets_k[k] = offsets
        ht_lens[k] = ht_len
        nibbles[k] = nib

    def disp_arr(cls: np.ndarray, k: int) -> np.ndarray:
        """Displacements carried by walkers landing on depth-2k classes."""
        if k > K:
            return np.full(len(cls), pair_miss, dtype=np.int64)
        off = offsets_k[k][cls]
        return np.where(off != _EMPTY, off, pair_miss)

    max_disp = pair_miss - 1

    # ---- fill pair + side tables -----------------------------------------
    p_tables, s_tables = [], []
    for k in range(1, K + 1):
        offsets = offsets_k[k]
        if offsets.max(initial=0) > max_disp:
            raise PairUnsupported("displacement exceeds entry bits")
        p_offs, pair, end, s_offs, side = joins[k - 1]
        li = 2 * k - 1
        fin_end = (
            lv.fin[li + 2][end]
            if li + 2 <= D - 1
            else np.zeros(len(end), dtype=bool)
        )
        ptbl, stbl = _fill_pair_table(
            ht_lens[k], offsets, p_offs, pair, end, s_offs, side,
            disp_next=disp_arr(end.astype(np.int64), k + 1),
            fin_end=fin_end, vshift=val_shift, fin_shift=2 * cb,
            mono_span=mono_span, side_nibble=nibbles[k],
        )
        p_tables.append(ptbl)
        s_tables.append(stbl)

    # ---- dense P_0 (depths 1 + 2) ----------------------------------------
    p0 = build_dense_p0(
        shard, lv, code_of, cb,
        landing_fn=lambda cls: int(disp_arr(np.array([cls]), 1)[0]),
        miss=pair_miss,
    )

    trimmed_p = [_to_banks_trimmed(t) for t in p_tables]
    trimmed_s = [_to_banks_trimmed(t, fill=0) for t in s_tables]
    banked_p = [b for b, _ in trimmed_p]
    banked_s = [b for b, _ in trimmed_s]
    p_k0s = tuple(k for _, k in trimmed_p)
    s_k0s = tuple(k for _, k in trimmed_s)
    p_offs, p_nbs, acc = [], [], 0
    for b in banked_p:
        p_offs.append(acc)
        p_nbs.append(b.shape[0])
        acc += b.shape[0]
    s_offs, s_nbs, acc = [], [], 0
    for b in banked_s:
        s_offs.append(acc)
        s_nbs.append(b.shape[0])
        acc += b.shape[0]
    return PairTables(
        code_of=code_of,
        code_bits=cb,
        p0_banks=_to_banks(p0),
        packed_banks=(
            np.concatenate(banked_p)
            if banked_p
            else np.full((1, _LANE), -1, np.int32)
        ),
        side_banks=(
            np.concatenate(banked_s)
            if banked_s
            else np.zeros((1, _LANE), np.int32)
        ),
        p_offs=tuple(p_offs),
        p_nbs=tuple(p_nbs),
        p_k0s=p_k0s,
        s_offs=tuple(s_offs),
        s_nbs=tuple(s_nbs),
        s_k0s=s_k0s,
        n_pair_steps=K + 1,
        disp_miss=pair_miss,
        max_pat_len=shard.max_pat_len,
        s_nibbles=tuple(nibbles[1:]),
    )
