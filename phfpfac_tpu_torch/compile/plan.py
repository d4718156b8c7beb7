"""Cost-planned hybrid-stride PFAC tables (the fastest layout).

compile.depth strides one byte per probe; compile.pair strides two.
Neither is uniformly best: fusing two trie levels into pair symbols
eliminates the odd level's table rows BUT duplicates any suffix
sharing that passed through them (a merged odd class reached from k
parents contributes its transitions k times), so at suffix-heavy
depths two stride-1 probes can touch fewer table banks than one
stride-2 probe — while at sparse deep levels the pair step's halved
fixed cost wins.  Measured on the English dictionary: stride-1 wins
depths 3-4, pairs win from ~5 on.

This module chooses per depth with a tiny dynamic program over
estimated probe costs (banks ~ entries/utilization; fixed vector-op
cost per step kind) and emits a STATIC step plan:

    step 0:      dense sigma^2 table over depths 1+2 (always)
    step i>0:    "mono"  — one byte,  table M_d  (rows = depth-d
                 classes, col = byte code), or
                 "pair"  — two bytes, table P_d + odd-completion side
                 table S_d (compile.pair's scheme)

All tables chain displacements (the value stored for a transition is
the landing class's displacement in the NEXT step's table, whatever
kind that is) and verify probes by the stored symbol, sound under the
distinct-displacement layout (compile.depth._layout_distinct).

Entry layouts (int32):
    mono:  (next_disp << (CB+1))   | (fin << CB)   | code
    pair:  (next_disp << (2CB+1))  | (fin << 2CB)  | pair
    P0:    (next_disp << 2) | (fin2 << 1) | fin1      (dense; no verify)

Dead walkers carry displacement 0 (the DEAD-ZONE scheme): every
table's real rows are shifted up by its colspan, so a probe with a
dead displacement (0 + sym < span) lands strictly below the first
k0-trimmed bank — it can never verify, never indexes a real bank,
and stays below every grouped-scan boundary, which lets the kernel
bound its bank scans with a plain unmasked max over raw indices.
The value-FIELD capacity (31 minus the NARROWEST vshift among the
kinds used) still bounds stored displacements, priced by the same
ht_len + colspan <= cap formula in the DP.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from phfpfac_tpu_torch.compile.depth import (
    _EMPTY,
    DepthUnsupported,
    MAX_DEPTH_STEPS,
    _bfs_levels,
    _layout_csr,
    _minimize_levels,
    _reconstruct_dense,
    _to_banks,
    _to_banks_trimmed,
)
from phfpfac_tpu_torch.compile.pair import (
    PairUnsupported,
    _fill_pair_table,
    _layout_pair_step,
    _pair_join,
    build_dense_p0,
    collect_alphabet,
)
from phfpfac_tpu_torch.compile.tables import ShardTables

_LANE = 128

# Step fixed-cost estimate in vector ops (DP weight).  Calibrated on
# v5e by A/B of forced plans (english 32 MiB): all-pair (154 banks, 9
# steps) 1.14 GB/s vs all-mono (144 banks, 18 steps) 0.84 GB/s fits
# an EFFECTIVE ~45 vops/step — far below a naive estimate because the
# cell-level early exit skips most deep steps.  Any F in [25, 80]
# yields the same (measured-best) english plan; 60 is the midpoint.
# Lower F also correctly biases bank-heavy dictionaries (the 160k-
# title dict) toward mono, matching measurement (mixed-pair plan
# 0.202 GB/s vs all-mono 0.212 / depth kernel 0.214).
# ROUND-4 RECALIBRATION against the one-pred kernel's measured step
# costs (bench/stepcurve.py + the costsim replay, in the DP's
# 4-per-bank units): mono fixed ~19 vops -> 25; pair fixed -> 55,
# ~2.2x mono, because the measured pair step (44 cycles/tile on the
# english stepcurve vs the ~40-vop model at a 1.5 vops/cycle mix
# rate) dual-issues worse — its side-probe verify chain serializes.
# The old 60/60 (fix/bank ratio 15 vs measured 6-8) over-rewarded
# step-halving pairs whose bank mass the conds never repay — worst
# case big156's 122-vop pair@d12 over a dead d13 (r4 ledger,
# PERF.md).  Hardware A/B of the resulting mono-first plans:
# big156 10.6 -> 8.69 ms (+22%), english 8.50 -> 7.48 ms (+14%)
# (bench/r4_results.log).  Combined with exec-fraction pricing below.
_FIX_MONO = 25.0
_FIX_PAIR = 55.0


@dataclass(frozen=True)
class StepSpec:
    """Static geometry of one walk step (hashable: jit static arg)."""

    kind: str  # "mono" | "pair"
    depth0: int  # first depth this step covers (1-based)
    off: int  # main-table bank offset
    nb: int
    k0: int
    s_off: int  # side table (pair only; zeros for mono)
    s_nb: int
    s_k0: int
    s_nibble: bool  # side entries 4-bit (code&7)+1 8/word, else bytes
    miss: int  # dead displacement (0 under the dead-zone scheme)
    # SPLIT step (the s0x prologue's depth-2 table): the row index
    # absorbed the symbol's high bits, so only ``col_bits`` low bits
    # are verified in-entry (entry = nv << col_bits+2 | fin <<
    # col_bits+1 | sym&mask, one spare bit keeping the -1 miss
    # unaliasable).  0 = normal step (full-cb symbol field).
    col_bits: int = 0
    # trained-profile hot-bank spans (0 = untrained): the kernel sizes
    # its FIRST bank group to cover the hot working set, so the common
    # case probes one group + one pred instead of walking geometric
    # boundaries up from 4 banks
    hot_nb: int = 0
    s_hot_nb: int = 0


@dataclass
class PlanTables:
    """Banked hybrid-stride tables for ops.pallas_plan (one shard)."""

    code_of: np.ndarray  # int32 [256] byte -> code (miss = sigma)
    code_bits: int
    p0_mode: str  # "dense" (sigma^2 depths-1+2 table) | "s0" (depth 1)
    p0_banks: np.ndarray  # dense P0 or the code-indexed s0 table
    packed_banks: np.ndarray  # concat of all main tables
    side_banks: np.ndarray  # concat of all pair side tables
    steps: tuple  # tuple[StepSpec], probe order after the prologue
    p0_miss: int  # dead sentinel (plan-wide)
    max_pat_len: int
    trained: bool = False  # profile-guided layout (grouped-scan ready)
    kinds: tuple = ()  # the chosen (kind, depth) list (stacking reuses it)
    # per-step live-walker fraction on the profile corpus (empty when
    # untrained): drives the auto cond_from choice — steps where
    # essentially no walker survives should sit behind the early-exit
    # cond (die-fast binary traffic wants cond_from=2, english text 4)
    live_frac: tuple = ()


# ---- serialization (table-format v3 payload) ----------------------------
# The reference bakes its tables once and reuses them every run
# (create_PFAC_table_reorder + nvcc-compiled kernel); saving the built
# plan alongside the compiled dictionary gives a fresh process the
# same property — start-to-first-byte skips the trie + plan build.

def plan_tables_arrays(pt: PlanTables, prefix: str) -> tuple[dict, dict]:
    """(arrays, meta) for embedding one shard's plan in an .npz."""
    arrays = {
        f"{prefix}code_of": pt.code_of,
        f"{prefix}p0_banks": pt.p0_banks,
        f"{prefix}packed_banks": pt.packed_banks,
        f"{prefix}side_banks": pt.side_banks,
    }
    meta = {
        "code_bits": pt.code_bits,
        "p0_mode": pt.p0_mode,
        "p0_miss": pt.p0_miss,
        "max_pat_len": pt.max_pat_len,
        "trained": pt.trained,
        "steps": [vars(s).copy() for s in pt.steps],
        "kinds": [list(k) for k in pt.kinds],
        "live_frac": list(pt.live_frac),
    }
    return arrays, meta


def plan_tables_from(z, prefix: str, meta: dict) -> PlanTables:
    """Rebuild a PlanTables from ``plan_tables_arrays`` output."""
    return PlanTables(
        code_of=z[f"{prefix}code_of"],
        code_bits=int(meta["code_bits"]),
        p0_mode=meta["p0_mode"],
        p0_banks=z[f"{prefix}p0_banks"],
        packed_banks=z[f"{prefix}packed_banks"],
        side_banks=z[f"{prefix}side_banks"],
        steps=tuple(StepSpec(**s) for s in meta["steps"]),
        p0_miss=int(meta["p0_miss"]),
        max_pat_len=int(meta["max_pat_len"]),
        trained=bool(meta["trained"]),
        kinds=tuple(tuple(k) for k in meta["kinds"]),
        live_frac=tuple(meta["live_frac"]),
    )


def build_plan_tables(
    shard: ShardTables, *, minimize: bool = True,
    train: bytes | np.ndarray | None = None,
    code: tuple | None = None,
    forced_kinds: tuple | None = None,
    trim: bool = True,
) -> PlanTables:
    """Build the hybrid-stride plan tables.

    ``train`` (optional profile corpus, e.g. the first MiB of the
    input) enables the PROFILE-GUIDED layout: per-level class visit
    counts order the distinct-offset first-fit so hot classes get low
    displacements, and the kernel switches to a grouped bank scan
    that stops as soon as every live walker's probe bank has been
    covered.  Exact for ANY scanned input — the profile only shapes
    speed (a mismatched profile degrades toward the untrained cost
    plus a few group checks).

    ``code``/``forced_kinds``/``trim`` serve the STACKED multi-shard
    build (build_stacked_plan_tables): a shared (code_of, sigma, cb)
    coding, an imposed (kind, depth) step list (depths past this
    shard's automaton produce all-miss EMPTY steps so every shard gets
    the same static program), and k0-trim disabled so bank offsets
    stay uniform across shards.
    """
    if shard.max_pat_len > MAX_DEPTH_STEPS:
        raise PairUnsupported("max pattern length exceeds bitmap width")
    nf = shard.final_state_num
    init = nf + 1
    if shard.state_num <= init:
        raise PairUnsupported("degenerate automaton")
    if not minimize:
        raise PairUnsupported("plan tables require class minimization")
    dense = shard.dense_table()
    dense[init] = shard.s0  # identical by construction; be explicit
    levels = _bfs_levels(dense, init)
    D = len(levels)
    if D == 0:
        raise PairUnsupported("empty automaton")
    lv = _minimize_levels(dense, levels, nf)

    weights = None
    train_len = 0
    cell_live: list = []
    if train is not None:
        from phfpfac_tpu_torch.compile.depth import level_visit_counts

        train_len = len(train)
        weights = level_visit_counts(
            dense, shard.s0, lv, train, cell_live_out=cell_live
        )
        if not any(int(w.sum()) for w in weights):
            # degenerate profile (empty / unrepresentative corpus):
            # trained tables would pay grouped-scan checks with no
            # hot-row front-loading — stay untrained
            weights = None
            cell_live = []

    # ---- alphabet coding --------------------------------------------------
    # beyond cb=6 the dense sigma^2 depths-1+2 table would cost 128
    # banks per position; a code-indexed s0 prologue replaces it.  Full
    # binary alphabets (sigma up to 256 — ClamAV-style byte signatures,
    # the reference kernel's native regime, master_kernel.cu:52-54) are
    # supported with MONO-ONLY steps: pair fusion needs
    # ht_len + 2^2cb below the pair-width sentinel, impossible past
    # cb=7, so those candidates are not even laid out.
    if code is None:
        code_of, _sigma, cb = collect_alphabet(shard, lv, max_sigma=256)
    else:
        code_of, _sigma, cb = code
    pair_span = 1 << (2 * cb)
    mono_span = 1 << cb
    # provisional prologue mode: the dense sigma^2 depths-1+2 table
    # when it fits.  After the depth-1 mono candidate is laid out the
    # choice is PRICED like any other step (see below): a trained
    # layout's bounded depth-2 scan usually probes far fewer banks
    # than the dense table, which every position scans in full.
    p0_mode = "dense" if pair_span <= 4096 else "s0"
    if forced_kinds is not None and len(forced_kinds) > 0:
        # stacked builds: the lead shard's prologue choice is implied
        # by its kind list (first step at depth 1 = s0 prologue)
        p0_mode = "s0" if forced_kinds[0][1] == 1 else "dense"
    pair_feasible = cb <= 7

    # ---- exact-cost DP over step kinds ------------------------------------
    # With the native layout, BOTH candidates are laid out at every
    # depth and the DP prices the ACTUAL post-trim bank counts the
    # kernel will probe (4 vops/bank, _lut); the layouts are cached
    # and reused by the fill.  On the NumPy fallback path laying out
    # twice per depth would dominate compile time, so the DP prices
    # utilization ESTIMATES there and only the chosen steps are laid
    # out afterwards (_materialize).
    from phfpfac_tpu_torch.compile import native
    from phfpfac_tpu_torch.compile.depth import (
        _grouped_cost,
        _hot_banks,
        _layout_banks,
    )

    def _prio(w):
        """Coarse log2 visit buckets for the first-fit placement order.

        Raw visit counts are almost always pairwise distinct, so a raw
        priority orders near-equal-hot rows by profile NOISE and
        destroys the size-descending packing the first-fit relies on
        (measured: the sigma=256 signature dictionary's flat-profile
        depth-2 table packed at 48% — 80 banks — vs 92% for its
        skewed depth-3 neighbor).  log2 buckets keep hot-first order
        where the profile has real skew and tie near-equal rows so
        the native layout's size-descending tiebreak packs tightly."""
        if w is None:
            return None
        return np.floor(np.log2(w.astype(np.float64) + 1)).astype(np.int64)

    exact = native.available()
    mono_cand: dict = {}  # d -> dict(offsets, ht_len, cols, banks)
    pair_cand: dict = {}  # d -> dict(offsets, ht_len, join, nib, banks)
    # candidates from depth 1 regardless of the provisional prologue
    # mode — the d=1 mono layout prices the s0-chain alternative
    d_lo = 1
    need_mono = need_pair = None
    forced_nib = {}
    if forced_kinds is not None:
        fk = [(e[0], e[1]) for e in forced_kinds]
        forced_nib = {
            e[1]: e[2] for e in forced_kinds
            if len(e) > 2 and e[0] == "pair"
        }
        forced_kinds = fk
        need_mono = {d for k, d in forced_kinds if k == "mono"}
        need_pair = {d for k, d in forced_kinds if k == "pair"}
    for d in range(d_lo, D):
        if need_mono is not None and d not in need_mono \
                and d not in need_pair:
            continue
        li = d - 1
        w = weights[li] if weights is not None else None
        cols = code_of[lv.tr_cols[li]].astype(np.int64)
        want_mono = need_mono is None or d in need_mono
        if want_mono:
            mono_cand[d] = dict(cols=cols, w=w)
        if want_mono and exact:
            offsets, ht_len = _layout_csr(
                lv.tr_offs[li], cols, colspan=mono_span,
                priority=_prio(w)
            )
            banks = _layout_banks(offsets, lv.tr_offs[li], cols)
            cost_b = banks
            hot_m = 0
            if w is not None:
                hot = _hot_banks(offsets, lv.tr_offs[li], cols, w)
                cost_b = _grouped_cost(banks, hot)
                hot_m = int(np.ceil(hot))
            mono_cand[d].update(
                offsets=offsets, ht_len=ht_len, banks=cost_b, hot=hot_m,
            )
        elif want_mono:
            est_len = int(len(cols) / 0.8) + 1
            mono_cand[d].update(ht_len=est_len, banks=est_len / 128.0)
        if pair_feasible and li + 1 <= D - 1 and (
            need_pair is None or d in need_pair
        ):
            # a pair step needs an odd level to fuse
            join = _pair_join(lv, li, code_of, cb)
            p_offs, pair, _end, s_offs, side = join
            pair_cand[d] = dict(join=join, w=w)
            if exact:
                offsets, ht_len, nib, mb, sb = _layout_pair_step(
                    p_offs, pair, s_offs, side, pair_span, mono_span,
                    priority=_prio(w), force_nibble=forced_nib.get(d),
                )
                hot_m = hot_s = 0
                if w is not None:
                    per = 8 if nib else 4
                    hm = _hot_banks(offsets, p_offs, pair, w)
                    hs = _hot_banks(offsets, s_offs, side, w, div=per)
                    cost_b = _grouped_cost(mb, hm) + _grouped_cost(sb, hs)
                    hot_m, hot_s = int(np.ceil(hm)), int(np.ceil(hs))
                else:
                    cost_b = mb + sb
                pair_cand[d].update(
                    offsets=offsets, ht_len=ht_len, nib=nib, banks=cost_b,
                    hot=hot_m, hot_s=hot_s,
                )
            else:
                est_len = int(len(pair) / 0.5) + 1
                pair_cand[d].update(
                    ht_len=est_len, nib=False,
                    banks=(est_len + est_len / 4.0) / 128.0,
                )

    def _materialize(kind: str, d: int) -> None:
        """Lay out a DP-chosen candidate that was only estimated."""
        c = mono_cand[d] if kind == "mono" else pair_cand[d]
        if "offsets" in c:
            return
        if kind == "mono":
            offsets, ht_len = _layout_csr(
                lv.tr_offs[d - 1], c["cols"], colspan=mono_span,
                priority=_prio(c["w"]),
            )
            c.update(offsets=offsets, ht_len=ht_len)
        else:
            p_offs, pair, _end, s_offs, side = c["join"]
            offsets, ht_len, nib, _mb, _sb = _layout_pair_step(
                p_offs, pair, s_offs, side, pair_span, mono_span,
                priority=_prio(c["w"]), force_nibble=forced_nib.get(d),
            )
            c.update(offsets=offsets, ht_len=ht_len, nib=nib)

    # The value FIELD is 31 minus the narrowest vshift among the
    # kinds USED, so its capacity depends on whether any pair step is
    # chosen — and every table's shifted displacements (offset + span)
    # must fit it.  Run the DP under both scenarios and keep the
    # cheaper feasible plan; large-alphabet dictionaries whose tables
    # overflow the narrow pair-width field legitimately go all-mono.
    INF = float("inf")
    miss_pair_w = (1 << (31 - (2 * cb + 1))) - 1
    miss_mono_w = (1 << (31 - (cb + 1))) - 1

    def _exec_frac(d: int) -> float:
        """Trained cell-live probability entering depth ``d`` — the
        empirical (clustering-aware) chance that a 32k-walker cell
        still holds a live walker, i.e. that the kernel's cell-level
        early-exit cond EXECUTES a step at this depth.  Round-4
        finding (bench/r4_results.log): the unweighted DP placed a
        122-vop pair step at big156's d12 where every cell is dead one
        depth later — pricing steps by measured cell liveness is what
        the kernel actually pays.  Floored so fixed-cost ranking
        survives at fully-dead depths (there the choice is nearly
        free either way)."""
        if not cell_live or d < 2:
            return 1.0
        i = min(d - 2, len(cell_live) - 1)
        return max(cell_live[i], 0.05)

    def run_dp(use_pair: bool):
        miss_w = miss_pair_w if use_pair else miss_mono_w
        cost = [0.0] * (D + 2)
        choice = [None] * (D + 1)
        for d in range(D - 1, d_lo - 1, -1):
            m = p = INF
            ex = _exec_frac(d)
            mc = mono_cand[d]
            if mc["ht_len"] + mono_span <= miss_w and cost[d + 1] < INF:
                m = ex * (4.0 * mc["banks"] + _FIX_MONO) + cost[d + 1]
            if use_pair and d in pair_cand:
                pc = pair_cand[d]
                if (pc["ht_len"] + pair_span <= miss_w
                        and cost[d + 2] < INF):
                    p = ex * (4.0 * pc["banks"] + _FIX_PAIR) + cost[d + 2]
            if p <= m:
                cost[d], choice[d] = p, "pair"
            else:
                cost[d], choice[d] = m, "mono"
        if cost[d_lo] >= INF:
            return None
        kinds = []
        d = d_lo
        while d < D:
            k = choice[d] or "mono"
            kinds.append((k, d))
            d += 2 if k == "pair" else 1
        return cost[d_lo], kinds

    if forced_kinds is not None:
        plan_kinds = list(forced_kinds)
    else:
        # price the prologue: dense sigma^2 table (every position
        # scans all its banks, no verify) vs s0 probe + a normal
        # depth-1 step (1 bank + the step's grouped-aware bank cost +
        # its fixed cost).  Trained layouts usually make the chain far
        # cheaper; exactness is identical.
        if p0_mode == "dense" and 1 in mono_cand and D > 1:
            cost_dense = 4.0 * ((pair_span + _LANE - 1) // _LANE)
            cost_s0 = 4.0 * (1 + mono_cand[1]["banks"]) + _FIX_MONO
            if 1 in pair_cand:
                cost_s0 = min(
                    cost_s0,
                    4.0 * (1 + pair_cand[1]["banks"]) + _FIX_PAIR,
                )
            if cost_s0 < cost_dense:
                p0_mode = "s0"
        d_lo = 2 if p0_mode == "dense" else 1
        best = None
        for use_pair in (True, False):
            res = run_dp(use_pair)
            if res and (best is None or res[0] < best[0]):
                best = res
        if best is None:
            raise PairUnsupported("tables too large for the value field")
        plan_kinds = best[1]

    # ---- s0x split prologue (wide alphabets) ------------------------------
    # For sigma > 64 the depth-2 table's rows are FEW (depth-1 classes,
    # <= sigma) but WIDE (colspan = mono_span), and wide uniform rows
    # pin first-fit utilization near 50% (PERF.md round-3 item 7: the
    # last rows placed need (1-f)^k * ht ~ 1).  Splitting each row into
    # mono_span/64 sub-rows of span 64 multiplies the row count and
    # drops k per row, packing near-100% — the binary-signature d2
    # table measures 75 -> 39 banks.  The prologue then indexes
    # offsets by (code1, code2 >> 6) directly — a two-byte-addressed
    # s0 ("s0x") — and the d2 step verifies only the 6 low symbol
    # bits (StepSpec.col_bits).  Adopted only when the priced probe
    # cost (bigger prologue + smaller d2 scan) wins; stacked/forced
    # builds keep plain s0 (shard-uniform statics).
    split0 = None
    if (forced_kinds is None and p0_mode == "s0"
            and plan_kinds and plan_kinds[0] == ("mono", 1)
            and cb > 6 and exact
            and os.environ.get("PHFPFAC_SPLIT_S0", "1") != "0"):
        _SUBB = 6
        S = mono_span >> _SUBB
        c1 = mono_cand[1]
        cols1 = c1["cols"]
        offs1 = lv.tr_offs[0]
        cnt1 = offs1[1:] - offs1[:-1]
        n_rows1 = len(cnt1)
        row1 = np.repeat(np.arange(n_rows1, dtype=np.int64), cnt1)
        rows2 = row1 * S + (cols1 >> _SUBB)
        perm = np.argsort(rows2, kind="stable")
        cols2 = (cols1 & ((1 << _SUBB) - 1))[perm]
        cnt2 = np.bincount(rows2, minlength=n_rows1 * S)
        offs2 = np.concatenate(
            [[0], np.cumsum(cnt2)]
        ).astype(offs1.dtype)
        w1 = c1.get("w")
        w2 = np.repeat(w1, S) if w1 is not None else None
        from phfpfac_tpu_torch.compile.depth import (
            _grouped_cost,
            _hot_banks,
            _layout_banks,
        )

        o2, ht2 = _layout_csr(
            offs2, cols2, colspan=1 << _SUBB, priority=_prio(w2)
        )
        banks2 = _layout_banks(o2, offs2, cols2)
        hot2 = 0.0
        cost2 = float(banks2)
        if w2 is not None:
            hot2 = _hot_banks(o2, offs2, cols2, w2)
            cost2 = _grouped_cost(banks2, hot2)
        sigma0 = int(code_of.max())  # miss code == sigma
        p0x_len = (sigma0 + 1) * S
        nb_p0x = -(-p0x_len // _LANE)
        nb_p0_plain = -(-mono_span // _LANE)
        cost_split = 4.0 * (nb_p0x + cost2)
        cost_plain = 4.0 * (nb_p0_plain + c1["banks"])
        if cost_split < cost_plain:
            split0 = dict(
                S=S, offs2=offs2, cols2=cols2, o2=o2, ht2=ht2,
                perm=perm, hot=int(np.ceil(hot2)), p0x_len=p0x_len,
            )
            p0_mode = "s0x"

    # Dead-walker displacement = 0 (the DEAD ZONE scheme): every
    # table's real rows are shifted up by its colspan, so a dead
    # walker's probe index (0 + sym < span) lands strictly below the
    # k0-trimmed first bank — it can never verify, AND it stays below
    # every grouped-scan boundary, so the kernel's dynamic bank bound
    # is a plain unmasked max over raw indices (dead walkers excluded
    # for free; ~2 vops/probe/tile cheaper than live-masking).  The
    # k0 trim reclaims the zone, so it costs no VMEM.  The value
    # FIELD capacity still bounds table size: stored displacements
    # (offset + span) must fit 31 - max_vshift bits — the same
    # ht_len + colspan <= cap formula the DP already prices.
    max_vshift = max(
        [cb + 1] + [2 * cb + 1 for k, _ in plan_kinds if k == "pair"]
    )
    field_cap = (1 << (31 - max_vshift)) - 1
    miss = 0

    # ---- assemble chosen steps from the cached candidate layouts ----------
    # For each step: rows = classes at its start depth.
    built: list[dict] = [None] * len(plan_kinds)
    # disp_of[i][cls] = displacement into step i's table for a walker
    # landing on a class at that step's start depth
    disp_of: list[np.ndarray] = [None] * (len(plan_kinds) + 1)

    def landing_arr(i: int, cls: np.ndarray) -> np.ndarray:
        """Value-field (disp) stored for walkers landing on classes at
        step i's start depth; 0 (the dead-zone displacement) for dead
        landings (past the last step / no onward row / an EMPTY
        forced step this shard's automaton never reaches)."""
        if i >= len(plan_kinds) or disp_of[i] is None:
            return np.full(len(cls), miss, dtype=np.int64)
        off = disp_of[i][cls]
        return np.where(off != _EMPTY, off, miss)

    for i in range(len(plan_kinds) - 1, -1, -1):
        kind, d = plan_kinds[i]
        if i == 0 and split0 is not None:
            # split depth-2 step: offsets are per (row, sub) — consumed
            # only by the s0x prologue builder below, never landing_arr
            off_sh = np.where(
                split0["o2"] != _EMPTY, split0["o2"] + (1 << 6), _EMPTY
            )
            disp_of[0] = None  # not class-indexed; p0x reads off_sh
            built[0] = dict(
                kind="mono", d=1, vshift=6 + 2, split=split0,
                offsets=off_sh, ht_len=split0["ht2"] + (1 << 6),
                hot=split0["hot"], col_bits=6,
            )
            continue
        in_range = (kind == "mono" and d in mono_cand) or (
            kind == "pair" and d in pair_cand
        )
        if not in_range:
            # forced step past this shard's depth: all-miss table.
            # Carry the LEAD shard's nibble choice (forced_nib) so the
            # stacked build's side dead-zone base (span >> wshift) and
            # s_k0 stay uniform across shards — an empty step with the
            # byte default would otherwise debase with the wrong shift
            # and fail the stacker's uniformity assertions.
            built[i] = dict(
                kind=kind, d=d,
                vshift=(cb + 1) if kind == "mono" else (2 * cb + 1),
                empty=True,
                nib=bool(forced_nib.get(d, False)) if kind == "pair"
                else False,
            )
            continue
        _materialize(kind, d)
        if kind == "mono":
            c = mono_cand[d]
            off_sh = np.where(
                c["offsets"] != _EMPTY, c["offsets"] + mono_span, _EMPTY
            )
            disp_of[i] = off_sh
            built[i] = dict(
                kind=kind, d=d, vshift=cb + 1, offsets=off_sh,
                ht_len=c["ht_len"] + mono_span, cols=c["cols"],
                hot=c.get("hot", 0),
            )
        else:
            c = pair_cand[d]
            off_sh = np.where(
                c["offsets"] != _EMPTY, c["offsets"] + pair_span, _EMPTY
            )
            disp_of[i] = off_sh
            built[i] = dict(
                kind=kind, d=d, vshift=2 * cb + 1, offsets=off_sh,
                ht_len=c["ht_len"] + pair_span, join=c["join"],
                nib=c["nib"],
                hot=c.get("hot", 0), hot_s=c.get("hot_s", 0),
            )

    # ---- fill -------------------------------------------------------------
    # every stored displacement (offset + span) must fit the value
    # field; dead-zone safety is by construction (real offsets >= span)
    span_of = {"mono": mono_span, "pair": pair_span}
    for b in built:
        if b.get("empty"):
            continue
        mx_off = int(np.max(
            b["offsets"], initial=0,
            where=b["offsets"] != _EMPTY,
        ))
        if mx_off > field_cap:
            raise PairUnsupported(
                "displacement overflows the value field"
            )

    main_tables, side_tables = [], []
    # An empty forced step appends its all-miss table and then, below,
    # the previous step's table once more (nothing walks into a table
    # behind an empty step).  Where the FIRST step is empty there is no
    # previous table: the JAX package's compiler fails there on an
    # unbound name, and this one refuses the shard to the next engine.
    if built and built[0].get("empty"):
        raise PairUnsupported("the first forced step is empty for this shard")
    for i, b in enumerate(built):
        kind, d, vshift = b["kind"], b["d"], b["vshift"]
        li = d - 1
        nxt = i + 1
        if b.get("empty"):
            main_tables.append(np.full(1, -1, dtype=np.int32))
            side_tables.append(np.zeros(1, dtype=np.int32))
        elif kind == "mono" and b.get("split"):
            sp0 = b["split"]
            tbl = np.full(b["ht_len"], -1, dtype=np.int32)
            cols2 = sp0["cols2"]
            child2 = lv.tr_child[0].astype(np.int64)[sp0["perm"]]
            cnt2 = sp0["offs2"][1:] - sp0["offs2"][:-1]
            row2 = np.repeat(
                np.arange(len(cnt2), dtype=np.int64), cnt2
            )
            roff = b["offsets"][row2]
            keep = roff != _EMPTY
            nv = landing_arr(nxt, child2)
            fin = lv.fin[1][child2].astype(np.int64)
            entry = (
                (nv << b["vshift"]) | (fin << (b["vshift"] - 1)) | cols2
            ).astype(np.int32)
            tbl[roff[keep] + cols2[keep]] = entry[keep]
            side_tables.append(np.zeros(1, dtype=np.int32))
        elif kind == "mono":
            tbl = np.full(b["ht_len"], -1, dtype=np.int32)
            offs = lv.tr_offs[li]
            cols = b["cols"]
            child = lv.tr_child[li].astype(np.int64)
            row = np.repeat(
                np.arange(len(offs) - 1, dtype=np.int64),
                offs[1:] - offs[:-1],
            )
            roff = b["offsets"][row]
            keep = roff != _EMPTY
            nv = landing_arr(nxt, child)
            fin = lv.fin[d][child].astype(np.int64)
            entry = ((nv << vshift) | (fin << cb) | cols).astype(np.int32)
            tbl[roff[keep] + cols[keep]] = entry[keep]
            side_tables.append(np.zeros(1, dtype=np.int32))
        else:
            p_offs, pair, end, s_offs, side = b["join"]
            endl = end.astype(np.int64)
            fin_end = (
                lv.fin[d + 1][endl]
                if d + 1 <= D - 1
                else np.zeros(len(endl), dtype=bool)
            )
            tbl, stbl = _fill_pair_table(
                b["ht_len"], b["offsets"], p_offs, pair, end, s_offs,
                side, disp_next=landing_arr(nxt, endl), fin_end=fin_end,
                vshift=vshift, fin_shift=2 * cb, mono_span=mono_span,
                side_nibble=b["nib"],
            )
            side_tables.append(stbl)
        main_tables.append(tbl)

    # ---- prologue: dense P0 (depths 1+2) or code-indexed s0 (depth 1) ------
    p0_miss = miss
    if p0_mode == "dense":
        p0 = build_dense_p0(
            shard, lv, code_of, cb,
            landing_fn=lambda cls: int(landing_arr(0, np.array([cls]))[0]),
            miss=miss,
        )
    elif p0_mode == "s0x":
        # p0x[(code1 * S) + (code2 >> 6)] = (disp into the SPLIT d2
        # table << 1) | fin1; -1 = no depth-1 state.  Sub-rows with no
        # entries store the dead displacement (walker survives only to
        # report fin1) — a free one-step-earlier death for ~empty subs.
        S = split0["S"]
        o2sh = built[0]["offsets"]
        p0 = np.full(split0["p0x_len"], -1, dtype=np.int32)
        for c in range(256):
            u = int(shard.s0[c])
            if u < 0:
                continue
            cls = int(lv.s0_class[u])
            fin1 = 1 if lv.fin[0][cls] else 0
            for sub in range(S):
                off = o2sh[cls * S + sub]
                dd = int(off) if off != _EMPTY else miss
                p0[int(code_of[c]) * S + sub] = (dd << 1) | fin1
    else:
        # s0[code] = (disp into step 0 << 1) | fin1, -1 = no depth-1 state
        p0 = np.full(mono_span, -1, dtype=np.int32)
        for c in range(256):
            u = int(shard.s0[c])
            if u < 0:
                continue
            cls = lv.s0_class[u]
            fin1 = 1 if lv.fin[0][cls] else 0
            p0[int(code_of[c])] = (
                int(landing_arr(0, np.array([cls]))[0]) << 1
            ) | fin1

    # ---- bank + spec assembly ----------------------------------------------
    if trim:
        tm = [_to_banks_trimmed(t) for t in main_tables]
        ts = [_to_banks_trimmed(t, fill=0) for t in side_tables]
    else:
        # stacked builds need shard-uniform bank offsets, so the
        # data-driven trim is off — but the dead zone [0, span) is
        # empty BY CONSTRUCTION (same span for every shard's step i),
        # so its full banks can be dropped uniformly via k0
        def _debase(t: np.ndarray, fill: int, zone: int) -> tuple:
            b = _to_banks(t, fill)
            k0u = zone // _LANE
            if b.shape[0] > k0u:
                return b[k0u:], k0u
            # all-miss (EMPTY forced step): keep one fill bank at the
            # SAME k0 as real shards so the stacked spec stays uniform
            return b[:1], k0u

        tm, ts = [], []
        for i, b2 in enumerate(built):
            span = span_of[b2["kind"]]
            wshift = 3 if b2.get("nib", False) else 2
            tm.append(_debase(main_tables[i], -1, span))
            ts.append(_debase(side_tables[i], 0, span >> wshift))
    specs, m_acc, s_acc = [], 0, 0
    for i, b in enumerate(built):
        mb, mk0 = tm[i]
        sb, sk0 = ts[i]
        specs.append(
            StepSpec(
                kind=b["kind"], depth0=b["d"] + 1,
                off=m_acc, nb=mb.shape[0], k0=mk0,
                s_off=s_acc, s_nb=sb.shape[0], s_k0=sk0,
                s_nibble=bool(b.get("nib", False)), miss=miss,
                col_bits=int(b.get("col_bits", 0)),
                hot_nb=int(b.get("hot", 0)),
                s_hot_nb=int(b.get("hot_s", 0)),
            )
        )
        m_acc += mb.shape[0]
        s_acc += sb.shape[0]
    return PlanTables(
        code_of=code_of,
        code_bits=cb,
        p0_mode=p0_mode,
        p0_banks=_to_banks(p0),
        packed_banks=(
            np.concatenate([b for b, _ in tm])
            if tm else np.full((1, _LANE), -1, np.int32)
        ),
        side_banks=(
            np.concatenate([b for b, _ in ts])
            if ts else np.zeros((1, _LANE), np.int32)
        ),
        steps=tuple(specs),
        p0_miss=p0_miss,
        max_pat_len=shard.max_pat_len,
        trained=weights is not None,
        live_frac=tuple(
            float(weights[d - 1].sum()) / max(train_len, 1)
            if weights is not None and d - 1 < len(weights) else 0.0
            for _k, d in plan_kinds
        ),
        kinds=tuple(
            (k, d) if k == "mono" else (k, d, specs[i].s_nibble)
            for i, (k, d) in enumerate(plan_kinds)
        ),
    )


@dataclass
class StackedPlanTables:
    """All shards' plan tables under ONE uniform static program.

    SPMD over a ``patterns`` mesh axis needs identical kernel statics
    on every device, so: one shared alphabet coding (union of the
    shards' bytes), one step-kind list (chosen by shard 0's DP and
    imposed on the rest; depths a shard lacks become all-miss steps),
    k0-trimming off, and per-step bank counts padded to the max across
    shards.  Probes into the -1 padding miss — correctness never
    depends on the padding, only throughput does.
    """

    code_of: np.ndarray
    code_bits: int
    p0_mode: str
    p0_banks: np.ndarray  # int32 [S, NBP0, 128]
    packed_banks: np.ndarray  # int32 [S, NB, 128]
    side_banks: np.ndarray  # int32 [S, NS, 128]
    steps: tuple  # uniform StepSpec (k0 = the shared dead-zone base)
    p0_miss: int
    max_pat_len: int
    trained: bool
    # per-step trained live fractions, elementwise MAX across shards
    # (conservative: sizes the compaction cap for the busiest shard)
    live_frac: tuple = ()

    @property
    def num_shards(self) -> int:
        return self.p0_banks.shape[0]


def union_alphabet(shards) -> tuple:
    """Shared (code_of, sigma, cb) over the union of shard bytes.

    Same contract as collect_alphabet (miss code = sigma, strictly
    below the code-field mask)."""
    used = np.zeros(256, dtype=bool)
    for sh in shards:
        if sh.patterns is None:
            raise PairUnsupported("stacking needs shards with patterns")
        for p in sh.patterns:
            used[np.frombuffer(p, dtype=np.uint8)] = True
    sigma = int(used.sum())
    cb = max(sigma.bit_length(), 1)
    if sigma == (1 << cb) - 1:
        cb += 1
    code_of = np.full(256, sigma, dtype=np.int32)
    code_of[np.flatnonzero(used)] = np.arange(sigma, dtype=np.int32)
    return code_of, sigma, cb


def build_stacked_plan_tables(
    shards, *, train: bytes | np.ndarray | None = None,
) -> StackedPlanTables:
    """Stack every shard's plan tables into one SPMD-ready program.

    Raises PairUnsupported when any shard cannot take the shared
    coding/kinds (callers fall back to the host shard loop)."""
    if not shards:
        raise PairUnsupported("no shards")
    code = union_alphabet(shards)
    # the kind list must cover the DEEPEST automaton — shallower shards
    # pad with all-miss steps, but steps can never be added per shard
    lead_i = int(np.argmax([sh.max_pat_len for sh in shards]))
    lead = build_plan_tables(shards[lead_i], train=train, code=code)
    kinds = lead.kinds
    pts = [
        build_plan_tables(
            sh, train=train, code=code, forced_kinds=kinds, trim=False
        )
        for sh in shards
    ]
    n_steps = len(kinds)
    assert all(len(pt.steps) == n_steps for pt in pts)
    assert all(pt.p0_miss == pts[0].p0_miss for pt in pts)

    nb_p0 = max(pt.p0_banks.shape[0] for pt in pts)
    nbs = [max(pt.steps[i].nb for pt in pts) for i in range(n_steps)]
    snbs = [max(pt.steps[i].s_nb for pt in pts) for i in range(n_steps)]
    m_offs = np.concatenate([[0], np.cumsum(nbs)])
    s_offs = np.concatenate([[0], np.cumsum(snbs)])
    S = len(pts)
    p0 = np.full((S, nb_p0, _LANE), -1, np.int32)
    packed = np.full((S, int(m_offs[-1]), _LANE), -1, np.int32)
    side = np.zeros((S, int(s_offs[-1]), _LANE), np.int32)
    for s, pt in enumerate(pts):
        p0[s, : pt.p0_banks.shape[0]] = pt.p0_banks
        for i, sp in enumerate(pt.steps):
            packed[s, m_offs[i] : m_offs[i] + sp.nb] = (
                pt.packed_banks[sp.off : sp.off + sp.nb]
            )
            side[s, s_offs[i] : s_offs[i] + sp.s_nb] = (
                pt.side_banks[sp.s_off : sp.s_off + sp.s_nb]
            )
    for pt in pts:
        for i in range(n_steps):
            # the dead-zone k0 depends only on (kind, nibble), which
            # the forced builds share — uniform across shards.  Raise
            # the expected fallback exception (callers drop to the
            # host shard loop) rather than crashing on an invariant.
            if (pt.steps[i].k0 != pts[0].steps[i].k0
                    or pt.steps[i].s_k0 != pts[0].steps[i].s_k0):
                raise PairUnsupported(
                    f"non-uniform dead-zone base at step {i}"
                )
    specs = tuple(
        StepSpec(
            kind=kinds[i][0], depth0=kinds[i][1] + 1,
            off=int(m_offs[i]), nb=int(nbs[i]),
            k0=pts[0].steps[i].k0,
            s_off=int(s_offs[i]), s_nb=int(snbs[i]),
            s_k0=pts[0].steps[i].s_k0,
            # the kinds tuple carries the lead shard's nibble choice,
            # which the forced builds reproduced (it is a kernel
            # static shared by every shard)
            s_nibble=pts[0].steps[i].s_nibble, miss=pts[0].steps[i].miss,
            hot_nb=max(pt.steps[i].hot_nb for pt in pts),
            s_hot_nb=max(pt.steps[i].s_hot_nb for pt in pts),
        )
        for i in range(n_steps)
    )
    for pt in pts:
        for i in range(n_steps):
            assert pt.steps[i].s_nb <= 1 or (
                pt.steps[i].s_nibble == specs[i].s_nibble
            )
    return StackedPlanTables(
        code_of=code[0], code_bits=code[2], p0_mode=pts[0].p0_mode,
        p0_banks=p0, packed_banks=packed, side_banks=side,
        steps=specs, p0_miss=pts[0].p0_miss,
        max_pat_len=max(sh.max_pat_len for sh in shards),
        trained=all(pt.trained for pt in pts),
        live_frac=tuple(
            max(
                (pt.live_frac[i] if i < len(pt.live_frac) else 0.0)
                for pt in pts
            )
            for i in range(n_steps)
        ),
    )
