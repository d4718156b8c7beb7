"""Turbo PFAC scan — the portable table-walk engine, in torch ops.

The counterpart of the JAX package's ``ops/turbo_jnp.py``: the same walk
as the reference kernel (master_kernel.cu:37-74) over the raw FFDM
perfect-hash tables, vectorised over all byte offsets with plain torch
ops (no hand-written kernel).  It carries ``--engine turbo``, long
pattern tails of more than 8 patterns, any shard no bitmap kernel
takes, and ``Matcher.count_matches``.

Design (the tables are built on the host, identically to the JAX
package's, so both scan the very same arrays):

1. **Packed probe.** HT and val merge into one int32
   (``val << row_bits | row``) so a probe is 2 gathers (r, packed)
   instead of 3 (split tables when the bit budget doesn't fit).
2. **Guard bands, no bounds checks.** The packed table gets
   ``width``-sized -1 guard bands on both sides and ``r`` is stored
   pre-biased by +width, so every probe index is in-bounds by
   construction and misses verify-fail naturally.
3. **DEAD sentinel, no liveness masks.** Dead walks carry a sentinel
   state whose key range maps into appended sentinel rows of ``r``
   that point at the guard band, so a dead walk stays dead through
   the same data path as a live probe.
4. **Compaction.** After ``full_steps`` full-width steps, surviving
   walks are compacted with a cumsum+scatter into a ``cap``-sized
   buffer and finished there.  If survivors overflow ``cap`` the scan
   reports overflow and the caller falls back to the dense engine
   (ops.reference).
5. **Emission without scatters.** Full-width steps emit one [n_pos]
   row each; tail steps emit [cap] rows; ``expand_turbo_matches``
   turns rows into (position, step, state) matches.

The compacted tail runs a fixed ``max_steps - t0`` steps.  The JAX
engine stops its ``while_loop`` as soon as every survivor is dead; a
dead walker emits nothing and stays dead, so the outputs are identical,
and the fixed loop needs no device-to-host sync per step.

All arithmetic is int32, as in the JAX engine.  torch's ``>>`` on int32
is arithmetic where JAX uses a logical shift: keys are non-negative
(``dead << 8`` fits int32), and the only negative operand, a ``-1``
miss entry, never verifies, so its shifted value is discarded.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from phfpfac_tpu_torch.compile.tables import ShardTables
from phfpfac_tpu_torch.ops.common import resolve_device
from phfpfac_tpu_torch.ops.staging import to_device_bytes
from phfpfac_tpu_torch.utils.config import PfacConfig


@dataclass
class TurboTables:
    """Device-layout tables derived from ShardTables."""

    s0: np.ndarray  # int32 [256], -1 -> DEAD
    r: np.ndarray  # int32 [rows + sentinels], pre-biased +width, sentinel -> 0
    packed: np.ndarray | None  # int32 [width + ht_size + width] with guards
    ht: np.ndarray | None  # split fallback (guarded), same layout as packed
    val: np.ndarray | None
    width_bit: int
    row_bits: int
    dead: int  # DEAD sentinel state
    num_final: int
    max_pat_len: int

    @property
    def is_packed(self) -> bool:
        return self.packed is not None

    def on(self, device) -> tuple:
        """(s0, r, tbl_a, tbl_b) as int32 tensors on ``device`` (cached):
        tbl_a is packed or ht, tbl_b is val or None."""
        cache = self.__dict__.setdefault("_on", {})
        key = str(torch.device(device))
        if key not in cache:
            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                    device)

            cache[key] = (
                dev(self.s0), dev(self.r),
                dev(self.packed if self.is_packed else self.ht),
                None if self.val is None else dev(self.val),
            )
        return cache[key]


def build_turbo_tables(shard: ShardTables) -> TurboTables:
    width = shard.width
    wb = shard.width_bit
    n_rows = len(shard.r)
    # sentinel rows must cover the key range of the DEAD state:
    # dead*256 < n_rows*width + 256, so max probed row is
    # (n_rows*width + 511) >> wb = n_rows + (511 >> wb) — pad generously.
    n_sent = (512 >> wb) + 2
    dead = -(-(n_rows * width) // 256)  # smallest state keyed past real rows
    row_bits = int(n_rows + n_sent).bit_length()

    r = np.zeros(n_rows + n_sent, dtype=np.int32)
    # bias by +width so probe index (r[row] + col) lands in
    # [0, width + ht_size + width) for every reachable (row, col):
    #   real r >= -(width-1)  ->  idx >= 1
    #   sentinel r = -width   ->  idx in [0, width)  (left guard)
    r[:n_rows] = shard.r + width
    # empty real rows keep r == -1 + width; they can't false-hit because
    # no slot stores an empty row as owner.

    ht_size = len(shard.ht)

    def guard(a: np.ndarray) -> np.ndarray:
        out = np.full(width + ht_size + width, -1, dtype=np.int32)
        out[width : width + ht_size] = a
        return out

    s0 = np.where(shard.s0 < 0, dead, shard.s0).astype(np.int32)

    max_val = max(int(shard.val.max(initial=0)), dead)
    if row_bits + int(max_val).bit_length() < 31:
        packed = np.where(
            shard.ht >= 0,
            (shard.val.astype(np.int64) << row_bits)
            | shard.ht.astype(np.int64),
            -1,
        ).astype(np.int32)
        return TurboTables(
            s0=s0, r=r, packed=guard(packed), ht=None, val=None,
            width_bit=wb, row_bits=row_bits, dead=dead,
            num_final=shard.final_state_num, max_pat_len=shard.max_pat_len,
        )
    return TurboTables(
        s0=s0, r=r, packed=None, ht=guard(shard.ht), val=guard(shard.val),
        width_bit=wb, row_bits=row_bits, dead=dead,
        num_final=shard.final_state_num, max_pat_len=shard.max_pat_len,
    )


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for an int32 index tensor (in bounds by construction)."""
    return torch.index_select(table, 0, idx)


def probe(state, ch, r, tbl_a, tbl_b, *, width_bit: int, row_bits: int,
          dead: int):
    """One PHF transition for a batch of walks over guarded turbo tables
    (int32 in and out; no masks needed)."""
    key = (state << 8) + ch
    row = key >> width_bit  # key >= 0: arithmetic == logical
    idx = take(r, row) + (key & ((1 << width_bit) - 1))
    if tbl_b is None:
        g = take(tbl_a, idx)
        hit = (g & ((1 << row_bits) - 1)) == row
        nxt = g >> row_bits  # a -1 miss never hits: its shift is dropped
    else:
        hit = take(tbl_a, idx) == row
        nxt = take(tbl_b, idx)
    return torch.where(hit, nxt, dead)


def scan_core(
    data: torch.Tensor,  # uint8 [n_pos + max_steps] — local bytes incl. halo
    pos0: int,  # global position of local position 0
    s0, r, tbl_a, tbl_b,  # TurboTables.on(device)
    input_size: int,  # global
    width_bit: int,
    row_bits: int,
    dead: int,
    num_final: int,
    seg_bytes: int,  # 0 = exact mode
    halo_bytes: int,
    *,
    max_steps: int,
    full_steps: int,
    cap: int,
    emit_counts: bool,
):
    """Scan body in local-coordinate positions: a block of a larger
    corpus scans with ``pos0`` = its global offset, so the global
    segment cut and input size hold.  Returned tail positions are local.
    """
    dev = data.device
    n_pos = data.shape[0] - max_steps
    pos = torch.arange(n_pos, dtype=torch.int32, device=dev)
    chars = data.to(torch.int32)
    kw = dict(width_bit=width_bit, row_bits=row_bits, dead=dead)

    def expire(state, p, t):
        gp = p + pos0
        if seg_bytes > 0:
            lim = torch.clamp((gp // seg_bytes + 1) * seg_bytes + halo_bytes,
                              max=input_size)
        else:
            lim = torch.clamp(gp + max_steps, max=input_size)
        return torch.where(gp + t < lim, state, dead)

    # ---- step 0: s0 lookup ----
    state = torch.where(pos + pos0 < input_size, take(s0, chars[:n_pos]),
                        dead)
    t0 = min(full_steps + 1, max_steps)
    full_out = torch.empty((0 if emit_counts else t0, n_pos),
                           dtype=torch.int32, device=dev)
    cnt = torch.zeros(n_pos, dtype=torch.int32, device=dev)

    def emit_full(t, state):
        fin = state < num_final
        if not emit_counts:
            full_out[t] = torch.where(fin, state, -1)
        cnt.add_(fin)

    emit_full(0, state)

    # ---- full-width phase ----
    for t in range(1, t0):
        state = expire(state, pos, t)
        state = probe(state, chars[t:t + n_pos], r, tbl_a, tbl_b, **kw)
        emit_full(t, state)

    tail_steps = max_steps - t0
    if tail_steps == 0:
        z = torch.zeros(cap, dtype=torch.int32, device=dev)
        return (full_out, cnt,
                torch.zeros((0, cap), dtype=torch.int32, device=dev),
                z, z.clone(), torch.zeros((), dtype=torch.bool, device=dev))

    # ---- compaction ----
    alive = state != dead
    csum = torch.cumsum(alive, 0, dtype=torch.int32)
    overflow = csum[-1] > cap
    # survivors past the cap and dead walks all land on the dropped
    # slot ``cap``; slots below it are written once each
    dst = torch.where(alive & (csum <= cap), csum - 1, cap).to(torch.int64)
    pos_c = torch.zeros(cap + 1, dtype=torch.int32, device=dev).scatter_(
        0, dst, pos)[:cap]
    state_c = torch.full((cap + 1,), dead, dtype=torch.int32,
                         device=dev).scatter_(0, dst, state)[:cap]
    del alive, csum, dst

    # ---- compacted tail: every remaining step (see the module note) ----
    tail_out = torch.full((tail_steps, cap), -1, dtype=torch.int32,
                          device=dev)
    tail_cnt = torch.zeros(cap, dtype=torch.int32, device=dev)
    st = state_c
    for t in range(t0, max_steps):
        st = expire(st, pos_c, t)
        st = probe(st, take(chars, pos_c + t), r, tbl_a, tbl_b, **kw)
        fin = st < num_final
        if not emit_counts:
            tail_out[t - t0] = torch.where(fin, st, -1)
        tail_cnt.add_(fin)
    return full_out, cnt, tail_out, pos_c, tail_cnt, overflow


def scan_shard_turbo(
    shard: ShardTables,
    data_padded,
    input_size: int,
    cfg: PfacConfig,
    *,
    max_steps: int,
    full_steps: int = 2,
    cap_frac: int = 8,
    emit_counts: bool = False,
    turbo_tables: TurboTables | None = None,
    device=None,
):
    """Run the turbo scan on ``device`` (CUDA unless named); returns
    ``(full_rows, cnt, tail_rows, tail_pos, tail_cnt, overflow)`` as
    tensors there — see ``expand_turbo_matches`` for the assembly.  On
    ``overflow`` the caller must fall back to the dense engine.
    """
    tt = turbo_tables or build_turbo_tables(shard)
    data = to_device_bytes(data_padded, resolve_device(device))
    n_pos = data.shape[0] - max_steps
    cap = max(-(-n_pos // cap_frac), 128)
    seg_bytes = cfg.segment_bytes if cfg.truncation == "segment" else 0
    return scan_core(
        data, 0, *tt.on(data.device), int(input_size), tt.width_bit,
        tt.row_bits, tt.dead, tt.num_final, seg_bytes, cfg.halo_bytes,
        max_steps=max_steps, full_steps=full_steps, cap=cap,
        emit_counts=emit_counts,
    )


def expand_turbo_matches(result, input_size: int, tail_t0: int) -> np.ndarray:
    """Turbo outputs -> [(pos, step, shard-local state)] sorted by
    (pos, step) — the same per-position increasing-length order as the
    reference's match rows.  ``tail_t0`` is the step index of the first
    tail row (= min(full_steps + 1, max_steps)).  The hits are found on
    the scan's device and only they are downloaded."""
    full_rows, _cnt, tail_rows, tail_pos, _tail_cnt, overflow = result
    if bool(overflow):
        raise OverflowError("turbo compaction overflow; use dense engine")

    parts = []
    if full_rows.numel():
        t_idx, p_idx = torch.nonzero(full_rows >= 0, as_tuple=True)
        keep = p_idx < input_size
        t_idx, p_idx = t_idx[keep], p_idx[keep]
        parts.append(torch.stack(
            [p_idx, t_idx, full_rows[t_idx, p_idx].to(torch.int64)], dim=1))
    if tail_rows.numel():
        t_idx, j_idx = torch.nonzero(tail_rows >= 0, as_tuple=True)
        p = tail_pos[j_idx].to(torch.int64)
        keep = p < input_size
        t_idx, j_idx, p = t_idx[keep], j_idx[keep], p[keep]
        parts.append(torch.stack(
            [p, t_idx + tail_t0, tail_rows[t_idx, j_idx].to(torch.int64)],
            dim=1))
    if not parts:
        return np.empty((0, 3), dtype=np.int64)
    m = torch.cat(parts).cpu().numpy()
    order = np.lexsort((m[:, 1], m[:, 0]))
    return m[order]
