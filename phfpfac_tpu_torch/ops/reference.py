"""Dense PFAC scan in torch ops — the portable reference engine.

The counterpart of the JAX package's ``ops/reference_jnp.py``.
Semantics are those of ``TraceTable_kernel`` (master_kernel.cu:92-180)
with the SUBSEG_MATCH walk (:37-74), as a data-parallel masked walk
over *all* byte offsets at once:

* step 0: ``state = s0[byte[pos]]`` for every position (cf. :41);
* step t: for live walks, probe the raw PHF
  (``key = state*256 + ch``, ``row = key >> width_bit``,
  ``col = key & (width-1)``, ``idx = r[row] + col``,
  ``hit = 0 <= idx < ht_size and ht[idx] == row``, cf. :52-64);
* every state < k appends the shard-local final state to the
  position's match row (cf. :43-47, :67-70);
* walks stop at their per-position limit (segment+halo truncation or
  exact mode — ops.common.walk_limits).

It carries ``--engine jnp``, ``Matcher.match_rows`` and the exact
fallback when the turbo engine's compaction overflows.  The
``[n_pos, slots]`` rows live on the scan device: 4 * slots bytes per
position.
"""

from __future__ import annotations

import numpy as np
import torch

from phfpfac_tpu_torch.compile.tables import ShardTables
from phfpfac_tpu_torch.ops.common import padded_steps, resolve_device
from phfpfac_tpu_torch.ops.staging import to_device_bytes


def scan_shard(
    shard: ShardTables,
    data_padded,  # uint8 [>= n_pos + max_steps]
    limits,  # int32 [n_pos] exclusive read limit per position
    input_size: int,
    *,
    slots: int,
    emit_counts: bool = False,
    device=None,
):
    """Scan with one shard's tables; returns (match_rows, counts), or
    counts alone with ``emit_counts``, as tensors on ``device`` (CUDA
    unless named).

    ``match_rows[p, j]`` is the j-th shard-local final state hit by the
    walk from position p (-1 padded), in increasing match length —
    exactly the reference's per-shard ``match_result`` rows
    (master_kernel.cu:104-115) modulo the slot count.
    """
    # the step count is bucketed as in the JAX engine; extra steps are
    # masked no-ops
    max_steps = padded_steps(shard.max_pat_len)
    data = to_device_bytes(data_padded, resolve_device(device))
    dev = data.device

    def table(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    limits = table(limits)
    s0, r, ht, val = (table(a) for a in (shard.s0, shard.r, shard.ht,
                                         shard.val))
    n_pos = limits.shape[0]
    ht_size = ht.shape[0]
    wb = shard.width_bit
    num_final = shard.final_state_num
    pos = torch.arange(n_pos, dtype=torch.int32, device=dev)
    chars = data.to(torch.int32)

    # step 0: initial-state row lookup (master_kernel.cu:41)
    state = torch.where(pos < input_size,
                        torch.index_select(s0, 0, chars[:n_pos]), -1)
    out = None if emit_counts else torch.full(
        (n_pos, slots), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(n_pos, dtype=torch.int32, device=dev)

    def emit(state):
        hit = (state >= 0) & (state < num_final)
        if out is not None:
            slot = torch.clamp(cnt, max=slots - 1).to(torch.int64)[:, None]
            cur = out.gather(1, slot)
            out.scatter_(1, slot, torch.where(hit[:, None], state[:, None],
                                              cur))
        cnt.add_(hit)

    emit(state)
    for t in range(1, max_steps):
        # one probe for all walks (PHF lookup, master_kernel.cu:52-64)
        active = (state >= 0) & (pos + t < limits)
        key = torch.where(active, state, 0) * 256 + chars[t:t + n_pos]
        row = key >> wb  # key >= 0: arithmetic == logical
        col = key & ((1 << wb) - 1)
        # out-of-table rows and slots are clamped for the gather and
        # rejected by in_range / the row check, never indexed past the end
        idx = torch.index_select(r, 0, torch.clamp(row, max=r.shape[0] - 1)) \
            + col
        in_range = (idx >= 0) & (idx < ht_size)
        idx_c = torch.clamp(idx, 0, ht_size - 1)
        hit = in_range & (torch.index_select(ht, 0, idx_c) == row)
        nxt = torch.where(hit, torch.index_select(val, 0, idx_c), -1)
        state = torch.where(active, nxt, -1)
        emit(state)
    return cnt if emit_counts else (out, cnt)
