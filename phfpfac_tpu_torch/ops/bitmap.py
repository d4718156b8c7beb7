"""Match-bitmap fetch and decoding.

The scan kernels emit, per position, a 32-bit bitmap with bit t set
iff a match of length t+1 starts there.  The bitmap plus the compiled
tables fully determine the matches: re-walking only the hit positions
through the PHF (vectorized on the host, NumPy) recovers each match's
shard-local final state.  Hit positions are a small fraction of the
input, so the decode pass costs O(hits x avg walk), and the device
never materializes the reference's [input_size x max_pat_len] match
rows (master_kernel.cu:104-115) — the bitmap is 4 bytes/position.
"""

from __future__ import annotations

import numpy as np
import torch

from phfpfac_tpu_torch.compile.tables import ShardTables


def fetch_hit_bits(bits_dev: torch.Tensor, input_size: int):
    """Download only the bitmap entries that contain hits.

    One ``torch.nonzero`` over the first ``input_size`` positions on
    the scan's device, then ONE device-to-host copy of the (position,
    bitmap) pairs: the download is O(hits), 8 bytes per hit.

    Returns (hit_pos int64[], hit_bits uint32[]).
    """
    b = bits_dev[:input_size]
    pos = torch.nonzero(b).squeeze(1)
    pairs = torch.stack([pos, b[pos].to(torch.int64)]).cpu().numpy()
    return pairs[0], pairs[1].astype(np.int32).view(np.uint32)


def decode_bitmap(
    bits: np.ndarray,  # int32 [>= input_size] (host or device)
    data: bytes | np.ndarray,
    input_size: int,
    shard: ShardTables,
    max_steps: int,
) -> np.ndarray:
    """bitmaps -> flat int64 [(pos, step, shard-local state)] sorted by
    (pos, step), by re-walking hit positions through the shard's PHF."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    bits = np.asarray(bits)[:input_size].view(np.uint32)
    hit_pos = np.nonzero(bits)[0].astype(np.int64)
    return decode_hits(bits[hit_pos], hit_pos, data, input_size, shard,
                       max_steps)


def decode_hits(
    hb: np.ndarray,  # uint32 [h] bitmaps of the hit positions
    hit_pos: np.ndarray,  # int64 [h]
    data: bytes | np.ndarray,
    input_size: int,
    shard: ShardTables,
    max_steps: int,
) -> np.ndarray:
    """Sparse-form decode (see fetch_hit_bits)."""
    if hit_pos.size == 0:
        return np.empty((0, 3), dtype=np.int64)
    arr = (
        np.frombuffer(bytes(data), dtype=np.uint8)
        if isinstance(data, (bytes, bytearray))
        else np.asarray(data, dtype=np.uint8)
    )
    import os

    from phfpfac_tpu_torch.compile import native

    if native.available():
        # match-dense corpora make this walk the e2e bottleneck; the
        # threaded C++ paths are the fast lane (the NumPy code below
        # stays the semantics oracle,
        # tests/test_native.py::test_decode_hits_native_parity).
        # Plain dictionaries skip the trie walk entirely: bit t at pos
        # means data[pos..pos+t] IS a pattern, so decode is ONE
        # open-addressed hash probe per set bit (L2-resident table)
        # instead of per-step dense-table cache misses.
        if (
            shard.patterns is not None
            and shard.output_lists is None
            and os.environ.get("PHFPFAC_NO_HASH_DECODE") != "1"
        ):
            return native.decode_hits_hash_native(
                hb, hit_pos, arr[:input_size], shard, min(max_steps, 32)
            )
        return native.decode_hits_native(
            hb, hit_pos, arr[:input_size], shard, min(max_steps, 32)
        )
    # Walk backend: the PHF probe when it is already built, else the
    # dense trie table (one gather per step; keeps the decode path
    # from forcing the lazy FFDM pack, compile.tables.ShardTables).
    use_phf = shard.has_phf
    if use_phf:
        width_bit = shard.width_bit
        width_m1 = shard.width - 1
        ht_size = shard.ht_size
    else:
        dense = shard.dense_table()
    k = shard.final_state_num
    n = len(arr)

    state = shard.s0[arr[hit_pos]].astype(np.int64)
    out = []

    def record(t, state):
        sel = ((hb >> np.uint32(t)) & np.uint32(1)).astype(bool)
        sel &= (state >= 0) & (state < k)
        if sel.any():
            out.append(
                np.stack(
                    [hit_pos[sel], np.full(sel.sum(), t, np.int64), state[sel]],
                    axis=1,
                )
            )

    record(0, state)
    max_t = min(max_steps, 32)
    for t in range(1, max_t):
        if not (state >= 0).any():
            break
        idx_c = np.minimum(hit_pos + t, n - 1)
        ch = arr[idx_c].astype(np.int64)
        alive = (state >= 0) & (hit_pos + t < n)
        if use_phf:
            key = np.where(state >= 0, state, 0) * 256 + ch
            row = key >> width_bit
            col = key & width_m1
            row_ok = alive & (row < len(shard.r))
            ridx = shard.r[np.clip(row, 0, len(shard.r) - 1)] + col
            ok = row_ok & (ridx >= 0) & (ridx < ht_size)
            ridx_c = np.clip(ridx, 0, max(ht_size - 1, 0))
            ok &= shard.ht[ridx_c] == row
            state = np.where(ok, shard.val[ridx_c], -1).astype(np.int64)
        else:
            nxt = dense[np.where(alive, state, 0), ch]
            state = np.where(alive, nxt, -1).astype(np.int64)
        record(t, state)

    if not out:
        return np.empty((0, 3), dtype=np.int64)
    m = np.concatenate(out)
    return m[np.lexsort((m[:, 1], m[:, 0]))]
