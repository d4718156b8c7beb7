"""Perfect-hash compression of the sparse PFAC table — FFDM.

Implements the First-Fit Descending Method of PHF/phf.c:151-291 (the
Tarjan/Yao "compressed double displacement" scheme) with identical
displacement semantics, vectorized with NumPy instead of the
reference's O(rows^2) bubble sort + per-slot scan:

* every live transition ``(state, ch) -> next`` becomes key
  ``state * 256 + ch`` (ReadKey, phf.c:90-117);
* keys are laid into rows of ``width``: ``row = key // width``,
  ``col = key % width`` (items per row are in ascending col order);
* rows are processed in descending fullness, ties by ascending row
  number (SortRows, phf.c:126-139, preserves order of equal counts);
* each row is slid right from offset ``-cols[0]`` to the first offset
  where none of its items collide (phf.c:184-222); the offset is
  recorded in ``r[row]``, ``HT[slot] = row`` (for probe verification)
  and ``val[slot] = next_state``;
* ``HTSize`` = last occupied slot + 1 (phf.c:232-236).

Device lookup contract (master_kernel.cu:52-64):
    row = key >> width_bit; col = key & (width - 1)
    idx = r[row] + col
    hit = 0 <= idx < HTSize and HT[idx] == row
    next = val[idx] if hit else -1
A probe for a key absent from the table can never false-positive: a
slot stores the unique row that owns it, and owning a slot at
``r[row] + col`` implies ``(row, col)`` was a real key.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from phfpfac_tpu_torch.utils.config import CHAR_SET, COL_MAX, HASHTABLE_MAX, ROW_MAX


@dataclass
class PhfTable:
    """FFDM output for one shard."""

    r: np.ndarray  # int32 [num_rows]: row displacement, -1 for empty rows
    ht: np.ndarray  # int32 [ht_size]: owning row per slot, -1 empty
    val: np.ndarray  # int32 [ht_size]: next state per slot, -1 empty
    width: int
    ht_size: int
    # stats (reference prints these at phf.c:262-282)
    num_keys: int
    max_key: int
    max_offset: int

    @property
    def width_bit(self) -> int:
        return self.width.bit_length() - 1

    @property
    def stats_max_row(self) -> int:
        """MaxRow as the reference stats print it (phf.c:174)."""
        return self.max_key // self.width + 1

    def memory_bytes(self) -> int:
        return 4 * (len(self.r) + 2 * self.ht_size)

    def stats_report(self) -> str:
        """Mirror the SHOW_PHF stats block (phf.c:262-282), sans ANSI color."""
        max_row = self.stats_max_row
        dense = self.max_key + 256 - self.max_key % 256
        lines = [
            "",
            f"Number of keys    : {self.num_keys}",
            f"Max Key           : {self.max_key}",
            f"width value       : {self.width}",
            "",
            f"Max Offset        : {self.max_offset}",
            f"r table size      : {max_row:7d}  ({max_row * 4:7d} Bytes)",
            f"Hash table size   : {self.ht_size:7d}  ({self.ht_size * 4:7d} Bytes)",
            f"Val table size   : {self.ht_size:7d}  ({self.ht_size * 4:7d} Bytes)",
            f"Memory size       : {(max_row + self.ht_size * 2) * 4:7d} Bytes",
            f"Memory size       : {(max_row + self.ht_size * 2) * 4 // 1024:7d} KBytes",
            "Memory Efficiency       : {:7.2f} KBytes".format(
                (max_row + self.ht_size * 2) * 4 / max(self.num_keys, 1)
            ),
            "Table utilization : {:.3f} %".format(
                100.0 * self.num_keys / max(self.ht_size, 1) / 2
            ),
            "(Number of keys / Hash table size)",
            "Table size ratio  : {:.3f} %".format(
                100.0 * (max_row + self.ht_size * 2) / max(dense, 1)
            ),
            "((r table size + Hash table size) / 2D PFAC table size)",
            "",
        ]
        return "\n".join(lines)


def build_phf(
    table: np.ndarray,
    width: int,
    *,
    hashtable_max: int = HASHTABLE_MAX,
    use_native: bool | None = None,
) -> PhfTable:
    """Compress a dense PFAC table ``int32[state_num, 256]`` with FFDM.

    Equivalent to ``FFDM(ary, ary_size, width, r, HT, val)``
    (phf.c:151-291).  The returned ``r`` has the *device* row count
    ``(state_num * 256) // width + 1`` (master_kernel.cu:221), and
    ``ht``/``val`` are trimmed to ``ht_size``.
    """
    if width > COL_MAX:
        raise ValueError(f"width may not exceed {COL_MAX}")  # phf.c:161-164
    if width <= 0 or width & (width - 1):
        raise ValueError("width must be a power of two")
    state_num = int(table.shape[0])

    if use_native is not False:
        from phfpfac_tpu_torch.compile import native

        if native.available():
            r, ht, val, st = native.ffdm_native(
                table, width, hashtable_max=hashtable_max
            )
            return PhfTable(
                r=r, ht=ht, val=val, width=width, ht_size=st["ht_size"],
                num_keys=st["num_keys"], max_key=st["max_key"],
                max_offset=st["max_offset"],
            )

    flat = np.ascontiguousarray(table, dtype=np.int32).ravel()
    keys = np.flatnonzero(flat >= 0).astype(np.int64)  # ascending
    next_states = flat[keys]
    num_keys = int(keys.size)
    max_key = int(keys[-1]) if num_keys else 0

    rows_of_keys = keys // width
    cols_of_keys = (keys % width).astype(np.int64)
    if num_keys and int(rows_of_keys[-1]) >= ROW_MAX:
        raise ValueError(f"Row > ROW_MAX({ROW_MAX})")  # phf.c:102-105

    dev_rows = (state_num * CHAR_SET) // width + 1
    r = np.full(dev_rows, -1, dtype=np.int32)

    # Group contiguous (keys ascending => rows nondecreasing).
    uniq_rows, first_idx, counts = np.unique(
        rows_of_keys, return_index=True, return_counts=True
    )
    # descending fullness, ties by ascending row number (stable)
    order = np.argsort(-counts, kind="stable")

    limit = hashtable_max  # offsets may use slots [0, hashtable_max)
    occ = np.zeros(limit + width, dtype=bool)  # pad to simplify windows
    ht = np.full(limit + width, -1, dtype=np.int32)
    val = np.full(limit + width, -1, dtype=np.int32)

    max_offset = 0
    max_slot = -1
    window = 4096
    for gi in order:
        row = int(uniq_rows[gi])
        lo = int(first_idx[gi])
        cnt = int(counts[gi])
        cols = cols_of_keys[lo : lo + cnt]  # ascending
        vals = next_states[lo : lo + cnt]
        base = -int(cols[0])
        # first-fit: smallest offset >= base with all slots free
        offset = None
        start = base
        max_off_excl = limit - width  # phf.c:188,224: offset < HASHTABLE_MAX-width
        while start < max_off_excl:
            L = min(window, max_off_excl - start)
            bad = np.zeros(L, dtype=bool)
            for c in cols:
                s = start + int(c)
                bad |= occ[s : s + L]
            free = np.flatnonzero(~bad)
            if free.size:
                offset = start + int(free[0])
                break
            start += L
        if offset is None:
            raise RuntimeError(
                f"failed to fit row {row} into the hash table; "
                "try increasing the hash table size"  # phf.c:224-228
            )
        slots = offset + cols
        occ[slots] = True
        ht[slots] = row
        val[slots] = vals
        r[row] = offset
        if offset > max_offset:
            max_offset = offset
        top = int(slots[-1])
        if top > max_slot:
            max_slot = top

    ht_size = max_slot + 1  # == reference scan at phf.c:232-236
    return PhfTable(
        r=r,
        ht=ht[:ht_size].copy(),
        val=val[:ht_size].copy(),
        width=width,
        ht_size=ht_size,
        num_keys=num_keys,
        max_key=max_key,
        max_offset=max_offset,
    )


def phf_lookup_host(phf: PhfTable, keys: np.ndarray) -> np.ndarray:
    """Host-side vectorized probe (test oracle for the device contract)."""
    keys = np.asarray(keys, dtype=np.int64)
    row = keys >> phf.width_bit
    col = keys & (phf.width - 1)
    row_ok = (row >= 0) & (row < len(phf.r))
    idx = np.where(row_ok, phf.r[np.clip(row, 0, len(phf.r) - 1)], -1) + col
    ok = row_ok & (idx >= 0) & (idx < phf.ht_size)
    idx_c = np.clip(idx, 0, max(phf.ht_size - 1, 0))
    ok &= phf.ht[idx_c] == row
    return np.where(ok, phf.val[idx_c], -1).astype(np.int32)
