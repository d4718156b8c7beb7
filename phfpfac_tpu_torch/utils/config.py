"""Configuration for the PFAC engine.

The reference hardcodes everything at compile time (BLOCK_SIZE /
PAGE_SIZE_I / EXTRA_SIZE_PER_TB in master_kernel.cu:8-11, ROW_MAX /
COL_MAX / HASHTABLE_MAX in PHF/phf.c:7-10, GPU count in
CreateTable/create_table_reorder.c:207) and takes only four positional
CLI args (main.cc:93-96).  Here every knob is an explicit config field.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

# Alphabet size (reference: CHAR_SET, CreateTable/ctdef.h:9).
CHAR_SET = 256

# Reference segment geometry (master_kernel.cu:8-11):
#   BLOCK_SIZE=512 threads, PAGE_SIZE_C=4096 bytes per block,
#   EXTRA_SIZE_PER_TB=128 ints = 512 bytes of halo.
REF_SEGMENT_BYTES = 4096
REF_HALO_BYTES = 512

# Reference PHF capacity limits (PHF/phf.c:7-10).
ROW_MAX = 1 << 20
COL_MAX = 4096
HASHTABLE_MAX = 163840 * 20

# Reference pattern-length cap (CreateTable/create_table_reorder.c:74-77).
MAX_PATTERN_LEN = 1024


@dataclasses.dataclass(frozen=True)
class PfacConfig:
    """End-to-end engine configuration.

    Attributes:
      width: PHF key-table width (reference CLI arg 3, must be a power
        of two <= COL_MAX; the kernel splits keys into row = key >>
        width_bit, col = key & (width-1), master_kernel.cu:52-54).
      num_shards: number of dictionary shards.  The reference uses
        GPU_S(=4) * streamnum shards (create_table_reorder.c:207,217);
        the CLI reproduces that, the library lets the mesh decide.
      truncation: walk-length semantics.
        * "segment": reference-compatible — a walk may read up to the
          end of its 4 KiB segment plus a fixed halo
          (master_kernel.cu:141-144); matches longer than
          segment_end+halo-start are silently dropped.
        * "none": exact semantics — every walk may run to
          min(input_size, start + max_pat_len).  Identical results
          whenever max_pat_len <= halo + 1.
      segment_bytes / halo_bytes: geometry for "segment" truncation.
      match_slots: per-position match-slot count for the compact device
        output layout.  The reference allocates max_pat_len slots per
        position (master_kernel.cu:235); on TPU that is HBM-hostile for
        long patterns, so the kernel emits into a fixed number of slots
        (a walk from one offset can produce at most one match per
        distinct prefix-closed pattern length, which for real rulesets
        is tiny).  Set to 0 to derive max_pat_len slots (full parity
        layout).
      emit_mode: "matches" records pattern ids per slot; "count"
        records only per-position match counts (benchmark mode).
      interpret: run Pallas kernels in interpreter mode (CPU testing).
    """

    width: int = 4096
    num_shards: int = 1
    truncation: Literal["segment", "none"] = "none"
    segment_bytes: int = REF_SEGMENT_BYTES
    halo_bytes: int = REF_HALO_BYTES
    match_slots: int = 16
    emit_mode: Literal["matches", "count"] = "matches"
    interpret: bool = False

    def __post_init__(self) -> None:
        if self.width <= 0 or (self.width & (self.width - 1)) != 0:
            raise ValueError(f"width must be a power of two, got {self.width}")
        if self.width > COL_MAX:
            raise ValueError(f"width may not exceed {COL_MAX} (phf.c:161-164)")
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if self.segment_bytes <= 0 or self.halo_bytes < 0:
            raise ValueError("bad segment geometry")

    @property
    def width_bit(self) -> int:
        """log2(width) (reference computes it at master_kernel.cu:397-398)."""
        return self.width.bit_length() - 1
