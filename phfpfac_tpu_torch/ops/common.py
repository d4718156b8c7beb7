"""Shared helpers for the device scan engines."""

from __future__ import annotations

import numpy as np

from phfpfac_tpu_torch.utils.config import PfacConfig


STEP_BUCKET = 8


def padded_steps(max_pat_len: int) -> int:
    """Walk-step count rounded up so similar dictionaries share compiles."""
    return -(-max(max_pat_len, 1) // STEP_BUCKET) * STEP_BUCKET


def pad_input(data: bytes | np.ndarray, pad_to: int, extra: int) -> np.ndarray:
    """uint8 array of length ceil(len/pad_to)*pad_to + extra, zero padded.

    ``extra`` tail bytes let every walk read ``pos + t`` without bounds
    checks (the activity mask already kills walks past their limit, so
    padding bytes never influence results).  The reference does the
    same thing by over-allocating the device input buffer
    (master_kernel.cu:223).
    """
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)
    ) else np.asarray(data, dtype=np.uint8)
    n = len(arr)
    padded_len = -(-max(n, 1) // pad_to) * pad_to + extra
    out = np.zeros(padded_len, dtype=np.uint8)
    out[:n] = arr
    return out


def walk_limits(
    n_pad: int, input_size: int, max_pat_len: int, cfg: PfacConfig
) -> np.ndarray:
    """Per-position exclusive read limits (int32 [n_pad]).

    "segment" reproduces the reference's 4 KiB segment + halo truncation
    (master_kernel.cu:141-144); "none" allows every walk its full
    pattern length.
    """
    pos = np.arange(n_pad, dtype=np.int64)
    if cfg.truncation == "segment":
        seg_end = (pos // cfg.segment_bytes + 1) * cfg.segment_bytes
        lim = np.minimum(input_size, seg_end + cfg.halo_bytes)
    else:
        lim = np.minimum(input_size, pos + max_pat_len)
    return lim.astype(np.int32)
