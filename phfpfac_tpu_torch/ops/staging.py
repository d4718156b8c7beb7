"""Device staging of the scanned corpus (plain torch ops, no kernels).

The scan kernels read a (rows, 128) int32 view of the corpus, prepared
once per chunk on the device it is scanned on:

* ``stage_input``: one byte per position, PAD_CHAR (256, outside every
  table) past ``input_size`` — the depth kernel's format;
* ``stage_pairs``: one PAIR SYMBOL per position,
  ``code[i+1] << cb | code[i]`` over the dictionary's compacted
  alphabet, with the reserved miss code ``max(code_of)`` past
  ``input_size`` — the plan kernel's format.

Both carry one spare 8-row block past the last scan position
(``staged_rows``), so a walk may read ``pos + t`` for every step ``t``
without a bounds check.
"""

from __future__ import annotations

import numpy as np
import torch

LANE = 128
SUB = 8
TILE = SUB * LANE  # positions per staged 8-row block
PAD_CHAR = 256  # out-of-alphabet: misses every stored char and s0 bank


def staged_rows(n_pos: int) -> int:
    """Row count of the staged input for ``n_pos`` scan positions."""
    assert n_pos % TILE == 0
    return (n_pos // TILE) * SUB + SUB


def to_device_bytes(data, device) -> torch.Tensor:
    """A padded uint8 corpus (numpy array, bytes or tensor) on ``device``
    — one host-to-device copy when it is not there yet."""
    if isinstance(data, torch.Tensor):
        return data.to(device)
    if isinstance(data, (bytes, bytearray)):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    return torch.from_numpy(np.ascontiguousarray(data, np.uint8)).to(device)


def stage_input(data: torch.Tensor, input_size: int, *,
                n_rows: int) -> torch.Tensor:
    """uint8 stream -> (n_rows, 128) int32, PAD_CHAR past input_size."""
    L = n_rows * LANE
    flat = torch.full((L,), PAD_CHAR, dtype=torch.int32, device=data.device)
    n = min(data.shape[0], L)
    flat[:n] = data[:n].to(torch.int32)
    flat[input_size:] = PAD_CHAR
    return flat.reshape(n_rows, LANE)


def stage_pairs(data: torch.Tensor, input_size: int,
                code_of: torch.Tensor, *, n_rows: int,
                cb: int) -> torch.Tensor:
    """uint8 stream -> (n_rows, 128) int32 pair symbols."""
    L = n_rows * LANE
    miss_code = code_of.max()  # code_of maps unused bytes to sigma
    codes = torch.zeros(L + 1, dtype=torch.int32, device=data.device)
    n = min(data.shape[0], L)
    codes[:n] = code_of[data[:n].to(torch.int64)]
    codes[input_size:] = miss_code  # and the one code past the end
    # pair symbol = (second << CB) | first — see compile.pair
    return ((codes[1:] << cb) | codes[:-1]).reshape(n_rows, LANE)
