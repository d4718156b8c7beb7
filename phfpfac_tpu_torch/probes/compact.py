"""In-kernel compaction probe (P2): packing a block's live walkers
inside the kernel, against a copy-only kernel with the same reads and
writes.

Replaces the Pallas TPU probe ``bench/pack_probe.py``; see
``csrc/probe_compact.cu``.  A tile is ``TILE`` consecutive int32
displacements; a lane is live when its displacement is not 0.  A lane
carries ``m`` payload planes (the displacement and ``m - 1`` copies of
the tile shifted left by 1..m-1 lanes, zeros shifted in), folded with
xor into the one value written.

* ``probe_copy`` -> (out, counts): the folded values in place;
  ``counts[tile]`` = the tile's first displacement.
* ``probe_compact`` -> (out, counts): per tile the live lanes' folded
  values in lane order, zeros behind them; ``counts[tile]`` = its live
  lanes.  For ``m = 1`` that is ``tile[tile != 0]`` padded with zeros.
* ``probe_compact_atomic`` -> (out, count): the live lanes' folded
  values appended to one buffer, ordered inside a tile, tiles in no
  order on the card; ``count`` = all live lanes, int32 [1].

Each launches its kernel for a CUDA tensor and runs its ``*_plain``
version for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

TILE = 1024
MAX_PLANES = 8

launches = 0  # CUDA launches of probe_compact (the packing kernel)
launches_copy = 0
launches_atomic = 0


def _check(disp: torch.Tensor, m: int) -> None:
    if disp.dtype != torch.int32 or disp.dim() != 1 \
            or not disp.is_contiguous() or disp.numel() % TILE:
        raise ValueError(f"disp: need a contiguous 1-D int32 tensor of a "
                         f"multiple of {TILE} lanes")
    if not 1 <= m <= MAX_PLANES:
        raise ValueError(f"m must be 1..{MAX_PLANES}, got {m}")


def fold_planes(disp: torch.Tensor, m: int) -> torch.Tensor:
    """int32 [tiles, TILE]: xor of the tile and its m - 1 left shifts."""
    tiles = disp.reshape(-1, TILE)
    fold = tiles.clone()
    for j in range(1, m):
        fold[:, :TILE - j] ^= tiles[:, j:]
    return fold


def probe_copy_plain(disp: torch.Tensor, m: int = 1):
    _check(disp, m)
    return fold_planes(disp, m).reshape(-1), disp[::TILE].clone()


def probe_compact_plain(disp: torch.Tensor, m: int = 1):
    """A stable sort of each tile by deadness: live lanes first, in lane
    order."""
    _check(disp, m)
    tiles = disp.reshape(-1, TILE)
    live = tiles != 0
    order = torch.sort((~live).to(torch.int8), dim=1, stable=True).indices
    fold = torch.where(live, fold_planes(disp, m), 0)
    return (torch.gather(fold, 1, order).reshape(-1),
            live.sum(dim=1).to(torch.int32))


def probe_compact_atomic_plain(disp: torch.Tensor, m: int = 1):
    _check(disp, m)
    live = disp != 0
    out = torch.zeros_like(disp)
    n = int(live.sum())
    out[:n] = fold_planes(disp, m).reshape(-1)[live]
    return out, torch.tensor([n], dtype=torch.int32, device=disp.device)


def _lib():
    from phfpfac_tpu_torch import _build

    lib = _build.load("probe_compact")
    if lib.probe_compact.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.probe_copy, lib.probe_compact,
                   lib.probe_compact_atomic):
            fn.argtypes = [p, i, i, p, p, p]
            fn.restype = i
    return lib


def _launch(name: str, disp: torch.Tensor, m: int, n_counts: int,
            alloc=torch.empty):
    """Launch entry ``name`` of the library over ``disp``: (out, counts),
    ``counts`` int32 [n_counts] made with ``alloc``."""
    if disp.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {disp.device}")
    _check(disp, m)
    out = torch.empty_like(disp)
    counts = alloc(n_counts, dtype=torch.int32, device=disp.device)
    with torch.cuda.device(disp.device):
        stream = torch.cuda.current_stream(disp.device).cuda_stream
        err = getattr(_lib(), name)(disp.data_ptr(), disp.numel(), m,
                                    out.data_ptr(), counts.data_ptr(),
                                    stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out, counts


def probe_copy(disp: torch.Tensor, m: int = 1):
    global launches_copy
    if disp.device.type == "cpu":
        return probe_copy_plain(disp, m)
    res = _launch("probe_copy", disp, m, disp.numel() // TILE)
    launches_copy += 1
    return res


def probe_compact(disp: torch.Tensor, m: int = 1):
    global launches
    if disp.device.type == "cpu":
        return probe_compact_plain(disp, m)
    res = _launch("probe_compact", disp, m, disp.numel() // TILE)
    launches += 1
    return res


def probe_compact_atomic(disp: torch.Tensor, m: int = 1):
    """The buffer past ``count`` entries is not written on the card."""
    global launches_atomic
    if disp.device.type == "cpu":
        return probe_compact_atomic_plain(disp, m)
    res = _launch("probe_compact_atomic", disp, m, 1, torch.zeros)
    launches_atomic += 1
    return res


SWEEP_LANES = 32 << 20  # pack_probe's --mib 32 positions
SWEEP_DENSITY = 0.04
SWEEP_PLANES = (1, 2, 6)


def make_disp(rng, lanes: int, density: float = SWEEP_DENSITY):
    """pack_probe's input (numpy int32): ``density`` of the lanes live,
    with displacements in [1, 8192)."""
    return np.where(rng.random(lanes) < density,
                    rng.integers(1, 1 << 13, lanes), 0).astype(np.int32)


def expect_equal(got, want, what: str) -> None:
    """A sweep's default ``check``: the kernel's outputs are its plain
    version's, or the sweep ends."""
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"{what}: kernel != plain version")


def sorted_live(out: torch.Tensor, count: torch.Tensor):
    """The atomic pack's result with its tiles' order taken out: the
    ``count`` values sorted, and the count."""
    return [torch.sort(out[:int(count)]).values, count]


def sweep(device="cuda", *, lanes: int = SWEEP_LANES,
          density: float = SWEEP_DENSITY, planes=SWEEP_PLANES,
          seed: int = 7, timed: int = 5, check=expect_equal):
    """CUDA-event ms of the copy-only kernel, the in-block pack and the
    global atomic pack per plane count, and of the two PyTorch calls
    that compute a compaction of the same input (``torch.nonzero``,
    boolean indexing); yields one dict per plane count.  Each kernel is
    first held to its plain version on the input it is timed on:
    ``check(got, want, what)``, the atomic pack as a sorted multiset."""
    from phfpfac_tpu_torch import probes
    from phfpfac_tpu_torch.utils.profile import cuda_ms

    dev = probes.need_card(device)
    disp = torch.from_numpy(
        make_disp(np.random.default_rng(seed), lanes, density)).to(dev)
    nonzero_ms = cuda_ms(lambda: torch.nonzero(disp), timed)
    masked_ms = cuda_ms(lambda: disp[disp != 0], timed)
    for m in planes:
        at = f"m={m}, {lanes} lanes"
        check(probe_copy(disp, m), probe_copy_plain(disp, m),
              f"probe_copy {at}")
        check(probe_compact(disp, m), probe_compact_plain(disp, m),
              f"probe_compact {at}")
        check(sorted_live(*probe_compact_atomic(disp, m)),
              sorted_live(*probe_compact_atomic_plain(disp, m)),
              f"probe_compact_atomic {at}")
        copy_ms = cuda_ms(lambda: probe_copy(disp, m), timed)
        pack_ms = cuda_ms(lambda: probe_compact(disp, m), timed)
        atomic_ms = cuda_ms(lambda: probe_compact_atomic(disp, m), timed)
        yield dict(planes=m, lanes=lanes, density=density, copy_ms=copy_ms,
                   compact_ms=pack_ms, compact_only_ms=pack_ms - copy_ms,
                   compact_atomic_ms=atomic_ms,
                   torch_nonzero_ms=nonzero_ms,
                   torch_masked_select_ms=masked_ms)
