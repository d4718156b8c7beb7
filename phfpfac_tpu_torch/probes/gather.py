"""Dependent-gather probe (P1): chains of table loads whose addresses
are the previous loads' values, the scan kernels' inner operation.

Replaces the Pallas TPU probes ``bench/lane_probe.py`` (``probe_fn``,
``alu_fn``), ``bench/ilp_probe.py``, ``bench/micro_tpu.py`` (the gather,
ILP and probe-loop kernels) and ``bench/lane_iso.py``; see
``csrc/probe_gather.cu``.  Each of ``n`` walkers takes ``reps`` steps

    idx = (idx + table[idx & (T - 1)] + (r + 1)) * mul      (mod 2**32)

over a table of ``T`` entries (a power of two) of the arm's type:

=========  =============================================================
``i32``    int32 entries
``i16``    int16 entries, sign-extended
``i8``     int8 entries, sign-extended
``packed`` two unsigned 16-bit entries per int32 word (word ``v >> 1``,
           half ``v & 1``): ``T`` entries in ``T // 2`` words
``alu``    no table: ``a = v + (r + 1); b = a ^ v; v = a if b > 0 else b``
=========  =============================================================

``mul = 1`` is ``lane_probe``'s recurrence; ``SCATTER``, an odd
multiplier, spreads a narrow type's chain over the whole table.
``probe_gather`` launches the kernel for a CUDA tensor and runs
``probe_gather_plain`` for a CPU tensor; ``k`` (independent walkers a
thread interleaves) shapes the kernel's schedule only, never the result.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

ARMS = ("i32", "i16", "i8", "packed", "alu")
KS = (1, 2, 4, 8)
SCATTER = 0x9E3779B1  # odd: a bijection of the 32-bit indices
_DTYPES = {"i32": torch.int32, "i16": torch.int16, "i8": torch.int8,
           "packed": torch.int32}

launches = 0  # CUDA kernel launches (the CPU plain path never counts)


def entry_bytes(arm: str) -> float:
    """Bytes of table per entry (``packed``: 2)."""
    return {"i32": 4, "i16": 2, "i8": 1, "packed": 2, "alu": 0}[arm]


def make_table(rng: np.random.Generator, arm: str, entries: int):
    """A random table of ``entries`` entries for ``arm`` (numpy; None
    for ``alu``): values over the whole index range where the type holds
    it, else over the type's non-negative range."""
    if arm == "alu":
        return None
    if arm == "packed":
        halves = rng.integers(0, 1 << 16, entries, dtype=np.uint32)
        return (halves[0::2] | (halves[1::2] << 16)).view(np.int32)
    npdt = {"i32": np.int32, "i16": np.int16, "i8": np.int8}[arm]
    hi = min(entries, np.iinfo(npdt).max)
    return rng.integers(0, hi, entries).astype(npdt)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced mod 2**32 into int32's range."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _check(table, idx, arm, k, reps):
    if arm not in ARMS:
        raise ValueError(f"arm must be one of {ARMS}, got {arm!r}")
    if k not in KS:
        raise ValueError(f"k must be one of {KS}, got {k}")
    if reps < 0:
        raise ValueError("reps must not be negative")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("idx: need a contiguous 1-D int32 tensor")
    if idx.numel() % k:
        raise ValueError(f"{idx.numel()} walkers do not divide by k={k}")
    if arm == "alu":
        return 0
    if table is None or table.dtype != _DTYPES[arm] or table.dim() != 1 \
            or not table.is_contiguous() or table.device != idx.device:
        raise ValueError(
            f"table: need a contiguous 1-D {_DTYPES[arm]} tensor on "
            f"{idx.device} for arm {arm!r}")
    entries = table.numel() * (2 if arm == "packed" else 1)
    if entries <= 0 or entries & (entries - 1):
        raise ValueError("the table's entry count must be a power of two")
    return entries


def probe_gather_plain(table, idx: torch.Tensor, *, arm: str, reps: int,
                       k: int = 1, mul: int = 1) -> torch.Tensor:
    """``reps`` torch indexing steps on the same tensors, in int64 with
    the kernel's 32-bit wraparound."""
    entries = _check(table, idx, arm, k, reps)
    v = idx.to(torch.int64)
    for r in range(reps):
        if arm == "alu":
            a = _wrap32(v + (r + 1))
            b = a ^ v
            v = torch.where(b > 0, a, b)
            continue
        at = v & (entries - 1)
        if arm == "packed":
            w = table[at >> 1].to(torch.int64) & 0xFFFFFFFF
            g = (w >> ((at & 1) << 4)) & 0xFFFF
        else:
            g = table[at].to(torch.int64)
        v = _wrap32((v + g + (r + 1)) * mul)
    return v.to(torch.int32)


def _lib():
    from phfpfac_tpu_torch import _build

    lib = _build.load("probe_gather")
    if lib.probe_gather.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.probe_gather.argtypes = [p, ctypes.c_longlong, i, i, p, p, i, i,
                                     ctypes.c_uint, p]
        lib.probe_gather.restype = i
    return lib


def probe_gather(table, idx: torch.Tensor, *, arm: str, reps: int,
                 k: int = 1, mul: int = 1) -> torch.Tensor:
    """Every walker's final index, int32 [n]."""
    if idx.device.type == "cpu":
        return probe_gather_plain(table, idx, arm=arm, reps=reps, k=k,
                                  mul=mul)
    if idx.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {idx.device}")
    global launches
    entries = _check(table, idx, arm, k, reps)
    out = torch.empty_like(idx)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = _lib().probe_gather(
            None if table is None else table.data_ptr(), entries,
            ARMS.index(arm), k, idx.data_ptr(), out.data_ptr(), idx.numel(),
            reps, mul & 0xFFFFFFFF, stream)
    if err:
        raise RuntimeError(f"probe_gather launch failed: CUDA error {err}")
    launches += 1
    return out


SWEEP_TABLE_BYTES = (4 << 10, 16 << 10, 64 << 10, 256 << 10, 512 << 10,
                     1 << 20, 4 << 20, 32 << 20,
                     256 << 20)  # L1, L2 (50 MB) and device memory
SWEEP_WALKERS = 16 << 20  # one per position of a 16 MiB chunk


def expect_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """A sweep's default ``check``: the kernel's output is its plain
    version's, or the sweep ends."""
    if not torch.equal(got, want):
        raise RuntimeError(f"{what}: kernel != plain version")


def sweep(device="cuda", *, walkers: int = SWEEP_WALKERS,
          table_bytes=SWEEP_TABLE_BYTES, arms=ARMS, ks=KS, reps: int = 8,
          mul: int = SCATTER, seed: int = 0, timed: int = 3,
          check=expect_equal):
    """Time the probe kernel per arm, ``k`` and table size; yields one
    dict each.  ``lane_probe``'s protocol: ``reps`` against ``2 * reps``
    steps, differenced, so that launch, load and store cancel; CUDA-event
    means over ``timed`` launches.  ``gathers_per_s`` counts one step of
    one walker (for ``alu``: one add-xor-select), ``ns_per_gather`` is
    its inverse: the card's time per link of a chain at full
    occupancy, not one load's latency.  Every shape that is timed is
    first held to the plain version at ``2 * reps`` steps, all walkers:
    ``check(got, want, what)`` (a rate from a wrong walk is no rate)."""
    from phfpfac_tpu_torch import probes
    from phfpfac_tpu_torch.utils.profile import cuda_ms

    dev = probes.need_card(device)
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(
        rng.integers(0, 1 << 31, walkers, dtype=np.int64).astype(np.int32)
    ).to(dev)
    for arm in arms:
        sizes = (0,) if arm == "alu" else table_bytes
        for nbytes in sizes:
            entries = int(nbytes / entry_bytes(arm)) if nbytes else 0
            host = make_table(rng, arm, entries)
            table = None if host is None else torch.from_numpy(host).to(dev)
            want = probe_gather_plain(table, idx, arm=arm, reps=2 * reps,
                                      mul=mul)
            for k in ks:
                check(probe_gather(table, idx, arm=arm, reps=2 * reps, k=k,
                                   mul=mul), want,
                      f"probe_gather {arm} k={k} table {nbytes} B, "
                      f"{walkers} walkers")

                def run(r):
                    return cuda_ms(lambda: probe_gather(
                        table, idx, arm=arm, reps=r, k=k, mul=mul), timed)

                ms1, ms2 = run(reps), run(2 * reps)
                step_s = (ms2 - ms1) / reps / 1e3
                yield dict(arm=arm, k=k, table_bytes=nbytes, entries=entries,
                           walkers=walkers, reps=reps, ms=ms1, ms_2x=ms2,
                           gathers_per_s=walkers / step_s,
                           ns_per_gather=step_s / walkers * 1e9)
            del table, want
