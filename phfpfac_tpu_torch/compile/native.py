"""ctypes bindings for the C++ host compiler (_native/pfac_native.cpp).

The reference's host-side hot paths — per-byte trie insertion
(create_table_reorder.c:315-375) and the FFDM first-fit search
(phf.c:184-229) — are native C there; here they are a small C++ library
built on demand with g++ and loaded via ctypes (no pybind11 in the
image).  ``available()`` gates use; the NumPy implementations remain
the portable fallback and the semantics oracle (tests/test_native.py
diffs every table byte-for-byte).

Set PHFPFAC_NO_NATIVE=1 to force the NumPy path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from phfpfac_tpu_torch.utils.config import CHAR_SET, HASHTABLE_MAX

_DIR = Path(__file__).parent / "_native"
_SRC = _DIR / "pfac_native.cpp"
_SO = _DIR / "libpfac_native.so"
_FP = _DIR / "libpfac_native.fp"  # build fingerprint sidecar

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def _fingerprint() -> str:
    """Source + toolchain + machine fingerprint: the .so is built with
    -march=native and must never be loaded on a different host/ISA or
    against different source (ADVICE r3 — mtime alone can't tell; the
    binary is untracked in git so checkouts never ship one)."""
    import hashlib
    import platform

    h = hashlib.sha256(_SRC.read_bytes())
    try:
        gxx = subprocess.run(
            ["g++", "--version"], capture_output=True, text=True
        ).stdout.splitlines()[0]
    except Exception:
        gxx = "no-g++"
    # CPU identity, not hostname: -march=native depends on the CPU
    # model/ISA; hostnames are ephemeral in containers and would force
    # spurious rebuilds on identical hardware (ADVICE r4)
    cpu = platform.processor() or ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    cpu += "|" + line.strip()
                    break
    except OSError:
        pass
    h.update(f"|{gxx}|{platform.machine()}|{cpu}".encode())
    return h.hexdigest()


def _build(fp: str) -> None:
    # Atomic publication (tmp + os.replace), because multiple fresh
    # processes may race to build the untracked .so concurrently
    # (multi-process CLI, bench + pytest): g++ writes a private tmp,
    # the rename is atomic, and the fingerprint is published only
    # after its .so — a racing reader at worst sees a valid .so with
    # a stale/missing fingerprint and harmlessly rebuilds.
    tmp_so = _SO.with_suffix(f".tmp{os.getpid()}")
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        "-std=c++17", str(_SRC), "-o", str(tmp_so),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    tmp_so.replace(_SO)
    tmp_fp = _FP.with_suffix(f".tmp{os.getpid()}")
    tmp_fp.write_text(fp)
    tmp_fp.replace(_FP)


def _load() -> ctypes.CDLL | None:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if os.environ.get("PHFPFAC_NO_NATIVE") == "1":
            _failed = True
            return None
        try:
            fp = _fingerprint()
            if not _SO.exists() or not _FP.exists() or \
                    _FP.read_text() != fp:
                _build(fp)
            lib = ctypes.CDLL(str(_SO))
            lib.pfac_build_trie.restype = ctypes.c_int64
            lib.pfac_build_trie.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.pfac_ffdm.restype = ctypes.c_int64
            lib.pfac_ffdm.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.pfac_minimize_levels.restype = ctypes.c_int64
            lib.pfac_minimize_levels.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.pfac_layout_distinct.restype = ctypes.c_int64
            lib.pfac_layout_distinct.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.pfac_decode_hits.restype = ctypes.c_int64
            lib.pfac_decode_hits.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,               # data, n
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # pos,hb,h
                ctypes.c_void_p, ctypes.c_int64,               # s0, k
                ctypes.c_void_p,                               # dense
                ctypes.c_void_p, ctypes.c_int64,               # r, r_len
                ctypes.c_void_p, ctypes.c_void_p,              # ht, val
                ctypes.c_int64, ctypes.c_int64,                # ht_size, wb
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.pfac_decode_hits_hash.restype = ctypes.c_int64
            lib.pfac_decode_hits_hash.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,               # data, n
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # pos,hb,h
                ctypes.c_void_p, ctypes.c_void_p,              # blob, off
                ctypes.c_void_p, ctypes.c_void_p,              # len, state
                ctypes.c_int64,                                # tsize_log2
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
            _lib = lib
        except Exception:  # noqa: BLE001 — fall back to NumPy
            _failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def build_trie_native(patterns: list[bytes]):
    """Native build_pfac_trie core; returns (table, state_num, max_pat_len).

    Caller provides the sorted pattern list.
    """
    lib = _load()
    assert lib is not None
    k = len(patterns)
    blob = np.frombuffer(b"".join(patterns), dtype=np.uint8)
    offsets = np.cumsum([0] + [len(p) for p in patterns]).astype(np.int64)
    cap = k + 2 + int(offsets[-1]) + 1
    table = np.full((cap, CHAR_SET), -1, dtype=np.int32)
    maxlen = np.zeros(1, dtype=np.int32)
    state_num = lib.pfac_build_trie(
        blob.ctypes.data if blob.size else None,
        offsets.ctypes.data,
        k,
        table.ctypes.data,
        cap,
        maxlen.ctypes.data,
    )
    if state_num == -2:
        raise ValueError("empty pattern")
    if state_num < 0:
        raise OverflowError("trie capacity overflow")
    return table[:state_num], int(state_num), int(maxlen[0])


def minimize_levels_native(
    dense: np.ndarray, levels: list[np.ndarray], nf: int
):
    """Native level-wise partition; returns (inv_by_level, rep_by_level).

    Class ids are in first-occurrence order (the NumPy path's are in
    signature-lexicographic order) — equivalent partitions.
    """
    lib = _load()
    assert lib is not None
    dense = np.ascontiguousarray(dense, dtype=np.int32)
    D = len(levels)
    blob = np.concatenate(
        [lv.astype(np.int64) for lv in levels]
    ) if D else np.empty(0, np.int64)
    blob = np.ascontiguousarray(blob)
    offs = np.zeros(D + 1, dtype=np.int64)
    np.cumsum([len(lv) for lv in levels], out=offs[1:])
    inv = np.empty(len(blob), dtype=np.int32)
    rep = np.empty(len(blob), dtype=np.int32)
    ncls = np.zeros(max(D, 1), dtype=np.int64)
    lib.pfac_minimize_levels(
        dense.ctypes.data, dense.shape[0], blob.ctypes.data,
        offs.ctypes.data, D, nf, inv.ctypes.data, rep.ctypes.data,
        ncls.ctypes.data,
    )
    inv_by_level = [
        inv[offs[li]:offs[li + 1]].astype(np.int64) for li in range(D)
    ]
    rep_by_level = [
        rep[offs[li]:offs[li] + ncls[li]].astype(np.int64)
        for li in range(D)
    ]
    return inv_by_level, rep_by_level


def layout_distinct_native(
    cols_offs: np.ndarray, cols_blob: np.ndarray, cap: int, *,
    colspan: int, force_offset: np.ndarray | None,
    side_offs: np.ndarray | None, side_blob: np.ndarray | None,
    empty: int, side_alias_mask: int = 0, side_span: int = 0,
    priority: np.ndarray | None = None,
):
    """Native distinct-offset first-fit layout (CSR form).

    ``side_alias_mask`` > 0 enables the anti-aliasing constraints for
    compact side-table verification (side entries store only
    (code & mask) + 1; see pfac_native.cpp).

    Returns (offsets int64 [n], ht_len) or None on capacity overflow
    (caller doubles cap and retries).
    """
    lib = _load()
    assert lib is not None
    n = len(cols_offs) - 1
    cols_offs = np.ascontiguousarray(cols_offs, dtype=np.int64)
    cols_blob = np.ascontiguousarray(cols_blob, dtype=np.int64)
    if side_blob is None:
        side_offs = np.zeros(n + 1, dtype=np.int64)
        side_blob = np.empty(0, dtype=np.int64)
    else:
        side_offs = np.ascontiguousarray(side_offs, dtype=np.int64)
        side_blob = np.ascontiguousarray(side_blob, dtype=np.int64)
    force_p = None
    if force_offset is not None:
        force_arr = np.ascontiguousarray(force_offset, dtype=np.uint8)
        force_p = force_arr.ctypes.data
    prio_p = None
    if priority is not None:
        prio_arr = np.ascontiguousarray(priority, dtype=np.int64)
        prio_p = prio_arr.ctypes.data
    out = np.empty(n, dtype=np.int64)
    ht_len = lib.pfac_layout_distinct(
        cols_blob.ctypes.data, cols_offs.ctypes.data,
        side_blob.ctypes.data if len(side_blob) else side_offs.ctypes.data,
        side_offs.ctypes.data, n, force_p, colspan, cap, empty,
        side_alias_mask, side_span or colspan, prio_p, out.ctypes.data,
    )
    if ht_len < 0:
        return None
    return out, int(ht_len)


def ffdm_native(table: np.ndarray, width: int, hashtable_max: int = HASHTABLE_MAX):
    """Native FFDM; returns (r, ht, val, stats dict)."""
    lib = _load()
    assert lib is not None
    table = np.ascontiguousarray(table, dtype=np.int32)
    state_num = table.shape[0]
    r_len = (state_num * CHAR_SET) // width + 1
    r = np.empty(r_len, dtype=np.int32)
    ht = np.full(hashtable_max, -1, dtype=np.int32)
    val = np.full(hashtable_max, -1, dtype=np.int32)
    stats = np.zeros(4, dtype=np.int64)
    ht_size = lib.pfac_ffdm(
        table.ctypes.data, state_num, width,
        r.ctypes.data, r_len, ht.ctypes.data, val.ctypes.data,
        hashtable_max, stats.ctypes.data,
    )
    if ht_size < 0:
        raise RuntimeError(
            "failed to fit row into the hash table; "
            "try increasing the hash table size"
        )
    return (
        r,
        ht[:ht_size].copy(),
        val[:ht_size].copy(),
        {
            "num_keys": int(stats[0]),
            "max_key": int(stats[1]),
            "max_offset": int(stats[2]),
            "ht_size": int(stats[3]),
        },
    )


_FNV_OFF = 1469598103934665603
_FNV_PRIME = 1099511628211


def _pattern_hash(shard):
    """Open-addressed substring->final-state table for the hash
    decode, built once per shard and cached on it.

    Bit t at position p means data[p..p+t] IS one of this shard's
    patterns (a PFAC final at depth t+1 exists along the path iff the
    substring equals a pattern), so decode needs no trie walk at all —
    one table probe per set bit.  Slot values are the pattern's final
    state from a real dense-trie walk, keeping the output triples
    byte-identical to the walk decode regardless of numbering."""
    cached = getattr(shard, "_decode_hash", None)
    if cached is not None:
        return cached
    pats = shard.patterns
    dense = np.asarray(shard.dense_table())
    s0 = np.asarray(shard.s0)
    # final state per pattern: vectorized walk, grouped by length
    n_pats = len(pats)
    states = np.empty(n_pats, dtype=np.int64)
    hashes = np.empty(n_pats, dtype=np.uint64)
    prime = np.uint64(_FNV_PRIME)
    by_len: dict = {}
    for i, w in enumerate(pats):
        by_len.setdefault(len(w), []).append(i)
    for L, idxs in by_len.items():
        mat = np.frombuffer(
            b"".join(pats[i] for i in idxs), dtype=np.uint8
        ).reshape(len(idxs), L)
        st = s0[mat[:, 0]].astype(np.int64)
        for t in range(1, L):
            st = dense[st, mat[:, t]].astype(np.int64)
        states[idxs] = st
        # FNV-1a, vectorized per length group (uint64 wraps mod 2^64);
        # must match the byte loop in pfac_decode_hits_hash
        h = np.full(len(idxs), _FNV_OFF, dtype=np.uint64)
        for t in range(L):
            h = (h ^ mat[:, t].astype(np.uint64)) * prime
        hashes[idxs] = h
    tsize = 8
    while tsize < 2 * n_pats:
        tsize <<= 1
    mask = tsize - 1
    slot_off = np.full(tsize, -1, dtype=np.int64)
    slot_len = np.zeros(tsize, dtype=np.int32)
    slot_state = np.zeros(tsize, dtype=np.int32)
    blob_parts, off = [], 0
    for i, w in enumerate(pats):
        slot = int(hashes[i]) & mask
        while slot_off[slot] >= 0:
            slot = (slot + 1) & mask
        slot_off[slot] = off
        slot_len[slot] = len(w)
        slot_state[slot] = states[i]
        blob_parts.append(w)
        off += len(w)
    blob = np.frombuffer(b"".join(blob_parts), dtype=np.uint8)
    cached = (blob, slot_off, slot_len, slot_state,
              int(tsize).bit_length() - 1)
    shard._decode_hash = cached
    return cached


def decode_hits_hash_native(
    hb: np.ndarray, hit_pos: np.ndarray, data: np.ndarray, shard,
    max_t: int, n_threads: int = 0,
) -> np.ndarray:
    """Hash-probe bitmap decode (plain-dictionary shards only; see
    _pattern_hash).  Same contract as decode_hits_native."""
    lib = _load()
    assert lib is not None
    blob, slot_off, slot_len, slot_state, tlog2 = _pattern_hash(shard)
    hb = np.ascontiguousarray(hb, dtype=np.uint32)
    hit_pos = np.ascontiguousarray(hit_pos, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    cap = int(np.bitwise_count(hb).sum()) if hb.size else 0
    out = np.empty(cap * 3, dtype=np.int64)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    wrote = lib.pfac_decode_hits_hash(
        data.ctypes.data, len(data),
        hit_pos.ctypes.data, hb.ctypes.data, len(hb),
        blob.ctypes.data, slot_off.ctypes.data,
        slot_len.ctypes.data, slot_state.ctypes.data,
        tlog2, max_t, n_threads, out.ctypes.data if cap else None,
    )
    return out[: wrote * 3].reshape(-1, 3)


def decode_hits_native(
    hb: np.ndarray, hit_pos: np.ndarray, data: np.ndarray, shard,
    max_t: int, n_threads: int = 0,
) -> np.ndarray:
    """Native bitmap decode (see _native pfac_decode_hits and the NumPy
    reference in ops/bitmap.decode_hits).  Returns int64 [(pos, t,
    shard-local state)] in (pos, t) order."""
    lib = _load()
    assert lib is not None
    hb = np.ascontiguousarray(hb, dtype=np.uint32)
    hit_pos = np.ascontiguousarray(hit_pos, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    s0 = np.ascontiguousarray(shard.s0, dtype=np.int32)
    cap = int(np.bitwise_count(hb).sum()) if hb.size else 0
    out = np.empty(cap * 3, dtype=np.int64)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    if shard.has_phf:
        r = np.ascontiguousarray(shard.r, dtype=np.int32)
        ht = np.ascontiguousarray(shard.ht, dtype=np.int32)
        val = np.ascontiguousarray(shard.val, dtype=np.int32)
        wrote = lib.pfac_decode_hits(
            data.ctypes.data, len(data),
            hit_pos.ctypes.data, hb.ctypes.data, len(hb),
            s0.ctypes.data, shard.final_state_num,
            None,
            r.ctypes.data, len(r), ht.ctypes.data, val.ctypes.data,
            len(ht), shard.width_bit,
            max_t, n_threads, out.ctypes.data if cap else None,
        )
    else:
        dense = np.ascontiguousarray(shard.dense_table(), dtype=np.int32)
        wrote = lib.pfac_decode_hits(
            data.ctypes.data, len(data),
            hit_pos.ctypes.data, hb.ctypes.data, len(hb),
            s0.ctypes.data, shard.final_state_num,
            dense.ctypes.data,
            None, 0, None, None, 0, 1,
            max_t, n_threads, out.ctypes.data if cap else None,
        )
    return out[: wrote * 3].reshape(-1, 3)
