"""Single-device matcher orchestration.

Each dictionary shard scans the full input and the results merge
shard-major (the reference's per-shard dispatch loop,
main.cc:225-241).  Engines:

* ``pallas`` — the hand-written kernels.  Per shard the fastest bitmap
  kernel that accepts it runs: the plan kernel (ops.plan), in exact mode
  the pair kernel (ops.pair), else the depth kernel (ops.depth).  Shards
  with patterns longer than the 32-step bitmap split: the short part
  rides the same kernels, a tail of at most 8 long patterns goes to a
  host literal search, a larger tail to the turbo engine.  A shard no
  bitmap kernel takes scans with the turbo engine; when none does for
  any shard, every shard rides one launch of the banked-PHF multi kernel
  (ops.scan), or the turbo engine past its 32 steps.
* ``turbo`` — the torch-op table walk with compaction (ops.turbo), the
  dense engine on compaction overflow.
* ``jnp``   — the dense torch-op walk with match rows (ops.reference).

Routing between engines is by dictionary: a table build refuses a shard
with ``DepthUnsupported`` / ``PairUnsupported`` / ``PhfUnsupported``.
Any other error is a fault and propagates.

``match_chunked`` scans a large input in pipelined chunks; with
``device_data=stage_for_chunked(data)`` the corpus is uploaded once and
each chunk's window is a view of it on the device.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from phfpfac_tpu_torch.compile.depth import DepthUnsupported
from phfpfac_tpu_torch.compile.tables import CompiledDictionary
from phfpfac_tpu_torch.ops.bitmap import (
    decode_bitmap,
    decode_hits,
    fetch_hit_bits,
    hash_decodes,
)
from phfpfac_tpu_torch.ops.common import (
    pad_input,
    padded_steps,
    resolve_device,
    walk_limits,
)
from phfpfac_tpu_torch.ops.depth import DepthShardScanner
from phfpfac_tpu_torch.ops.pair import PairShardScanner
from phfpfac_tpu_torch.ops.plan import PlanShardScanner
from phfpfac_tpu_torch.ops.reference import scan_shard
from phfpfac_tpu_torch.ops.scan import (
    MAX_BITMAP_STEPS,
    MultiShardScanner,
    PhfUnsupported,
)
from phfpfac_tpu_torch.ops.staging import to_device_bytes
from phfpfac_tpu_torch.ops.turbo import (
    build_turbo_tables,
    expand_turbo_matches,
    scan_shard_turbo,
)
from phfpfac_tpu_torch.parallel.merge import (
    merge_flat_matches,
    merge_match_rows,
    render_result_file,
)
from phfpfac_tpu_torch.utils.config import PfacConfig
from phfpfac_tpu_torch.utils.profile import count, span
from phfpfac_tpu_torch.utils.timing import PhaseTimer

_POS_PAD = 1024  # position-count padding granularity
_HOST_TAIL_MAX = 8  # long-pattern tails up to this size search on the host


def _dense_slots(shard) -> int:
    """Match-row slots for the exact dense fallback.

    A walk emits at most one match per DISTINCT pattern length (the
    matches at a position form a prefix chain), so slots need not be
    max_pat_len — keeps the [n_pos, slots] buffer bounded on
    long-pattern dictionaries."""
    if shard.patterns:
        return max(len({len(p) for p in shard.patterns}), 1)
    return max(shard.max_pat_len, 1)


class Matcher:
    """Scans inputs against a compiled dictionary on one device.

    ``engine`` defaults to ``"pallas"``, the hand-written kernels (the
    CLI's default too)."""

    def __init__(
        self,
        compiled: CompiledDictionary,
        config: PfacConfig,
        *,
        engine: Literal["jnp", "turbo", "pallas"] = "pallas",
        device=None,
        timer: PhaseTimer | None = None,
        turbo_full_steps: int = 2,
        turbo_cap_frac: int = 8,
        train: bytes | None = None,
    ):
        if engine not in ("jnp", "turbo", "pallas"):
            raise ValueError(f"unknown engine {engine!r}")
        self.compiled = compiled
        self.config = config
        self.engine = engine
        self.device = resolve_device(device)
        self.timer = timer or PhaseTimer()
        self.turbo_full_steps = turbo_full_steps
        self.turbo_cap_frac = turbo_cap_frac
        self._turbo_tables = None
        self._scanners = None
        self._solo_turbo = {}  # shard idx -> turbo tables (mixed path)
        self._train = train  # profile corpus (None = first input head)

    def _get_turbo_tables(self):
        if self._turbo_tables is None:
            self._turbo_tables = [
                build_turbo_tables(sh) for sh in self.compiled.shards
            ]
        return self._turbo_tables

    def _host_literal_one(self, data, input_size: int, pats_fids):
        """Flat (pos, step, local-state) matches of a TINY literal
        tail via host search (the split path's >32 B patterns; see
        _split_long_shard).  Respects segment truncation: a match
        starting in segment S may extend only to end(S) + halo
        (master_kernel.cu:141-144), exactly like the device walks."""
        seg = (
            self.config.segment_bytes
            if self.config.truncation == "segment" else 0
        )
        halo = self.config.halo_bytes
        buf = bytes(data)
        rows = []
        for pat, fid in pats_fids:
            L = len(pat)
            start = 0
            while True:
                i = buf.find(pat, start, input_size)
                if i < 0:
                    break
                start = i + 1
                if seg and i + L > (i // seg + 1) * seg + halo:
                    continue  # walk would be cut before completing
                rows.append((i, L - 1, fid))
        if not rows:
            return np.empty((0, 3), dtype=np.int64)
        return np.asarray(sorted(rows), dtype=np.int64)

    # ---- torch-op engines ----------------------------------------------

    def _flat_turbo_one(self, shard, tt, padded, input_size: int):
        """Flat (pos, step, local-state) matches of ONE shard via the
        turbo engine, with the dense engine's exact answer on compaction
        overflow.  The scan's row buffers are dropped on return, before
        the next shard's are made."""
        max_steps = padded_steps(self.compiled.max_pat_len)
        res = scan_shard_turbo(
            shard, padded, input_size, self.config,
            max_steps=max_steps, full_steps=self.turbo_full_steps,
            cap_frac=self.turbo_cap_frac, turbo_tables=tt,
            device=self.device,
        )
        tail_t0 = min(self.turbo_full_steps + 1, max_steps)
        try:
            return expand_turbo_matches(res, input_size, tail_t0)
        except OverflowError:
            # adversarial survivor count: dense fallback, exact
            rows = self._dense_rows_one_shard(shard, padded, input_size)
            p, j = np.nonzero(rows >= 0)
            return np.stack([p, j, rows[p, j]], axis=1).astype(np.int64)

    def _dispatch_flat_turbo(self, data: bytes, input_size: int) -> list:
        """Per-shard resolvers of the turbo engine.  A shard's scan is
        enqueued when its resolver runs, not before: its row buffers
        (about 4 B x (full_steps + 1) per position) are freed before the
        next shard's are made."""
        max_steps = padded_steps(self.compiled.max_pat_len)
        padded = to_device_bytes(
            pad_input(data, _POS_PAD, max_steps), self.device
        )
        return [
            lambda shard=shard, tt=tt: self._flat_turbo_one(
                shard, tt, padded, input_size)
            for shard, tt in zip(self.compiled.shards,
                                 self._get_turbo_tables())
        ]

    def _match_flat_turbo(self, data: bytes, input_size: int) -> list:
        """Per-shard flat matches via the turbo engine."""
        with self.timer.phase("match"):
            return [
                r() for r in self._dispatch_flat_turbo(data, input_size)
            ]

    def _dense_rows_one_shard(self, shard, padded, input_size):
        max_steps = padded_steps(self.compiled.max_pat_len)
        n_pos = len(padded) - max_steps
        limits = walk_limits(n_pos, input_size, shard.max_pat_len, self.config)
        out, _ = scan_shard(
            shard, padded, limits, input_size, slots=_dense_slots(shard),
            device=self.device,
        )
        return out.cpu().numpy()

    def _slots(self) -> int:
        if self.config.match_slots > 0:
            return self.config.match_slots
        # full parity layout: a walk emits at most one match per step
        return max(self.compiled.max_pat_len, 1)

    def match_rows(
        self, data: bytes, *, input_size: int | None = None
    ) -> list[np.ndarray]:
        """Per-shard match rows [n_pos, slots] of shard-local final states."""
        if input_size is None:
            input_size = len(data)
        max_steps = padded_steps(self.compiled.max_pat_len)
        padded = pad_input(data, _POS_PAD, max_steps)
        n_pos = len(padded) - max_steps
        slots = self._slots()
        if self.engine == "pallas":
            # the kernels emit bitmaps, not dense rows; reconstruct the
            # parity row layout from the flat matches (slot j = j-th
            # match at the position, in increasing length order — the
            # walk emit order)
            return self._rows_from_flats(
                self._match_flat_pallas(data, input_size), n_pos, slots
            )
        padded_dev = to_device_bytes(padded, self.device)
        rows: list[np.ndarray] = []
        with self.timer.phase("match"):
            for shard in self.compiled.shards:
                limits = walk_limits(
                    n_pos, input_size, shard.max_pat_len, self.config
                )
                out, _cnt = scan_shard(
                    shard, padded_dev, limits, input_size, slots=slots,
                    device=self.device,
                )
                rows.append(out.cpu().numpy())
        return rows

    def _rows_from_flats(self, flats, n_pos: int, slots: int):
        rows = []
        for m in flats:
            out = np.full((n_pos, slots), -1, dtype=np.int32)
            fill = np.zeros(n_pos, dtype=np.int64)
            for pos, _step, local in m:
                if fill[pos] < slots:
                    out[pos, fill[pos]] = local
                    fill[pos] += 1
            rows.append(out)
        return rows

    # ---- kernel engine -------------------------------------------------

    def _shard_scanner_one(self, shard, pt=None):
        """Fastest applicable bitmap scanner for ONE shard, or None.

        Preference: the plan kernel (power-of-two segments or exact
        mode) > the stride-2 pair kernel (alphabet <= 63, exact mode
        only) > the depth kernel (any leveled automaton, max_pat_len
        <= 32).  None = no bitmap kernel applies (e.g. patterns longer
        than the 32-step bitmap) — the caller scans that shard with the
        turbo engine instead.

        The plan scanner gets the profile corpus (``self._train``, by
        default the head of the first scanned input): it only shapes
        the table layout, never the results.
        """
        seg = self.config.truncation == "segment"
        seg_bytes = self.config.segment_bytes
        makers = []
        if not seg or seg_bytes & (seg_bytes - 1) == 0:
            makers.append(lambda: PlanShardScanner(
                shard, device=self.device, train=self._train, pt=pt))
        if not seg:
            makers.append(lambda: PairShardScanner(shard,
                                                   device=self.device))
        makers.append(lambda: DepthShardScanner(shard, device=self.device))
        for make in makers:
            try:
                return make()
            except DepthUnsupported:
                continue  # (or PairUnsupported) the table build refused
        return None

    def _split_long_shard(self, shard):
        """Split one shard's dictionary at the 32-byte bitmap depth.

        The bulk (patterns <= 32 B) rides the bitmap kernels; the long
        tail runs a host literal search when it has at most 8 patterns,
        else the turbo engine.  The two sub-scans merge back into the
        ORIGINAL shard's flat matches (sub-local states remapped through
        the subsequence index), so ordering and ids downstream are
        untouched.

        Returns (short_st, short_scanner, short_map, long_st, long_tt,
        long_map) or None when the split doesn't apply; ``long_tt`` is
        ("host", [(pattern, final state)]) or the tail's TurboTables.
        """
        if shard.patterns is None or shard.output_lists is not None:
            return None
        pats = shard.patterns
        i_short = [i for i, p in enumerate(pats)
                   if len(p) <= MAX_BITMAP_STEPS]
        i_long = [i for i, p in enumerate(pats) if len(p) > MAX_BITMAP_STEPS]
        if not i_short or not i_long:
            return None

        from phfpfac_tpu_torch.compile.tables import _shard_to_tables
        from phfpfac_tpu_torch.compile.trie import build_pfac_trie
        from phfpfac_tpu_torch.frontend.patterns import Pattern

        def build_sub(idx):
            sub_pats = [
                Pattern(int(shard.pattern_id_map[i]), pats[i]) for i in idx
            ]
            trie = build_pfac_trie(sub_pats)
            st = _shard_to_tables(trie, None, shard.width)
            st.patterns = [p.data for p in sub_pats]
            return st, np.asarray(idx, dtype=np.int64)

        short_st, short_map = build_sub(i_short)
        ds = self._shard_scanner_one(short_st)
        if ds is None:
            return None
        long_st, long_map = build_sub(i_long)
        if len(i_long) <= _HOST_TAIL_MAX:
            # final ids recovered by walking the sub-automaton: rows are
            # (pos, len-1, final-state), as the device walks emit them
            dense = long_st.dense_table()

            def final_of(pat: bytes) -> int:
                s = int(long_st.s0[pat[0]])
                for c in pat[1:]:
                    s = int(dense[s][c])
                return s

            long_tt = ("host", [(pats[i], final_of(pats[i])) for i in i_long])
        else:
            long_tt = build_turbo_tables(long_st)
        # the ORIGINAL shard is never scanned after a split — release
        # its dense-trie cache; the sub-shards keep theirs for decode
        shard.drop_dense()
        return (short_st, ds, short_map, long_st, long_tt, long_map)

    def _get_pallas_scanner(self):
        """("depth", per-shard entries); or, when NO shard has a bitmap
        scanner, ("multi", MultiShardScanner), or ("turbo", None) where
        the multi kernel refuses the dictionary too.

        Per-shard entries: a bitmap scanner, ("split", parts) for a
        long-tail split (see _split_long_shard), or None (the turbo
        engine for the whole shard)."""
        if self._scanners is None:
            per_shard = []
            saved = self.compiled.plan_tables
            for i, sh in enumerate(self.compiled.shards):
                ds = self._shard_scanner_one(
                    sh, pt=saved[i] if saved else None
                )
                if ds is None:
                    parts = self._split_long_shard(sh)
                    per_shard.append(
                        ("split", parts) if parts is not None else None
                    )
                else:
                    per_shard.append(ds)
            if all(s is None for s in per_shard):
                try:
                    self._scanners = (
                        "multi",
                        MultiShardScanner(self.compiled.shards,
                                          device=self.device),
                    )
                except PhfUnsupported:
                    # PHF tables too wide to pack: no kernel takes this
                    # dictionary, the turbo engine answers
                    self._scanners = ("turbo", None)
            else:
                self._scanners = ("depth", per_shard)
        return self._scanners

    def _get_scanners(self) -> list:
        """The per-shard entries of ``_get_pallas_scanner`` (the multi
        kernel has none: every entry is None)."""
        kind, scanner = self._get_pallas_scanner()
        if kind != "depth":
            return [None] * len(self.compiled.shards)
        return scanner

    def _takes_ordered(self, kind, entries) -> bool:
        """Whether a chunk's rows take the ordered decode: every shard
        has a bitmap scanner of its own (no split shard, no turbo shard,
        not the multi kernel), and the native hash decode takes every
        shard of a plain dictionary (``hash_decodes``)."""
        return (
            kind == "depth"
            and not getattr(self.compiled, "charset", False)
            and all(e is not None and not isinstance(e, tuple)
                    for e in entries)
            and all(map(hash_decodes, self.compiled.shards))
        )

    def _dispatch(self, data: bytes, input_size: int, padded_dev=None,
                  chunk: tuple[int, int] | None = None):
        """Start every shard's device scan; return per-shard resolvers
        (each ``resolver()`` -> flat matches), or None when the kernels
        do not take this dictionary (the multi kernel past its 32 steps,
        or a dictionary it refuses: the turbo engine answers).  Kernel
        launches are asynchronous, so a caller that dispatches chunk i+1
        before resolving chunk i overlaps its scans with i's download
        and decode.

        ``padded_dev``: the padded window as a tensor already on the
        device (``stage_for_chunked``), in place of this call's pad and
        upload; ``data`` stays the host copy the decoders read.

        ``chunk``: (base, body), the call scans a chunk whose positions
        below ``body`` are its own.  Where ``_takes_ordered`` holds, the
        call returns ONE resolver, whose result is the chunk's final
        int64 [(base + pos, global id)] rows in the merge's order: each
        shard's hits below ``body`` fetched, all decoded at once."""
        max_steps = padded_steps(self.compiled.max_pat_len)
        if self._train is None and self._scanners is None \
                and len(data) >= 4096:
            # profile-guided layout: train on the head of the first
            # (non-trivial) input scanned — only affects speed, never
            # results; tiny first inputs would lock in a useless
            # profile, so they stay untrained
            self._train = bytes(data[: 1 << 20])
        kind, scanner = self._get_pallas_scanner()
        if kind == "turbo":
            return None
        # one upload per chunk, shared by every shard's staging
        padded = padded_dev
        if padded is None:
            with span("stage:input.upload"):
                padded = to_device_bytes(
                    pad_input(data, _POS_PAD, max_steps), self.device)

        if kind == "multi":
            if max_steps > MAX_BITMAP_STEPS:
                return None  # beyond the 32-step bitmap
            _cnt, bits_dev = scanner.scan(
                padded, input_size, self.config, max_steps
            )
            host = []  # one download, shared by the shards' resolvers

            def make_resolve(s, shard):
                def resolve():
                    if not host:
                        host.append(bits_dev.cpu().numpy())
                        count("fetch.bytes", host[0].nbytes)
                    return decode_bitmap(
                        host[0][s], data, input_size, shard, max_steps
                    )

                return resolve

            return [make_resolve(s, shard)
                    for s, shard in enumerate(self.compiled.shards)]

        if chunk is not None and self._takes_ordered(kind, scanner):
            base, body = chunk
            launched = [ds.scan_async(padded, input_size, self.config,
                                      max_steps) for ds in scanner]

            def resolve_ordered():
                hits = [fetch_hit_bits(verify()[1], body)
                        for _cnt, _bits, verify in launched]
                return decode_hits([hb for _pos, hb in hits],
                                   [pos for pos, _hb in hits], data,
                                   input_size, list(self.compiled.shards),
                                   max_steps, base=base)

            return [resolve_ordered]

        def bitmap_dispatch(ds, st):
            # dispatch only: verify(), run at resolve time, answers a
            # compacted plan scan's cap overflow without a wait for the
            # device at dispatch
            _cnt, _bits, verify = ds.scan_async(
                padded, input_size, self.config, max_steps)

            def resolve():
                _cnt, bits = verify()
                pos, hb = fetch_hit_bits(bits, input_size)
                return decode_hits(hb, pos, data, input_size, st, max_steps)

            return resolve

        resolvers = []
        for si, (shard, entry) in enumerate(
            zip(self.compiled.shards, scanner)
        ):
            if entry is None:
                # no bitmap kernel for THIS shard: the turbo engine for
                # it, the kernels for the rest.  Tables built for THIS
                # shard only (a full _get_turbo_tables would force the
                # lazy PHF on every shard)
                if si not in self._solo_turbo:
                    self._solo_turbo[si] = build_turbo_tables(shard)
                resolvers.append(
                    lambda shard=shard, si=si: self._flat_turbo_one(
                        shard, self._solo_turbo[si], padded, input_size)
                )
            elif isinstance(entry, tuple):
                (short_st, ds, short_map, long_st, long_tt,
                 long_map) = entry[1]
                short_resolve = bitmap_dispatch(ds, short_st)

                def resolve(short_resolve=short_resolve, long_st=long_st,
                            long_tt=long_tt, short_map=short_map,
                            long_map=long_map):
                    ms = short_resolve()
                    if isinstance(long_tt, tuple):
                        ml = self._host_literal_one(
                            data, input_size, long_tt[1]
                        )
                    else:
                        ml = self._flat_turbo_one(
                            long_st, long_tt, padded, input_size
                        )
                    # back to ORIGINAL shard-local states
                    if ms.size:
                        ms[:, 2] = short_map[ms[:, 2]]
                    if not ml.size:
                        return ms
                    ml[:, 2] = long_map[ml[:, 2]]
                    # the few long matches into the short ones' (pos,
                    # step) order (a long match's step follows every
                    # short one's), so that the merge finds the shard's
                    # flats sorted and takes its fast path
                    ml = ml[np.lexsort((ml[:, 1], ml[:, 0]))]
                    at = np.searchsorted(ms[:, 0], ml[:, 0], side="right")
                    return np.insert(ms.reshape(-1, 3), at, ml, axis=0)

                resolvers.append(resolve)
            else:
                resolvers.append(bitmap_dispatch(entry, shard))
        return resolvers

    def _match_flat_pallas(self, data: bytes, input_size: int,
                           chunk=None) -> list:
        """Per-shard flat matches (pos, step, shard-local state) via the
        kernels; shard-local states are recovered from the matched
        substrings (ops.bitmap).  With ``chunk``, the ordered decode's
        one block where it engages (see ``_dispatch``)."""
        with self.timer.phase("match"):
            resolvers = self._dispatch(data, input_size, chunk=chunk)
            if resolvers is not None:
                return [r() for r in resolvers]
        return self._match_flat_turbo(data, input_size)

    def _chunk_geometry(self, chunk_bytes: int):
        """(chunk_bytes, overlap, padded window length) of the chunk
        loop: chunks start on segment boundaries, overlap by
        max_pat_len - 1 (or the halo), and every window pads to the
        same length."""
        overlap = max(self.compiled.max_pat_len - 1, 0)
        if self.config.truncation == "segment":
            # chunks must start on segment boundaries, and segment
            # walks may read up to halo past the last boundary
            chunk_bytes = max(
                (chunk_bytes // self.config.segment_bytes) *
                self.config.segment_bytes,
                self.config.segment_bytes,
            )
            overlap = max(overlap, self.config.halo_bytes)
        wlen = chunk_bytes + overlap
        wpad = (-(-wlen // _POS_PAD) * _POS_PAD
                + padded_steps(self.compiled.max_pat_len))
        return chunk_bytes, overlap, wpad

    def stage_for_chunked(self, data, *,
                          chunk_bytes: int = 16 << 20) -> torch.Tensor:
        """One upload of the whole corpus for ``match_chunked``: the
        padded input as a uint8 tensor on the scan device, long enough
        that every chunk's window is a view of it.  Pass it as
        ``device_data`` with the same ``chunk_bytes``; the chunk loop
        then slices its windows on the device and uploads nothing (a
        deployment whose corpus already lives on the device)."""
        _chunk, _overlap, wpad = self._chunk_geometry(chunk_bytes)
        return to_device_bytes(pad_input(data, _POS_PAD, wpad), self.device)

    def match_chunked(
        self, data: bytes, *, input_size: int | None = None,
        chunk_bytes: int = 16 << 20, max_outstanding: int = 3,
        device_data: torch.Tensor | None = None,
    ) -> np.ndarray:
        """Pipelined chunked scan: the scans of chunk i+1 are enqueued
        before chunk i's bitmaps download and decode.  Exactly-once
        across chunks via a max_pat_len-1 (or halo) read-overlap;
        byte-identical output to ``match`` (chunk bases stay
        segment-aligned, so truncation semantics are position-local in
        both).  Only the kernel engine chunks; the others scan in one
        piece.  ``device_data``: see ``stage_for_chunked``.
        """
        if input_size is None:
            input_size = len(data)
        chunk_bytes, overlap, wpad = self._chunk_geometry(chunk_bytes)
        if (
            self.engine != "pallas"
            or input_size <= chunk_bytes + overlap
        ):
            return self.match(data, input_size=input_size)

        n_shards = len(self.compiled.shards)
        per_shard: list[list] = [[] for _ in range(n_shards)]
        blocks: list[np.ndarray] = []  # the ordered decode's, a chunk each
        pending: list[tuple[int, int, list]] = []
        ordered = False

        def resolve_one():
            base, body, resolvers = pending.pop(0)
            if ordered:
                blocks.append(resolvers[0]())
                return
            for s, r in enumerate(resolvers):
                m = r()
                with span("stage:chunk.cut"):
                    if m.size:
                        m = m[m[:, 0] < body]
                        m[:, 0] += base
                    per_shard[s].append(m.reshape(-1, 3))

        # every dispatch uses the SAME padded window length
        wlen = chunk_bytes + overlap
        if device_data is not None and \
                device_data.shape[0] < input_size + wpad:
            raise ValueError(
                "device_data too short for this chunk geometry — "
                "stage with Matcher.stage_for_chunked(data, "
                "chunk_bytes=...) using the same chunk_bytes"
            )
        with self.timer.phase("match"):
            base = 0
            while base < input_size:
                body = min(chunk_bytes, input_size - base)
                wend = min(base + body + overlap, input_size)
                with span("stage:chunk.window"):
                    window = bytes(data[base:wend])
                    if len(window) < wlen:
                        window += b"\x00" * (wlen - len(window))
                resolvers = self._dispatch(
                    window, wend - base,
                    padded_dev=None if device_data is None
                    else device_data[base:base + wpad],
                    chunk=(base, body),
                )
                if resolvers is None:
                    break  # no kernel path: unchunked turbo scan below
                ordered = self._takes_ordered(*self._get_pallas_scanner())
                pending.append((base, body, resolvers))
                if len(pending) > max_outstanding:
                    resolve_one()
                base += body
            else:
                while pending:
                    resolve_one()
                if ordered:
                    return merge_flat_matches(self.compiled, blocks,
                                              input_size)
                with span("stage:chunk.concat"):
                    flats = [
                        np.concatenate(parts) if parts else
                        np.empty((0, 3), np.int64)
                        for parts in per_shard
                    ]
                return merge_flat_matches(self.compiled, flats, input_size)
        return self.match(data, input_size=input_size)

    def match(
        self, data: bytes, *, input_size: int | None = None
    ) -> np.ndarray:
        """Flat [(position, global pattern id)] in reference output order."""
        if input_size is None:
            input_size = len(data)
        if self.engine == "turbo":
            flats = self._match_flat_turbo(data, input_size)
            return merge_flat_matches(self.compiled, flats, input_size)
        if self.engine == "pallas":
            flats = self._match_flat_pallas(data, input_size,
                                            chunk=(0, input_size))
            return merge_flat_matches(self.compiled, flats, input_size)
        rows = self.match_rows(data, input_size=input_size)
        return merge_match_rows(self.compiled, rows, input_size)

    def count_matches(self, data: bytes, *, input_size: int | None = None):
        """Per-position match counts (benchmark mode, turbo engine)."""
        if input_size is None:
            input_size = len(data)
        max_steps = padded_steps(self.compiled.max_pat_len)
        padded = to_device_bytes(
            pad_input(data, _POS_PAD, max_steps), self.device
        )
        n_pos = padded.shape[0] - max_steps
        total = torch.zeros(n_pos, dtype=torch.int64, device=self.device)
        for shard, tt in zip(self.compiled.shards, self._get_turbo_tables()):
            _full, cnt, _tail, tail_pos, tail_cnt, overflow = scan_shard_turbo(
                shard, padded, input_size, self.config,
                max_steps=max_steps, full_steps=self.turbo_full_steps,
                cap_frac=self.turbo_cap_frac, emit_counts=True,
                turbo_tables=tt, device=self.device,
            )
            if bool(overflow):
                rows = self._dense_rows_one_shard(shard, padded, input_size)
                total += torch.from_numpy((rows >= 0).sum(axis=1)).to(
                    self.device)
            else:
                total += cnt
                total.index_add_(0, tail_pos.to(torch.int64),
                                 tail_cnt.to(torch.int64))
        return total[:input_size].cpu().numpy()

    def match_to_text(self, data: bytes, *, input_size: int | None = None) -> str:
        """GPU_match_result.txt-identical text."""
        return render_result_file(self.match(data, input_size=input_size))

    def built_plan_tables(self) -> list:
        """Per-shard built PlanTables (None where another engine won)."""
        return [
            s.pt if isinstance(s, PlanShardScanner) else None
            for s in self._get_scanners()
        ]
