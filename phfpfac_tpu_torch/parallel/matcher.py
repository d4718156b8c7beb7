"""Single-device matcher orchestration.

Each dictionary shard scans the full input and the results merge
shard-major (the reference's per-shard dispatch loop,
main.cc:225-241).  Per shard the fastest ported bitmap kernel that
accepts it runs: the plan kernel (ops.plan), else the depth kernel
(ops.depth).  Shards with patterns longer than the 32-step bitmap
split: the short part rides the same kernels, a tail of at most 8 long
patterns goes to a host literal search.

Paths the port does not have yet raise ``NotImplementedError`` naming
the ROADMAP item instead of falling back silently.
"""

from __future__ import annotations

import numpy as np
import torch

from phfpfac_tpu_torch.compile.depth import MAX_DEPTH_STEPS, DepthUnsupported
from phfpfac_tpu_torch.compile.tables import CompiledDictionary
from phfpfac_tpu_torch.ops.bitmap import decode_hits, fetch_hit_bits
from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
from phfpfac_tpu_torch.ops.depth import DepthShardScanner
from phfpfac_tpu_torch.ops.plan import PlanShardScanner
from phfpfac_tpu_torch.ops.staging import to_device_bytes
from phfpfac_tpu_torch.parallel.merge import (
    merge_flat_matches,
    render_result_file,
)
from phfpfac_tpu_torch.utils.config import PfacConfig
from phfpfac_tpu_torch.utils.timing import PhaseTimer

_POS_PAD = 1024  # position-count padding granularity
_HOST_TAIL_MAX = 8  # long-pattern tails up to this size search on the host

_NO_TURBO = ("turbo XLA engine (ROADMAP.md queue 1, 'XLA engines as "
             "torch ops')")
_NO_MULTI = ("banked-PHF multi-shard kernel K5 (ROADMAP.md queue 1, "
             "'Banked-PHF scanners')")


def resolve_device(device=None) -> torch.device:
    """The scan device: CUDA unless the caller names another.  Raises
    when CUDA is asked for (or defaulted to) and absent — the port never
    drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch versions of the kernels"
        )
    return dev


class Matcher:
    """Scans inputs against a compiled dictionary on one device."""

    def __init__(
        self,
        compiled: CompiledDictionary,
        config: PfacConfig,
        *,
        device=None,
        timer: PhaseTimer | None = None,
        train: bytes | None = None,
    ):
        self.compiled = compiled
        self.config = config
        self.device = resolve_device(device)
        self.timer = timer or PhaseTimer()
        self._scanners = None
        self._train = train  # profile corpus (None = first input head)

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

    def _shard_scanner_one(self, shard, pt=None):
        """Fastest ported bitmap scanner for ONE shard, or None.

        Preference: the plan kernel (power-of-two segments or exact
        mode) > the depth kernel (any leveled automaton, max_pat_len
        <= 32).  The stride-2 pair kernel, which the reference engine
        tries between the two in exact mode, is not ported; it emits
        the same bitmaps, so the depth kernel stands in for it.

        The plan scanner gets the profile corpus (``self._train``, by
        default the head of the first scanned input): it only shapes
        the table layout, never the results.
        """
        seg_bytes = self.config.segment_bytes
        if self.config.truncation != "segment" or \
                seg_bytes & (seg_bytes - 1) == 0:
            try:
                return PlanShardScanner(shard, device=self.device,
                                        train=self._train, pt=pt)
            except DepthUnsupported:
                pass  # PairUnsupported: the plan builder refused
        try:
            return DepthShardScanner(shard, device=self.device)
        except DepthUnsupported:
            return None

    def _split_long_shard(self, shard):
        """Split one shard's dictionary at the 32-byte bitmap depth.

        The bulk (patterns <= 32 B) rides the bitmap kernels; the long
        tail runs a host literal search.  The two sub-scans merge back
        into the ORIGINAL shard's flat matches (sub-local states
        remapped through the subsequence index), so ordering and ids
        downstream are untouched.

        Returns (short_st, short_scanner, short_map, long_pats, long_map)
        or None when the split doesn't apply.
        """
        if shard.patterns is None or shard.output_lists is not None:
            return None
        pats = shard.patterns
        i_short = [i for i, p in enumerate(pats) if len(p) <= MAX_DEPTH_STEPS]
        i_long = [i for i, p in enumerate(pats) if len(p) > MAX_DEPTH_STEPS]
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
        if len(i_long) > _HOST_TAIL_MAX:
            raise NotImplementedError(
                f"a shard with {len(i_long)} patterns longer than "
                f"{MAX_DEPTH_STEPS} B needs the {_NO_TURBO}"
            )
        long_st, long_map = build_sub(i_long)
        # final ids recovered by walking the sub-automaton: rows are
        # (pos, len-1, final-state), as the device walks emit them
        dense = long_st.dense_table()

        def final_of(pat: bytes) -> int:
            s = int(long_st.s0[pat[0]])
            for c in pat[1:]:
                s = int(dense[s][c])
            return s

        long_pats = [(pats[i], final_of(pats[i])) for i in i_long]
        # the ORIGINAL shard is never scanned after a split — release
        # its dense-trie cache; the sub-shards keep theirs for decode
        shard.drop_dense()
        return (short_st, ds, short_map, long_pats, long_map)

    def _get_scanners(self):
        """Per-shard entries: a bitmap scanner or ("split", parts)."""
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
                raise NotImplementedError(
                    f"no ported bitmap kernel takes any shard: needs the "
                    f"{_NO_MULTI}"
                )
            if any(s is None for s in per_shard):
                raise NotImplementedError(
                    f"no ported bitmap kernel takes shard "
                    f"{per_shard.index(None)}: needs the {_NO_TURBO}"
                )
            self._scanners = per_shard
        return self._scanners

    def _dispatch(self, data: bytes, input_size: int) -> list:
        """Start every shard's device scan; return per-shard resolvers
        (each ``resolver()`` -> flat matches).  Kernel launches are
        asynchronous, so a caller that dispatches chunk i+1 before
        resolving chunk i overlaps its scans with i's download and
        decode."""
        max_steps = padded_steps(self.compiled.max_pat_len)
        if self._train is None and self._scanners is None \
                and len(data) >= 4096:
            # profile-guided layout: train on the head of the first
            # (non-trivial) input scanned — only affects speed, never
            # results; tiny first inputs would lock in a useless
            # profile, so they stay untrained
            self._train = bytes(data[: 1 << 20])
        scanners = self._get_scanners()
        # one upload per chunk, shared by every shard's staging
        padded = to_device_bytes(
            pad_input(data, _POS_PAD, max_steps), self.device
        )

        def bitmap_dispatch(ds, st):
            _cnt, bits = ds.scan(padded, input_size, self.config, max_steps)

            def resolve():
                pos, hb = fetch_hit_bits(bits, input_size)
                return decode_hits(hb, pos, data, input_size, st, max_steps)

            return resolve

        resolvers = []
        for shard, entry in zip(self.compiled.shards, scanners):
            if isinstance(entry, tuple):
                short_st, ds, short_map, long_pats, long_map = entry[1]
                short_resolve = bitmap_dispatch(ds, short_st)

                def resolve(short_resolve=short_resolve,
                            long_pats=long_pats, short_map=short_map,
                            long_map=long_map):
                    ms = short_resolve()
                    ml = self._host_literal_one(data, input_size, long_pats)
                    # back to ORIGINAL shard-local states
                    if ms.size:
                        ms[:, 2] = short_map[ms[:, 2]]
                    if ml.size:
                        ml[:, 2] = long_map[ml[:, 2]]
                    return np.concatenate([ms, ml])

                resolvers.append(resolve)
            else:
                resolvers.append(bitmap_dispatch(entry, shard))
        return resolvers

    def _match_flat(self, data: bytes, input_size: int) -> list:
        """Per-shard flat matches (pos, step, shard-local state)."""
        with self.timer.phase("match"):
            return [r() for r in self._dispatch(data, input_size)]

    def match_chunked(
        self, data: bytes, *, input_size: int | None = None,
        chunk_bytes: int = 16 << 20, max_outstanding: int = 3,
    ) -> np.ndarray:
        """Pipelined chunked scan: the scans of chunk i+1 are enqueued
        before chunk i's bitmaps download and decode.  Exactly-once
        across chunks via a max_pat_len-1 (or halo) read-overlap;
        byte-identical output to ``match`` (chunk bases stay
        segment-aligned, so truncation semantics are position-local in
        both).
        """
        if input_size is None:
            input_size = len(data)
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
        if input_size <= chunk_bytes + overlap:
            return self.match(data, input_size=input_size)

        n_shards = len(self.compiled.shards)
        per_shard: list[list] = [[] for _ in range(n_shards)]
        pending: list[tuple[int, int, list]] = []

        def resolve_one():
            base, body, resolvers = pending.pop(0)
            for s, r in enumerate(resolvers):
                m = r()
                if m.size:
                    m = m[m[:, 0] < body]
                    m[:, 0] += base
                per_shard[s].append(m.reshape(-1, 3))

        # every dispatch uses the SAME padded window length
        wlen = chunk_bytes + overlap
        with self.timer.phase("match"):
            base = 0
            while base < input_size:
                body = min(chunk_bytes, input_size - base)
                wend = min(base + body + overlap, input_size)
                window = bytes(data[base:wend])
                if len(window) < wlen:
                    window += b"\x00" * (wlen - len(window))
                pending.append(
                    (base, body, self._dispatch(window, wend - base))
                )
                if len(pending) > max_outstanding:
                    resolve_one()
                base += body
            while pending:
                resolve_one()
            flats = [
                np.concatenate(parts) if parts else
                np.empty((0, 3), np.int64)
                for parts in per_shard
            ]
            return merge_flat_matches(self.compiled, flats, input_size)

    def match(
        self, data: bytes, *, input_size: int | None = None
    ) -> np.ndarray:
        """Flat [(position, global pattern id)] in reference output order."""
        if input_size is None:
            input_size = len(data)
        flats = self._match_flat(data, input_size)
        return merge_flat_matches(self.compiled, flats, input_size)

    def match_to_text(self, data: bytes, *, input_size: int | None = None) -> str:
        """GPU_match_result.txt-identical text."""
        return render_result_file(self.match(data, input_size=input_size))

    def built_plan_tables(self) -> list:
        """Per-shard built PlanTables (None where another engine won)."""
        return [
            s.pt if isinstance(s, PlanShardScanner) else None
            for s in self._get_scanners()
        ]
