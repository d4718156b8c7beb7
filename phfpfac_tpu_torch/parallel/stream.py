"""Streaming and batched serving APIs.

The reference is a one-shot CLI (read file, scan, exit).  A serving
deployment needs two more shapes, both built on the same engines:

* ``StreamMatcher`` — feed a byte stream in chunks; every match is
  reported exactly once, by the first feed whose cumulative data
  contains the match's last byte.  Each feed rescans only the
  ``max_pat_len - 1`` tail bytes of earlier data (the host-side
  version of the kernel's halo overlap, master_kernel.cu:129-135).
  Segment-truncation configs stream too: scan windows stay aligned to
  global segment boundaries and a segment's matches are reported once
  its walk window (segment end + halo) has arrived — ``finish()``
  flushes the final partial segment at end-of-stream.
* ``match_many`` — scan a batch of small buffers in ONE device
  scan by concatenation; matches that would straddle a buffer
  boundary are dropped in the decode (walks are position-local, so
  a straddling "match" can only arise from adjacency in the concat).

Both return global/batch-local positions in reference order, and both
scan on the CUDA device unless the caller names another (``device=``).
"""

from __future__ import annotations

import numpy as np

from phfpfac_tpu_torch.compile.tables import CompiledDictionary
from phfpfac_tpu_torch.parallel.matcher import Matcher
from phfpfac_tpu_torch.parallel.merge import merge_flat_matches
from phfpfac_tpu_torch.utils.config import PfacConfig


class StreamMatcher:
    """Incremental scanning with exactly-once match reporting."""

    def __init__(
        self,
        compiled: CompiledDictionary,
        config: PfacConfig,
        *,
        engine: str = "pallas",
        device=None,
    ):
        # ``engine`` defaults to Matcher's default, the kernels
        self.matcher = Matcher(compiled, config, engine=engine,
                               device=device)
        self.overlap = max(compiled.max_pat_len - 1, 0)
        self._tail = b""
        self._total = 0  # bytes fed so far
        # Segment truncation (reference master_kernel.cu:141-144) is
        # POSITIONAL — a match starting in segment S may read up to
        # end(S) + halo — so streamed scans stay equivalent to the
        # one-shot scan as long as (a) every scan window starts on a
        # global segment boundary (local cuts == global cuts) and (b)
        # segment S's matches are reported only once bytes up to
        # end(S) + halo have arrived (its walks can never extend
        # further).  The unfinalized tail is rescanned next feed;
        # call finish() at end-of-stream to flush it.
        self.seg_mode = config.truncation == "segment"
        if self.seg_mode:
            self.seg = config.segment_bytes
            self.halo = config.halo_bytes
            self._reported = 0  # finalized prefix (multiple of seg)

    def feed(self, chunk: bytes) -> np.ndarray:
        """Scan ``chunk``; return the NEW matches as int64 [(global
        position, pattern id)] — exactly those whose last byte arrived
        with this chunk."""
        return self.feed_async(chunk)()

    def feed_async(self, chunk: bytes):
        """Dispatch ``chunk``'s scan and return a resolver.

        The device scans are enqueued at once (kernel launches are
        asynchronous); calling the resolver downloads + decodes.
        Feeding the next chunk before resolving the previous one
        overlaps its upload, staging and scan with the previous chunk's
        result download (the serving analog of the reference's stream
        pipelining, Makefile:1).
        Resolvers may be called in any order; matches are assigned to
        feeds by dispatch order.
        """
        if not chunk:
            return lambda: np.empty((0, 2), dtype=np.int64)
        window = self._tail + chunk
        base = self._total - len(self._tail)
        prev_end = self._total
        self._total += len(chunk)
        if self.seg_mode:
            # finalized prefix: segments whose full walk window
            # (end + halo) has arrived; everything past it is rescanned
            done_end = max(
                (self._total - self.halo) // self.seg * self.seg, base
            )
            self._tail = window[done_end - base:]
            self._reported = done_end
            scan = self._scan_async(window)

            def resolve():
                matches = scan()
                if matches.size == 0:
                    return matches.reshape(0, 2)
                gpos = matches[:, 0] + base
                keep = gpos < done_end
                return np.stack([gpos[keep], matches[keep][:, 1]], axis=1)

            return resolve

        self._tail = window[-self.overlap :] if self.overlap else b""
        scan = self._scan_async(window)

        def resolve():
            matches = scan()
            if matches.size == 0:
                return matches.reshape(0, 2)
            gpos = matches[:, 0] + base
            # end = pos + len(pattern); recover length from the id
            lengths = self._pattern_lengths()[matches[:, 1]]
            end = gpos + lengths
            keep = end > prev_end
            return np.stack([gpos[keep], matches[keep][:, 1]], axis=1)

        return resolve

    def finish(self) -> np.ndarray:
        """End-of-stream flush (segment mode): scan and report the
        buffered not-yet-finalized tail — no further bytes can extend
        its walks, so its matches are exactly the one-shot scan's.
        Exact mode reports every match as its last byte arrives and
        has nothing pending; returns the empty array there."""
        empty = np.empty((0, 2), dtype=np.int64)
        if not self.seg_mode or not self._tail:
            self._tail = b""
            return empty
        window, base = self._tail, self._reported
        self._tail = b""
        self._reported = self._total
        matches = self._scan_async(window)()
        if matches.size == 0:
            return empty
        return np.stack([matches[:, 0] + base, matches[:, 1]], axis=1)

    def _scan_async(self, window: bytes):
        """Dispatch a window scan; resolver returns raw [(pos, id)].

        The kernel engine dispatches at feed time through
        ``Matcher._dispatch``; where that returns None (no kernel takes
        the dictionary) the resolver scans with ``Matcher.match``, whose
        turbo engine answers.  The turbo engine goes through
        ``_dispatch_flat_turbo``, which uploads at feed time and scans
        shard by shard when resolved.  The ``jnp`` engine scans at
        resolve time — it exists for oracle comparisons, not serving."""
        dispatch = {
            "pallas": self.matcher._dispatch,
            "turbo": self.matcher._dispatch_flat_turbo,
        }.get(self.matcher.engine)
        resolvers = dispatch(window, len(window)) if dispatch else None
        if resolvers is None:
            return lambda: np.asarray(
                self.matcher.match(window, input_size=len(window))
            )

        def resolve():
            flats = [r() for r in resolvers]
            return np.asarray(merge_flat_matches(
                self.matcher.compiled, flats, len(window)
            ))

        return resolve

    def _pattern_lengths(self) -> np.ndarray:
        if not hasattr(self, "_plen"):
            self._plen = pattern_lengths(self.matcher.compiled,
                                         "StreamMatcher")
        return self._plen


def pattern_lengths(compiled: CompiledDictionary, who: str) -> np.ndarray:
    """Pattern length by global pattern id (ids start at 1)."""
    plen = np.zeros(compiled.num_patterns + 1, dtype=np.int64)
    for sh in compiled.shards:
        if sh.patterns is None:
            raise ValueError(f"{who} needs shards with pattern bytes")
        for local, pat in enumerate(sh.patterns):
            plen[int(sh.pattern_id_map[local])] = len(pat)
    return plen


def match_many(
    matcher: Matcher, buffers: list[bytes]
) -> list[np.ndarray]:
    """Scan many buffers in one scan; per-buffer [(pos, id)].

    Buffers are concatenated and scanned once; matches whose extent
    crosses a buffer boundary are artifacts of the concatenation and
    are dropped during decode.
    """
    if not buffers:
        return []
    joined = b"".join(buffers)
    bounds = np.cumsum([0] + [len(b) for b in buffers])
    matches = np.asarray(matcher.match(joined, input_size=len(joined)))
    outs: list[np.ndarray] = []
    if matches.size == 0:
        return [np.empty((0, 2), dtype=np.int64) for _ in buffers]
    plen = pattern_lengths(matcher.compiled, "match_many")
    pos = matches[:, 0]
    end = pos + plen[matches[:, 1]]
    buf_idx = np.searchsorted(bounds, pos, side="right") - 1
    within = end <= bounds[buf_idx + 1]
    for i in range(len(buffers)):
        sel = within & (buf_idx == i)
        m = matches[sel].copy()
        if m.size:
            m[:, 0] -= bounds[i]
        outs.append(m.reshape(-1, 2))
    return outs
