"""CPU reference oracle for exact-parity tests.

The reference has no automated tests (SURVEY.md §4); its methodology was
golden-file diffs of `GPU_match_result*.txt`.  This oracle reproduces
the *engine semantics* (not just "all matches"): per start position, in
shard-major order, matches in increasing length, with optional
segment+halo walk truncation (master_kernel.cu:141-144) and the
duplicate-pattern overwrite rule (create_table_reorder.c:366).

It is deliberately implemented from the sorted pattern list with a
byte-dict trie — an independent code path from the NumPy dense-table
builder — so it can catch bugs in the table pipeline.
"""

from __future__ import annotations

from phfpfac_tpu_torch.frontend.patterns import Pattern, shard_patterns, sort_patterns
from phfpfac_tpu_torch.utils.config import PfacConfig


def _build_trie(patterns: list[Pattern]) -> tuple[dict, int]:
    """dict-of-dicts trie; node key 'fin' holds the (shard-local idx,
    global id) of the pattern ending here.  Later duplicates overwrite
    earlier ones, as in the reference."""
    root: dict = {}
    for idx, pat in enumerate(patterns):
        node = root
        for b in pat.data:
            node = node.setdefault(b, {})
        node["fin"] = pat.pattern_id
    return root, len(patterns)


def _walk_limit(pos: int, input_size: int, max_pat_len: int, cfg: PfacConfig) -> int:
    """Exclusive upper bound on byte indices a walk from ``pos`` may read."""
    if cfg.truncation == "segment":
        seg_end = (pos // cfg.segment_bytes + 1) * cfg.segment_bytes
        return min(input_size, seg_end + cfg.halo_bytes)
    return min(input_size, pos + max_pat_len)


def oracle_match_lists(
    patterns: list[Pattern],
    data: bytes,
    cfg: PfacConfig,
    *,
    input_size: int | None = None,
) -> list[list[int]]:
    """Per-position global pattern ids, shard-major then increasing length.

    ``input_size`` defaults to len(data); the reference CLI uses
    ``filesize - 1`` (main.cc:138) — the caller handles that quirk.
    """
    if input_size is None:
        input_size = len(data)
    ordered = sort_patterns(patterns)
    shards = shard_patterns(ordered, cfg.num_shards)
    max_pat_len = max((len(p) for p in ordered), default=0)

    per_pos: list[list[int]] = [[] for _ in range(input_size)]
    for shard in shards:
        if not shard:
            continue
        trie, _ = _build_trie(shard)
        shard_max = max(len(p) for p in shard)
        for pos in range(input_size):
            limit = _walk_limit(pos, input_size, shard_max, cfg)
            node = trie
            i = pos
            while i < limit:
                node = node.get(data[i])
                if node is None:
                    break
                fin = node.get("fin")
                if fin is not None:
                    per_pos[pos].append(fin)
                i += 1
    return per_pos


def match_oracle(
    patterns: list[Pattern],
    data: bytes,
    cfg: PfacConfig,
    *,
    input_size: int | None = None,
) -> list[tuple[int, int]]:
    """Flat [(position, global pattern id)] in output-file order."""
    per_pos = oracle_match_lists(patterns, data, cfg, input_size=input_size)
    return [(pos, pid) for pos, pids in enumerate(per_pos) for pid in pids]


def match_oracle_charset(
    class_patterns,  # list[frontend.charset.ClassPattern]
    data: bytes,
    cfg: PfacConfig,
    *,
    input_size: int | None = None,
) -> list[tuple[int, int]]:
    """Brute-force oracle for charset-class dictionaries.

    Engine ordering contract: per position, increasing match length;
    equal-length matches (same DFA final state) in pattern file order
    (the subset construction collects outputs in ascending NFA id =
    insertion order, charset_table_reorder.c:404-411)."""
    if input_size is None:
        input_size = len(data)
    out: list[tuple[int, int]] = []
    for pos in range(input_size):
        found: list[tuple[int, int]] = []  # (len, id)
        for cp in class_patterns:
            L = len(cp.classes)
            limit = _walk_limit(pos, input_size, L, cfg)
            if pos + L > limit:
                continue
            if all(data[pos + j] in cls for j, cls in enumerate(cp.classes)):
                found.append((L, cp.pattern_id))
        found.sort()  # by length, then id (== file order)
        out.extend((pos, pid) for _L, pid in found)
    return out
