"""Charset-class pattern frontend: [a-z] / [^...] classes -> PFAC table.

Rebuilds the reference's vestigial regex frontend
(CreateTable/charset_table_reorder.c — not compiled into gphf, but the
documented intent of "regex_GPU_PHF"):

* ``build_NFA`` (:45-126): each pattern is a linear NFA chain whose
  edges are single bytes or byte classes (``fgetc_set`` :128-168
  parses ``[a-z]`` ranges and ``[^...]`` negation, with fgetc_ext
  escapes);
* ``NFA2DFA`` (:321-427): subset construction, subsets as sorted NFA
  id lists, BFS order; a DFA state collects the output pattern ids of
  every NFA final it contains (multi-output states);
* ``mark_DFA_id`` (:429-469): the "reorder" — final states are
  numbered first so the device test is one comparison.

Differences from the reference (deliberate, documented):
* numbering follows the live pipeline's contract (finals 0..F-1,
  initial = F+1, create_table_reorder.c:288-292) instead of the dead
  code's 1-based variant, so the compiled table drops into the same
  PHF + kernels;
* class parsing runs on decoded lines: an *unescaped* ``[`` opens a
  class, ``\\[`` is a literal (the reference treats even escaped
  brackets as class openers — an artifact of fgetc_ext layering).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from phfpfac_tpu_torch.frontend.patterns import _SIMPLE_ESCAPES
from phfpfac_tpu_torch.utils.config import CHAR_SET, MAX_PATTERN_LEN


@dataclass(frozen=True)
class ClassPattern:
    """A pattern whose elements are byte classes (singletons for
    literal bytes)."""

    pattern_id: int  # 1-based file order
    classes: tuple[frozenset, ...]

    def __len__(self) -> int:
        return len(self.classes)


def _decode_tokens(line: bytes) -> list[tuple[int, bool]]:
    """[(byte, was_escaped)] with fgetc_ext escape semantics."""
    out: list[tuple[int, bool]] = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c != ord("\\") or i + 1 >= n:
            out.append((c, False))
            i += 1
            continue
        nxt = line[i + 1]
        if ord("0") <= nxt <= ord("9"):
            j, val, ndig = i + 1, 0, 0
            while j < n and ndig < 3 and ord("0") <= line[j] <= ord("7"):
                val = val * 8 + (line[j] - ord("0"))
                j += 1
                ndig += 1
            if ndig == 0:
                out.append((0, True))
                i += 1
                continue
            out.append((val & 0xFF, True))
            i = j
            continue
        if nxt in _SIMPLE_ESCAPES:
            out.append((_SIMPLE_ESCAPES[nxt], True))
            i += 2
            continue
        if nxt in (ord("["), ord("]"), ord("-"), ord("^")):
            # charset metacharacters escape to literals here (the
            # reference's fgetc_ext leaves them unescaped, making
            # literal brackets inexpressible — deliberate improvement)
            out.append((nxt, True))
            i += 2
            continue
        if nxt == ord("x"):
            j, val, ndig = i + 2, 0, 0
            while j < n and ndig < 2 and chr(line[j]) in "0123456789abcdefABCDEF":
                val = val * 16 + int(chr(line[j]), 16)
                j += 1
                ndig += 1
            if ndig == 0:
                raise ValueError(r"Syntax error: \x used with no hex digits")
            out.append((val & 0xFF, True))
            i = j
            continue
        out.append((c, False))
        i += 1
    return out


def parse_class_pattern(line: bytes, pattern_id: int) -> ClassPattern:
    """Parse one pattern line with classes and escapes."""
    toks = _decode_tokens(line)
    classes: list[frozenset] = []
    i, n = 0, len(toks)
    while i < n:
        b, esc = toks[i]
        if b == ord("[") and not esc:
            i += 1
            negate = False
            if i < n and toks[i] == (ord("^"), False):
                negate = True
                i += 1
            members: set[int] = set()
            last: int | None = None
            while i < n and toks[i] != (ord("]"), False):
                b2, esc2 = toks[i]
                if b2 == ord("-") and not esc2 and last is not None and (
                    i + 1 < n and toks[i + 1] != (ord("]"), False)
                ):
                    hi = toks[i + 1][0]
                    members.update(range(last, hi + 1))
                    i += 2
                    last = None
                    continue
                members.add(b2)
                last = b2
                i += 1
            if i >= n:
                raise ValueError(f"unterminated class in pattern {pattern_id}")
            i += 1  # consume ']'
            if negate:
                members = set(range(CHAR_SET)) - members
            if not members:
                raise ValueError(f"empty class in pattern {pattern_id}")
            classes.append(frozenset(members))
        else:
            classes.append(frozenset((b,)))
            i += 1
    if not classes:
        raise ValueError(f"Pattern {pattern_id} is empty")
    if len(classes) >= MAX_PATTERN_LEN:
        raise ValueError(f"Pattern {pattern_id} length over {MAX_PATTERN_LEN}.")
    return ClassPattern(pattern_id=pattern_id, classes=tuple(classes))


def read_class_patterns(path: str) -> list[ClassPattern]:
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    return [parse_class_pattern(ln, i + 1) for i, ln in enumerate(lines)]


@dataclass
class ClassTrie:
    """Determinized class-pattern automaton, PFAC-numbered."""

    table: np.ndarray  # int32 [state_count, 256]
    state_num: int
    final_state_num: int
    max_pat_len: int
    pattern_id_map: np.ndarray  # int32 [F]: final -> primary global id
    output_lists: dict[int, list[int]]  # final -> ALL global ids
    final_depths: np.ndarray  # int32 [F]: final -> match length (bytes)

    @property
    def initial_state(self) -> int:
        return self.final_state_num + 1


def build_class_trie(patterns: list[ClassPattern]) -> ClassTrie:
    """NFA -> subset construction -> finals-first numbering -> table.

    The NFA is the union of linear chains (build_NFA); DFA states are
    frozensets of NFA ids explored in BFS order (NFA2DFA); finals get
    0..F-1 in discovery order, the root gets F+1, interiors F+2..
    (mark_DFA_id's reorder, shifted to the live pipeline's 0-base).

    Precondition: ``patterns`` carry ASCENDING pattern_ids (file order,
    as read_class_patterns produces).  A final's output list and the
    sharded merge (parallel.merge._merge_charset) rely on it for the
    canonical (pos, len, id) order equalling the single-shard order;
    non-monotonic ids would yield a deterministic but DIFFERENT order
    (ADVICE r4).
    """
    assert all(
        patterns[i].pattern_id < patterns[i + 1].pattern_id
        for i in range(len(patterns) - 1)
    ), "class patterns must carry ascending pattern_ids"
    # --- linear NFA ------------------------------------------------------
    # node 0 = root; edges[node] = {byte: [next...]}; finals[node] = pid
    edges: list[dict[int, list[int]]] = [{}]
    finals: dict[int, int] = {}
    max_len = 0
    for pat in patterns:
        max_len = max(max_len, len(pat.classes))
        cur = 0
        for cls in pat.classes:
            nxt = len(edges)
            edges.append({})
            e = edges[cur]
            for b in cls:
                e.setdefault(b, []).append(nxt)
            cur = nxt
        finals[cur] = pat.pattern_id  # later duplicates overwrite

    # --- subset construction (BFS) ---------------------------------------
    root = (0,)
    subsets: dict[tuple, int] = {root: 0}  # subset -> discovery index
    order: list[tuple] = [root]
    trans: list[dict[int, int]] = []
    qi = 0
    while qi < len(order):
        cur = order[qi]
        qi += 1
        nxt_map: dict[int, set] = {}
        for nid in cur:
            for b, dests in edges[nid].items():
                nxt_map.setdefault(b, set()).update(dests)
        row: dict[int, int] = {}
        for b, dests in nxt_map.items():
            key = tuple(sorted(dests))
            if key not in subsets:
                subsets[key] = len(order)
                order.append(key)
            row[b] = subsets[key]
        trans.append(row)

    # --- finals-first numbering -------------------------------------------
    is_final = [any(n in finals for n in sub) for sub in order]
    F = sum(is_final)
    number = np.empty(len(order), dtype=np.int64)
    fc, ic = 0, F + 2
    for i, sub in enumerate(order):
        if is_final[i]:
            number[i] = fc
            fc += 1
        elif i == 0:
            number[i] = F + 1
        else:
            number[i] = ic
            ic += 1
    state_count = ic

    table = np.full((state_count, CHAR_SET), -1, dtype=np.int32)
    for i, row in enumerate(trans):
        for b, j in row.items():
            table[number[i], b] = number[j]

    pattern_id_map = np.zeros(max(F, 0), dtype=np.int32)
    output_lists: dict[int, list[int]] = {}
    final_depths = np.zeros(max(F, 0), dtype=np.int32)
    len_of = {p.pattern_id: len(p.classes) for p in patterns}
    for i, sub in enumerate(order):
        if not is_final[i]:
            continue
        ids = [finals[n] for n in sub if n in finals]  # NFA-id ascending
        fidx = int(number[i])
        pattern_id_map[fidx] = ids[0]
        output_lists[fidx] = ids
        # every NFA node in a subset sits at the same walk depth, so a
        # final's matches all share one length — recorded for the
        # shard-count-invariant (pos, length, id) merge order
        final_depths[fidx] = len_of[ids[0]]
    return ClassTrie(
        table=table,
        state_num=state_count,
        final_state_num=F,
        max_pat_len=max_len,
        pattern_id_map=pattern_id_map,
        output_lists=output_lists,
        final_depths=final_depths,
    )
