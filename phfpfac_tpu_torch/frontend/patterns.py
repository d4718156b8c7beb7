"""Pattern-file frontend: reading, escape decoding, sorting, sharding.

Reference semantics (CreateTable/create_table_reorder.c):

* ``read_pattern`` (:53-122): patterns are newline-separated byte
  strings (binary read, so '\\r' is kept), each < 1024 bytes, assigned
  **1-based** ids in file order, then sorted with ``comp_pat`` (:21-45)
  = memcmp over the common prefix, shorter-first on ties.  Sorting puts
  every prefix before its extensions, which the trie builder relies on.
* ``read_pattern_ext`` (:131-185) + ``fgetc_ext`` (ctdef.h:37-99):
  escape-aware variant decoding ``\\n``-style escapes, ``\\xNN`` hex and
  ``\\ooo`` octal (defined but never called in the reference; here it is
  the ``escapes=True`` option).
* ``divide_patterns`` (:253-274): splits the *sorted* list into
  ``num_shards`` contiguous shards: the first n-1 shards get
  ``k = N // num_shards`` patterns, the last gets ``k + N % num_shards``.
  (The reference hardcodes num_shards = 4 * streamnum at :207,217; here
  the shard count is a parameter so the mesh can decide.)
"""

from __future__ import annotations

from dataclasses import dataclass

from phfpfac_tpu_torch.utils.config import MAX_PATTERN_LEN

_SIMPLE_ESCAPES = {
    ord("a"): 0x07,
    ord("b"): 0x08,
    ord("t"): 0x09,
    ord("n"): 0x0A,
    ord("v"): 0x0B,
    ord("f"): 0x0C,
    ord("r"): 0x0D,
    ord("'"): ord("'"),
    ord('"'): ord('"'),
    ord("\\"): ord("\\"),
}


@dataclass(frozen=True)
class Pattern:
    """A dictionary pattern.

    ``pattern_id`` is 1-based in file order (create_table_reorder.c:100:
    the counter is incremented before the pattern is stored, so the
    first pattern gets id 1).
    """

    pattern_id: int
    data: bytes

    def __len__(self) -> int:
        return len(self.data)


def decode_escaped_line(line: bytes) -> bytes:
    """Decode one pattern line with fgetc_ext escape semantics (ctdef.h:37-99).

    Supports ``\\a \\b \\t \\n \\v \\f \\r \\' \\" \\\\``, ``\\xNN`` hex
    (up to 2 digits) and ``\\ooo`` octal (up to 3 digits, value truncated
    to a byte).  A backslash followed by anything else is a literal
    backslash (the next char is re-examined), matching the reference's
    ``ungetc`` fall-through (ctdef.h:86-89).
    """
    out = bytearray()
    i = 0
    n = len(line)
    while i < n:
        c = line[i]
        if c != ord("\\"):
            out.append(c)
            i += 1
            continue
        if i + 1 >= n:
            # trailing backslash at EOF returns '\\' (ctdef.h:49-51)
            out.append(c)
            i += 1
            continue
        nxt = line[i + 1]
        if ord("0") <= nxt <= ord("9"):
            # \ooo octal, fscanf("%3o") consumes up to 3 octal digits
            # (a leading 8/9 digit makes fscanf parse zero digits ->
            # value stays 0; we mimic by consuming the digits greedily
            # as octal and stopping at the first non-octal digit).
            j = i + 1
            val = 0
            ndig = 0
            while j < n and ndig < 3 and ord("0") <= line[j] <= ord("7"):
                val = val * 8 + (line[j] - ord("0"))
                j += 1
                ndig += 1
            if ndig == 0:
                # '\8' or '\9': fscanf matches nothing, value=0, and the
                # digit remains in the stream to be read as a literal.
                out.append(0)
                i += 1  # consume only the backslash
                continue
            out.append(val & 0xFF)
            i = j
            continue
        if nxt in _SIMPLE_ESCAPES:
            out.append(_SIMPLE_ESCAPES[nxt])
            i += 2
            continue
        if nxt == ord("x"):
            j = i + 2
            val = 0
            ndig = 0
            while j < n and ndig < 2 and chr(line[j]) in "0123456789abcdefABCDEF":
                val = val * 16 + int(chr(line[j]), 16)
                j += 1
                ndig += 1
            if ndig == 0:
                raise ValueError(r"Syntax error: \x used with no following hex digits")
            out.append(val & 0xFF)
            i = j
            continue
        # not an escape: emit the backslash, re-examine next char
        out.append(c)
        i += 1
    return bytes(out)


def read_patterns(path: str, *, escapes: bool = False) -> list[Pattern]:
    """Read a newline-separated pattern file into 1-based-id patterns.

    Mirrors ``read_pattern`` (create_table_reorder.c:53-122): binary
    read, split on '\\n' (so '\\r' is preserved inside patterns), ids
    assigned in file order starting at 1, length capped at 1023 bytes.
    A final unterminated line is accepted as a pattern (the reference
    requires a trailing newline; we are lenient).  Empty lines are
    rejected — the reference has undefined behavior for them.
    """
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    patterns: list[Pattern] = []
    for idx, line in enumerate(lines):
        if escapes:
            line = decode_escaped_line(line)
        if len(line) >= MAX_PATTERN_LEN:
            raise ValueError(
                f"Pattern {idx + 1} length over {MAX_PATTERN_LEN}."
            )  # create_table_reorder.c:74-77
        if not line:
            raise ValueError(
                f"Pattern {idx + 1} is empty (unsupported by PFAC; the "
                "reference has undefined behavior for empty lines)"
            )
        patterns.append(Pattern(pattern_id=idx + 1, data=line))
    if not patterns:
        raise ValueError(f"no patterns in {path}")
    return patterns


def sort_patterns(patterns: list[Pattern]) -> list[Pattern]:
    """Sort patterns with comp_pat semantics (create_table_reorder.c:21-45).

    Python ``bytes`` comparison is exactly memcmp-with-shorter-first, and
    the sort is stable, so duplicate patterns keep file order (the later
    duplicate then wins the trie's final transition, matching the
    reference's overwrite at create_table_reorder.c:366).
    """
    return sorted(patterns, key=lambda p: p.data)


def shard_patterns(
    sorted_patterns: list[Pattern], num_shards: int
) -> list[list[Pattern]]:
    """Split sorted patterns into contiguous shards (divide_patterns, :253-274).

    Shards 0..n-2 get ``k = N // num_shards`` patterns each; the last
    shard gets ``k + N % num_shards``.  If there are fewer patterns
    than shards, the leading shards are empty and the last gets them
    all (k = 0 degenerate case, same as the reference).
    """
    n = len(sorted_patterns)
    k = n // num_shards
    shards = [
        sorted_patterns[i * k : (i + 1) * k] for i in range(num_shards - 1)
    ]
    shards.append(sorted_patterns[(num_shards - 1) * k :])
    return shards
