"""Dictionary compilation pipeline: patterns -> per-shard device tables.

Combines the frontend (read/sort/shard, create_table_reorder.c:201-251),
the trie builder and the FFDM PHF packer, and adds what the reference
lacks: compiled-table serialization (save/load), so the slow host build
runs once (the reference rebuilds tables on every invocation).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from phfpfac_tpu_torch.compile.phf import PhfTable, build_phf
from phfpfac_tpu_torch.compile.trie import TrieTables, build_pfac_trie
from phfpfac_tpu_torch.frontend.patterns import (
    Pattern,
    read_patterns,
    shard_patterns,
    sort_patterns,
)
from phfpfac_tpu_torch.utils.config import CHAR_SET, PfacConfig


class ShardTables:
    """Everything one device needs to scan with one dictionary shard.

    This is the TPU analog of the reference ``thread_data``
    (main.cc:19-32): s0 row + PHF (r, HT, val) + shape metadata.

    The PHF is LAZY: the reference builds it unconditionally
    (main.cc:122-126) because its kernel probes it, but the fast TPU
    engines (compile.plan/pair/depth) derive their own tables straight
    from the dense trie, so the FFDM pack — the slowest host-compile
    phase at scale — runs only when an engine, the serializer, or a
    stats report actually touches ``r``/``ht``/``val``/``ht_size``.
    Construct with either ``r/ht/val/ht_size`` (eager, e.g. loaded
    from disk) or ``dense`` (the trie table; PHF built on demand).
    """

    def __init__(
        self,
        *,
        state_num: int,
        final_state_num: int,  # k: states 0..k-1 are final
        max_pat_len: int,
        width: int,
        s0: np.ndarray,  # int32 [256]
        pattern_id_map: np.ndarray,  # int32 [k] local final -> global 1-based id
        ht_size: int | None = None,
        r: np.ndarray | None = None,  # int32 [dev_rows]
        ht: np.ndarray | None = None,  # int32 [ht_size]
        val: np.ndarray | None = None,  # int32 [ht_size]
        dense: np.ndarray | None = None,  # int32 [state_num, 256] trie table
        patterns: list | None = None,  # sorted pattern bytes (bitmap decode)
        output_lists: dict | None = None,  # final -> ALL ids (charset)
        final_depths: np.ndarray | None = None,  # int32 [k] match length
    ):
        self.state_num = state_num
        self.final_state_num = final_state_num
        self.max_pat_len = max_pat_len
        self.width = width
        self.s0 = s0
        self.pattern_id_map = pattern_id_map
        self.patterns = patterns
        self.output_lists = output_lists
        self.final_depths = final_depths
        self._r, self._ht, self._val, self._ht_size = r, ht, val, ht_size
        self._dense = dense
        if r is None and dense is None and (
            patterns is None or output_lists is not None
        ):
            # charset shards (output_lists) cannot rebuild their DFA
            # from raw patterns — they must come with a PHF or dense
            raise ValueError("need a PHF, a dense table, or patterns")

    @property
    def width_bit(self) -> int:
        return self.width.bit_length() - 1

    # ---------------- lazy PHF --------------------------------------

    @property
    def has_phf(self) -> bool:
        return self._r is not None

    def ensure_phf(self) -> None:
        """Build the PHF from the dense trie if not yet present."""
        if self._r is not None:
            return
        phf = build_phf(self.dense_table(), self.width)
        if phf.ht_size == 0:
            # degenerate empty shard: keep a real (never-verifying)
            # buffer so device gathers stay in bounds
            phf.ht = np.full(1, -1, dtype=np.int32)
            phf.val = np.full(1, -1, dtype=np.int32)
        # _r is the presence gate (has_phf): assign it LAST so a
        # concurrent reader that sees it also sees the other fields
        self._ht, self._val, self._ht_size = phf.ht, phf.val, phf.ht_size
        self._r = phf.r

    @property
    def r(self) -> np.ndarray:
        self.ensure_phf()
        return self._r

    @property
    def ht(self) -> np.ndarray:
        self.ensure_phf()
        return self._ht

    @property
    def val(self) -> np.ndarray:
        self.ensure_phf()
        return self._val

    @property
    def ht_size(self) -> int:
        self.ensure_phf()
        return self._ht_size

    # ---------------- dense trie table ------------------------------

    def dense_table(self) -> np.ndarray:
        """The dense int32 [state_num, 256] transition table.

        Priority: the cached trie table (set at compile time) > invert
        an already-built PHF (O(ht_size), vectorized — loaded-from-
        disk dictionaries; compile.depth._reconstruct_dense) > rebuild
        the trie from the stored sorted patterns.

        The result is CACHED for the shard's lifetime (bitmap decode
        re-walks hit positions through it on every match when the PHF
        is lazy) — ~1 KB/state of host RAM at Snort scale.
        """
        if self._dense is not None:
            return self._dense
        if self.has_phf:
            from phfpfac_tpu_torch.compile.depth import _reconstruct_dense

            self._dense = _reconstruct_dense(self)
        else:
            from phfpfac_tpu_torch.compile.trie import build_pfac_trie
            from phfpfac_tpu_torch.frontend.patterns import Pattern

            trie = build_pfac_trie(
                [Pattern(i + 1, p) for i, p in enumerate(self.patterns)]
            )
            self._dense = trie.table
        return self._dense

    def drop_dense(self) -> None:
        """Release the dense-table cache (468 MB at 160k-pattern scale)."""
        self._dense = None


@dataclass
class CompiledDictionary:
    """All shards plus global metadata."""

    shards: list[ShardTables]
    max_pat_len: int  # max over shards (main.cc merge uses it, :304)
    num_patterns: int
    width: int
    # built plan tables per shard (None entries = shard has none) —
    # populated by Matcher.built_plan_tables() after a scan, serialized
    # as format v3 so a fresh process skips the trie + plan build
    plan_tables: list | None = None
    # charset (NFA->DFA) dictionaries merge in the canonical
    # (pos, length, id) order — the only shard-count-invariant order
    # when patterns have no memcmp sort (see parallel/merge.py)
    charset: bool = False

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    # ---------------- serialization (capability the reference lacks;
    # its natural equivalent of checkpoint/resume — SURVEY.md §5) ------

    def save(self, path: str | Path) -> None:
        """Write the compiled dictionary to an .npz.

        A shard whose PHF was never built (lazy — the fast engines
        don't touch it) is saved WITHOUT it; load restores the same
        lazy state, and the trie rebuilds from the stored patterns on
        demand.  Version 3 adds optional per-shard built plan tables
        (``self.plan_tables``, see Matcher.built_plan_tables) so a
        fresh process skips the trie + plan build; files without them
        stay version 2, and version-1 files (PHF always present) load
        unchanged.
        """
        path = Path(path)
        arrays: dict[str, np.ndarray] = {}
        has_plan = self.plan_tables is not None and any(
            p is not None for p in self.plan_tables
        )
        meta = {
            "version": 3 if has_plan else 2,
            "max_pat_len": self.max_pat_len,
            "num_patterns": self.num_patterns,
            "width": self.width,
            "charset": self.charset,
            "shards": [],
        }
        for i, sh in enumerate(self.shards):
            meta["shards"].append(
                {
                    "state_num": sh.state_num,
                    "final_state_num": sh.final_state_num,
                    "max_pat_len": sh.max_pat_len,
                    "width": sh.width,
                    "has_phf": sh.has_phf,
                    **({"ht_size": sh.ht_size} if sh.has_phf else {}),
                }
            )
            names = ("s0", "pattern_id_map") + (
                ("r", "ht", "val") if sh.has_phf else ()
            )
            for name in names:
                arrays[f"shard{i}_{name}"] = getattr(sh, name)
            if sh.output_lists is not None:
                meta["shards"][-1]["output_lists"] = {
                    str(k): v for k, v in sh.output_lists.items()
                }
            if sh.final_depths is not None:
                arrays[f"shard{i}_final_depths"] = sh.final_depths
            if sh.patterns is not None:
                blob = b"".join(sh.patterns)
                offs = np.cumsum([0] + [len(p) for p in sh.patterns])
                arrays[f"shard{i}_patblob"] = np.frombuffer(blob, dtype=np.uint8).copy()
                arrays[f"shard{i}_patoffs"] = offs.astype(np.int64)
            if has_plan and self.plan_tables[i] is not None:
                from phfpfac_tpu_torch.compile.plan import plan_tables_arrays

                p_arr, p_meta = plan_tables_arrays(
                    self.plan_tables[i], f"shard{i}_plan_"
                )
                arrays.update(p_arr)
                meta["shards"][-1]["plan"] = p_meta
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8
        )
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str | Path) -> "CompiledDictionary":
        # NB: each z[key] access decompresses that npz member from the
        # zip anew — members must be read ONCE and sliced in memory
        # (a per-pattern z[...] read made loading the 156k-pattern
        # dictionary quadratic: minutes instead of seconds).
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
            shards = []
            plan_tables: list = []
            for i, m in enumerate(meta["shards"]):
                if "plan" in m:
                    from phfpfac_tpu_torch.compile.plan import plan_tables_from

                    plan_tables.append(
                        plan_tables_from(z, f"shard{i}_plan_", m["plan"])
                    )
                else:
                    plan_tables.append(None)
                has_phf = m.get("has_phf", True)  # v1 always had it
                shards.append(
                    ShardTables(
                        state_num=m["state_num"],
                        final_state_num=m["final_state_num"],
                        max_pat_len=m["max_pat_len"],
                        width=m["width"],
                        ht_size=m["ht_size"] if has_phf else None,
                        s0=z[f"shard{i}_s0"],
                        r=z[f"shard{i}_r"] if has_phf else None,
                        ht=z[f"shard{i}_ht"] if has_phf else None,
                        val=z[f"shard{i}_val"] if has_phf else None,
                        pattern_id_map=z[f"shard{i}_pattern_id_map"],
                        patterns=_split_patblob(z, i),
                        output_lists=(
                            {int(k): v for k, v in m["output_lists"].items()}
                            if "output_lists" in m
                            else None
                        ),
                        final_depths=(
                            z[f"shard{i}_final_depths"]
                            if f"shard{i}_final_depths" in z else None
                        ),
                    )
                )
        return cls(
            shards=shards,
            max_pat_len=meta["max_pat_len"],
            num_patterns=meta["num_patterns"],
            width=meta["width"],
            plan_tables=(
                plan_tables if any(p is not None for p in plan_tables)
                else None
            ),
            charset=meta.get("charset", False),
        )


def _split_patblob(z, i: int) -> list[bytes] | None:
    """Shard i's patterns from the npz: one blob read, in-memory slices."""
    if f"shard{i}_patblob" not in z:
        return None
    if f"shard{i}_patoffs" not in z:
        raise ValueError(
            f"corrupt dictionary file: shard{i}_patblob present but "
            f"shard{i}_patoffs missing"
        )
    blob = z[f"shard{i}_patblob"].tobytes()
    offs = z[f"shard{i}_patoffs"]
    return [blob[a:b] for a, b in zip(offs[:-1], offs[1:])]


def _shard_to_tables(
    trie: TrieTables, phf: PhfTable | None, width: int
) -> ShardTables:
    # Pad degenerate (empty-shard) tables to length >= 1 so device
    # gathers always have a real buffer; the -1 sentinel can never
    # verify as a hit (ht stores only row numbers >= 0).
    if phf is not None and phf.ht_size == 0:
        phf.ht = np.full(1, -1, dtype=np.int32)
        phf.val = np.full(1, -1, dtype=np.int32)
    return ShardTables(
        state_num=trie.state_num,
        final_state_num=trie.final_state_num,
        max_pat_len=trie.max_pat_len,
        width=width,
        ht_size=phf.ht_size if phf is not None else None,
        s0=np.ascontiguousarray(trie.s0, dtype=np.int32),
        r=phf.r if phf is not None else None,
        ht=phf.ht if phf is not None else None,
        val=phf.val if phf is not None else None,
        dense=trie.table,
        pattern_id_map=trie.pattern_id_map,
    )


def compile_patterns(
    patterns: list[Pattern], config: PfacConfig, *, verbose: bool = False
) -> CompiledDictionary:
    """Compile an (unsorted) pattern list into per-shard device tables.

    Shards build concurrently on host threads — the reference's OpenMP
    parallel FFDM loop (main.cc:122-126); the C++ trie/FFDM builders
    (compile.native) release the GIL, so threads scale.
    """
    from concurrent.futures import ThreadPoolExecutor

    ordered = sort_patterns(patterns)
    shards_pat = shard_patterns(ordered, config.num_shards)

    def build_one(sp):
        trie = build_pfac_trie(sp)
        # the PHF stays lazy (ShardTables.ensure_phf) unless the stats
        # report needs it — the fast TPU engines never touch it
        phf = build_phf(trie.table, config.width) if verbose else None
        st = _shard_to_tables(trie, phf, config.width)
        st.patterns = [p.data for p in sp]
        return st, phf

    if len(shards_pat) > 1:
        with ThreadPoolExecutor(
            max_workers=min(len(shards_pat), os.cpu_count() or 4)
        ) as pool:
            built = list(pool.map(build_one, shards_pat))
    else:
        built = [build_one(sp) for sp in shards_pat]

    shards = [st for st, _ in built]
    if verbose:
        for _, phf in built:
            print(phf.stats_report())
    max_pat_len = max((st.max_pat_len for st in shards), default=0)
    return CompiledDictionary(
        shards=shards,
        max_pat_len=max_pat_len,
        num_patterns=len(patterns),
        width=config.width,
    )


def compile_dictionary(
    pattern_file: str,
    config: PfacConfig,
    *,
    escapes: bool = False,
    verbose: bool = False,
) -> CompiledDictionary:
    """Read + compile a pattern file (create_PFAC_table_reorder.c:6-11 facade)."""
    patterns = read_patterns(pattern_file, escapes=escapes)
    return compile_patterns(patterns, config, verbose=verbose)


def dense_lookup(trie_table: np.ndarray, state: int, ch: int) -> int:
    """Dense-table transition (for tests)."""
    if state < 0 or state >= trie_table.shape[0] or not 0 <= ch < CHAR_SET:
        return -1
    return int(trie_table[state, ch])
