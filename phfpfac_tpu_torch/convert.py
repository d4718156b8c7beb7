"""Tables carried across from the JAX package, as numpy arrays.

The host compilers of the two packages are the same code, so the port
can also scan with tables the JAX package built: these functions turn
the JAX package's serialized forms into the port's objects.  Nothing
here imports the JAX package; the caller hands over plain arrays.
"""

from __future__ import annotations

import numpy as np

from phfpfac_tpu_torch.compile.depth import DepthTables
from phfpfac_tpu_torch.compile.pair import PairTables
from phfpfac_tpu_torch.compile.plan import PlanTables, plan_tables_from
from phfpfac_tpu_torch.compile.tables import CompiledDictionary
from phfpfac_tpu_torch.ops.turbo import TurboTables


def plan_tables_from_arrays(arrays: dict, meta: dict) -> PlanTables:
    """PlanTables from ``compile.plan.plan_tables_arrays(pt, prefix)``'s
    (arrays, meta), whatever the prefix."""
    (key,) = [k for k in arrays if k.endswith("code_of")]
    return plan_tables_from(arrays, key[: -len("code_of")], meta)


def depth_tables_from_arrays(
    *, s0_banks, packed_banks, offs, nbs, k0s, n_steps: int,
    max_pat_len: int, num_final: int,
) -> DepthTables:
    """DepthTables from the fields of the JAX package's DepthTables."""
    return DepthTables(
        s0_banks=np.asarray(s0_banks, np.int32),
        packed_banks=np.asarray(packed_banks, np.int32),
        offs=tuple(int(x) for x in offs),
        nbs=tuple(int(x) for x in nbs),
        k0s=tuple(int(x) for x in k0s),
        n_steps=int(n_steps),
        max_pat_len=int(max_pat_len),
        num_final=int(num_final),
    )


def _ints(xs) -> tuple:
    return tuple(int(x) for x in xs)


def pair_tables_from_arrays(
    *, code_of, p0_banks, packed_banks, side_banks, p_offs, p_nbs, p_k0s,
    s_offs, s_nbs, s_k0s, s_nibbles, n_pair_steps: int, code_bits: int,
    disp_miss: int, max_pat_len: int = 0,
) -> PairTables:
    """PairTables from the fields of the JAX package's PairTables."""
    return PairTables(
        code_of=np.asarray(code_of),
        code_bits=int(code_bits),
        p0_banks=np.asarray(p0_banks, np.int32),
        packed_banks=np.asarray(packed_banks, np.int32),
        side_banks=np.asarray(side_banks, np.int32),
        p_offs=_ints(p_offs), p_nbs=_ints(p_nbs), p_k0s=_ints(p_k0s),
        s_offs=_ints(s_offs), s_nbs=_ints(s_nbs), s_k0s=_ints(s_k0s),
        n_pair_steps=int(n_pair_steps),
        disp_miss=int(disp_miss),
        max_pat_len=int(max_pat_len),
        s_nibbles=tuple(bool(x) for x in s_nibbles),
    )


def turbo_tables_from_arrays(
    *, s0, r, packed, ht, val, width_bit: int, row_bits: int, dead: int,
    num_final: int, max_pat_len: int,
) -> TurboTables:
    """TurboTables from the fields of the JAX package's TurboTables
    (``packed`` or ``ht``/``val`` is None)."""
    def arr(a):
        return None if a is None else np.asarray(a, np.int32)

    return TurboTables(
        s0=arr(s0), r=arr(r), packed=arr(packed), ht=arr(ht), val=arr(val),
        width_bit=int(width_bit), row_bits=int(row_bits), dead=int(dead),
        num_final=int(num_final), max_pat_len=int(max_pat_len),
    )


def compiled_from_npz(path) -> CompiledDictionary:
    """A dictionary written by the JAX package's
    ``CompiledDictionary.save`` (formats v1-v3)."""
    return CompiledDictionary.load(path)
