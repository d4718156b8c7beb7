"""Tables carried across from the JAX package, as numpy arrays.

The host compilers of the two packages are the same code, so the port
can also scan with tables the JAX package built: these functions turn
the JAX package's serialized forms into the port's objects.  Nothing
here imports the JAX package; the caller hands over plain arrays.
"""

from __future__ import annotations

import numpy as np

from phfpfac_tpu_torch.compile.depth import DepthTables
from phfpfac_tpu_torch.compile.plan import PlanTables, plan_tables_from
from phfpfac_tpu_torch.compile.tables import CompiledDictionary


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


def compiled_from_npz(path) -> CompiledDictionary:
    """A dictionary written by the JAX package's
    ``CompiledDictionary.save`` (formats v1-v3)."""
    return CompiledDictionary.load(path)
