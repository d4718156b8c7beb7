"""Dry run of the multi-device path: every mesh matcher, on the devices
given, against the host oracle.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.
``devices`` is an explicit list in which one device may appear more than
once (``["cuda:0"] * 4`` carries a four-cell mesh on one card,
``["cpu"] * 8`` on the CPU); the default is every visible CUDA device.
"""

from __future__ import annotations

import numpy as np

from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.oracle.ac import match_oracle
from phfpfac_tpu_torch.parallel.distributed import MultiHostMatcher
from phfpfac_tpu_torch.parallel.mesh import DistributedMatcher, make_mesh
from phfpfac_tpu_torch.parallel.mesh_pallas import (
    PallasMeshMatcher,
    PlanMeshMatcher,
)
from phfpfac_tpu_torch.utils.config import PfacConfig

WORDS = [b"the", b"then", b"there", b"cat", b"dog", b"do", b"a", b"an"]
TEXT = b"the cat sat on the dog and then there was an end "


def _tuples(matches) -> list:
    return [tuple(x) for x in np.asarray(matches).tolist()]


def _synthetic(seed: int, n_words: int, n_bytes: int):
    """A dictionary of distinct lowercase words of 2-14 B and a text
    that holds them among random letters."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    words = list(dict.fromkeys(
        bytes(alpha[rng.integers(0, 26, int(rng.integers(2, 15)))])
        for _ in range(n_words)))
    buf = alpha[rng.integers(0, 27, n_bytes)]
    for k in range(0, n_bytes - 64, 97):
        w = words[int(rng.integers(0, len(words)))]
        buf[k:k + len(w)] = np.frombuffer(w, np.uint8)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    return pats, buf.tobytes()


def dryrun_multichip(n_cells: int, devices=None, *, seed: int = 0) -> dict:
    """One scan step of every mesh matcher over an ``n_cells`` mesh
    (data x patterns), each output equal to the oracle's; raises
    ``RuntimeError`` on a mismatch.  Returns the match counts it
    verified."""
    if devices is not None:
        devices = list(devices)[:n_cells]

    def same(got, want, what):
        if _tuples(got) != want:
            raise RuntimeError(
                f"{what} mismatch: {len(got)} vs {len(want)} matches")
        return len(want)

    n_pat = 2 if n_cells % 2 == 0 else 1
    n_data = n_cells // n_pat
    mesh = make_mesh(n_data, n_pat, devices)
    pats = [Pattern(i + 1, w) for i, w in enumerate(WORDS)]
    data = TEXT * 40
    out = dict(mesh=(n_data, n_pat))

    # the turbo mesh under the reference's segment cut
    cfg = PfacConfig(width=256, num_shards=n_pat)
    out["turbo"] = same(
        DistributedMatcher(compile_patterns(pats, cfg), cfg, mesh).match(data),
        match_oracle(pats, data, cfg), "turbo mesh")

    # the depth and the plan kernel per cell, exact mode, the plan
    # tables trained on the corpus
    cfg2 = PfacConfig(width=256, num_shards=n_pat, truncation="none")
    compiled2 = compile_patterns(pats, cfg2)
    want2 = match_oracle(pats, data, cfg2)
    out["depth"] = same(PallasMeshMatcher(compiled2, cfg2, mesh).match(data),
                        want2, "depth mesh")
    out["plan"] = same(
        PlanMeshMatcher(compiled2, cfg2, mesh, train=data).match(data),
        want2, "plan mesh")

    # a larger dictionary over 256 KiB: table stacking and padding at
    # real shard geometries, and the two-phase compacted scan per cell
    big_pats, big_data = _synthetic(seed, 2600, 256 << 10)
    cfg3 = PfacConfig(width=1024, num_shards=n_pat, truncation="none")
    compiled3 = compile_patterns(big_pats, cfg3)
    want3 = match_oracle(big_pats, big_data, cfg3)
    out["scaled_turbo"] = same(
        DistributedMatcher(compiled3, cfg3, mesh).match(big_data), want3,
        "scaled turbo mesh")
    out["scaled_depth"] = same(
        PallasMeshMatcher(compiled3, cfg3, mesh).match(big_data), want3,
        "scaled depth mesh")
    out["scaled_plan"] = same(
        PlanMeshMatcher(compiled3, cfg3, mesh, train=big_data).match(big_data),
        want3, "scaled plan mesh")
    out["scaled_plan_compacted"] = same(
        PlanMeshMatcher(compiled3, cfg3, mesh, train=big_data,
                        compact=(2, 8192)).match(big_data),
        want3, "scaled compacted plan mesh")

    # the stacked plan tables over the patterns axis: 4 shards
    if n_cells >= 4 and n_cells % 4 == 0:
        mesh4 = make_mesh(n_cells // 4, 4, devices)
        cfg4 = PfacConfig(width=1024, num_shards=4, truncation="none")
        small, data4 = big_pats[:1200], big_data[: 64 << 10]
        pmm4 = PlanMeshMatcher(compile_patterns(small, cfg4), cfg4, mesh4,
                               train=data4)
        if pmm4.stacked is None or pmm4.stacked.num_shards != 4:
            raise RuntimeError("the stacked plan tables were not built")
        out["stacked_plan"] = same(pmm4.match(data4),
                                   match_oracle(small, data4, cfg4),
                                   "stacked plan mesh")

    # the serving wrapper must ride the plan mesh here, not the turbo one
    mh = MultiHostMatcher(compiled3, cfg3, devices=devices)
    out["multihost"] = same(mh.match(big_data), want3, "MultiHostMatcher")
    if mh.last_engine != "plan":
        raise RuntimeError(
            f"MultiHostMatcher scanned with engine {mh.last_engine!r}: the "
            f"plan mesh must run here")
    out["multihost_engine"] = mh.last_engine
    return out
