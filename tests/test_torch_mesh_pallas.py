"""The port's kernel meshes (parallel.mesh_pallas, plain versions on the
CPU) against the JAX package's classes in interpret mode and the oracle:
the same seeded bytes and dictionary through both, match lists and
bitmaps compared exactly (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.parallel import mesh_pallas as jax_mp
from phfpfac_tpu.parallel.mesh import make_mesh as jax_make_mesh
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch.compile.depth import DepthUnsupported
from phfpfac_tpu_torch.compile.pair import PairUnsupported
from phfpfac_tpu_torch.compile.plan import build_stacked_plan_tables
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.convert import (
    stacked_depth_tables_from_arrays,
    stacked_plan_tables_from_arrays,
)
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import plan as plan_ops
from phfpfac_tpu_torch.ops.staging import TILE
from phfpfac_tpu_torch.oracle.ac import match_oracle
from phfpfac_tpu_torch.parallel.matcher import Matcher
from phfpfac_tpu_torch.parallel.mesh import make_mesh
from phfpfac_tpu_torch.parallel.mesh_pallas import (
    PallasMeshMatcher,
    PlanMeshMatcher,
    stack_depth_tables,
    stacked_plan_shard,
)
from phfpfac_tpu_torch.utils.config import PfacConfig

CPU8 = ["cpu"] * 8
ALPHA = np.frombuffer(b"abcdefgh ", np.uint8)


def _words(seed=3, n=120, lo=2, hi=12):
    rng = np.random.default_rng(seed)
    return list(dict.fromkeys(
        bytes(ALPHA[rng.integers(0, 8, int(rng.integers(lo, hi)))])
        for _ in range(n)))


def _text(seed, n):
    rng = np.random.default_rng(seed)
    return bytes(ALPHA[rng.integers(0, 9, n)])


def _both(words, num_shards, width=1024, **kw):
    kw = dict(width=width, num_shards=num_shards, truncation="none", **kw)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    cfg = PfacConfig(**kw)
    jcfg = JaxConfig(interpret=True, **kw)
    jcomp = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                        jcfg)
    return (pats, cfg, compile_patterns(pats, cfg)), (jcfg, jcomp)


def _tuples(m):
    return [tuple(x) for x in np.asarray(m).tolist()]


# ---- the depth kernel's mesh ------------------------------------------------

def test_stack_depth_tables_equal_to_jax():
    (_p, _cfg, comp), (_jcfg, jcomp) = _both(_words(), 4)
    mine, theirs = stack_depth_tables(comp), jax_mp.stack_depth_tables(jcomp)
    np.testing.assert_array_equal(mine.s0, theirs.s0)
    np.testing.assert_array_equal(mine.packed, theirs.packed)
    assert (mine.offs, mine.nbs, mine.n_steps) == (
        theirs.offs, theirs.nbs, theirs.n_steps)
    carried = stacked_depth_tables_from_arrays(**vars(theirs))
    np.testing.assert_array_equal(carried.packed, mine.packed)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (8, 1)])
def test_depth_mesh_equal_to_jax_and_oracle(mesh_shape):
    n_data, n_pat = mesh_shape
    data = _text(11, 8192)
    (pats, cfg, comp), (jcfg, jcomp) = _both(_words(), n_pat)
    pm = PallasMeshMatcher(comp, cfg, make_mesh(n_data, n_pat, CPU8))
    jm = jax_mp.PallasMeshMatcher(jcomp, jcfg, jax_make_mesh(n_data, n_pat),
                                  interpret=True)
    got = pm.match(data, input_size=len(data) - 5)
    np.testing.assert_array_equal(
        got, np.asarray(jm.match(data, input_size=len(data) - 5)))
    assert _tuples(pm.match(data)) == match_oracle(pats, data, cfg)


def test_depth_mesh_equal_to_single_device_matcher():
    data = _text(12, 5000)
    (_p, cfg, comp), _ = _both(_words(seed=4), 2, width=256)
    pm = PallasMeshMatcher(comp, cfg, make_mesh(4, 2, CPU8))
    single = Matcher(comp, cfg, device="cpu")
    assert pm.match(data).tolist() == single.match(data).tolist()


def test_depth_mesh_block_boundary_straddle():
    (_p, cfg, comp), _ = _both([b"boundarycrossing"], 1, width=256)
    pm = PallasMeshMatcher(comp, cfg, make_mesh(8, 1, CPU8))
    data = b"x" * (1024 - 8) + b"boundarycrossing" + b"y" * 2000
    assert _tuples(pm.match(data)) == [(1024 - 8, 1)]
    # a pattern cut off by the input's end must not match into the pad
    assert _tuples(pm.match(data, input_size=1024)) == []


def test_depth_mesh_refusals():
    words = _words()
    (_p, cfg, comp), _ = _both(words, 2)
    with pytest.raises(ValueError, match="patterns axis"):
        PallasMeshMatcher(comp, cfg, make_mesh(2, 4, CPU8))
    seg = PfacConfig(width=1024, num_shards=2, truncation="segment")
    with pytest.raises(DepthUnsupported):
        PallasMeshMatcher(comp, seg, make_mesh(4, 2, CPU8))


# ---- the plan kernel's mesh ---------------------------------------------------

def test_plan_mesh_host_loop_equal_to_jax_oracle_and_single_device():
    data = _text(21, 16384)
    (pats, cfg, comp), (jcfg, jcomp) = _both(_words(), 2)
    pm = PlanMeshMatcher(comp, cfg, make_mesh(8, 1, CPU8))
    assert pm.stacked is None and len(pm.pts) == 2
    jm = jax_mp.PlanMeshMatcher(jcomp, jcfg, jax_make_mesh(8, 1),
                                interpret=True)
    got = pm.match(data, input_size=len(data) - 3)
    np.testing.assert_array_equal(
        got, np.asarray(jm.match(data, input_size=len(data) - 3)))
    got = _tuples(pm.match(data))
    assert got == match_oracle(pats, data, cfg)
    assert got == _tuples(Matcher(comp, cfg, device="cpu").match(data))


def test_plan_mesh_trained_boundary_straddle():
    words = [b"boundarycrossing", b"bound", b"cross"]
    (pats, cfg, comp), (jcfg, jcomp) = _both(words, 1, width=256)
    train = _text(22, 8192)
    pm = PlanMeshMatcher(comp, cfg, make_mesh(8, 1, CPU8), train=train)
    assert all(pt.trained for pt in pm.pts)
    data = b"x" * (1024 - 8) + b"boundarycrossing" + b"y" * 3000
    jm = jax_mp.PlanMeshMatcher(jcomp, jcfg, jax_make_mesh(8, 1),
                                interpret=True, train=train)
    got = pm.match(data)
    np.testing.assert_array_equal(got, np.asarray(jm.match(data)))
    assert _tuples(got) == match_oracle(pats, data, cfg)


def test_plan_mesh_stacked_patterns_axis():
    data = _text(23, 16384)
    (pats, cfg, comp), (jcfg, jcomp) = _both(_words(n=300), 4)
    pm = PlanMeshMatcher(comp, cfg, make_mesh(2, 4, CPU8), train=data)
    assert pm.stacked is not None and pm.stacked.num_shards == 4
    assert pm.pts is None
    jm = jax_mp.PlanMeshMatcher(jcomp, jcfg, jax_make_mesh(2, 4),
                                interpret=True, train=data)
    assert jm.stacked is not None
    got = pm.match(data)
    np.testing.assert_array_equal(got, np.asarray(jm.match(data)))
    assert _tuples(got) == match_oracle(pats, data, cfg)
    assert _tuples(got) == _tuples(
        Matcher(comp, cfg, device="cpu").match(data))


def test_plan_mesh_stacked_uneven_depths():
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"abcdef ", dtype=np.uint8)
    short = [bytes(alpha[rng.integers(0, 7, 2)]) for _ in range(40)]
    long = [bytes(alpha[rng.integers(0, 7, 14)]) for _ in range(40)]
    words = list(dict.fromkeys(short + long))
    (pats, cfg, comp), (jcfg, jcomp) = _both(words, 2)
    data = bytes(alpha[rng.integers(0, 7, 8192)])
    pm = PlanMeshMatcher(comp, cfg, make_mesh(4, 2, CPU8))
    assert pm.stacked is not None
    jm = jax_mp.PlanMeshMatcher(jcomp, jcfg, jax_make_mesh(4, 2),
                                interpret=True)
    got = pm.match(data)
    np.testing.assert_array_equal(got, np.asarray(jm.match(data)))
    assert _tuples(got) == match_oracle(pats, data, cfg)


def test_plan_mesh_shard_with_an_empty_first_step_takes_the_host_loop():
    """A shard of one-byte patterns has nothing at the lead shard's first
    step: the stacked build refuses it (the JAX compiler fails there on
    an unbound name), and the shards loop on the host with their own
    tables."""
    words = [b"a", b"b", b"c", b"abcdefgh"]
    (pats, cfg, comp), _ = _both(words, 2)
    assert [sh.max_pat_len for sh in comp.shards] == [8, 1]
    with pytest.raises(PairUnsupported, match="first forced step"):
        build_stacked_plan_tables(comp.shards)
    pm = PlanMeshMatcher(comp, cfg, make_mesh(4, 2, CPU8))
    assert pm.stacked is None and len(pm.pts) == 2
    data = _text(24, 8192) + b"abcdefgh" + _text(25, 100)
    got = _tuples(pm.match(data))
    assert got == match_oracle(pats, data, cfg)
    assert got == _tuples(Matcher(comp, cfg, device="cpu").match(data))


def test_plain_k1_on_a_slice_of_jax_stacked_tables_equals_jax_stacked_scan():
    """The port launches one kernel per cell with that cell's shard
    sliced out of the stacked arrays; the JAX package runs one SPMD
    program over the stack.  The bitmaps must be the same."""
    from phfpfac_tpu.compile.plan import build_stacked_plan_tables
    from phfpfac_tpu.ops.common import pad_input, padded_steps
    from phfpfac_tpu.ops.pallas_pair import stage_pairs
    from phfpfac_tpu.ops.pallas_plan import resolve_cond_from

    n_data, n_pat = 2, 4
    data = _text(24, 8192)
    _mine, (_jcfg, jcomp) = _both(_words(n=300), n_pat)
    st = build_stacked_plan_tables(jcomp.shards, train=data)
    max_steps = padded_steps(jcomp.max_pat_len)
    padded = pad_input(data, 1024 * n_data, max_steps)
    n_pos = len(padded) - max_steps
    data2d = stage_pairs(
        jnp.asarray(padded[:n_pos]), jnp.asarray(np.int32(len(data))),
        jnp.asarray(st.code_of), n_rows=n_pos // 128, cb=st.code_bits)
    sigma = int(st.code_of.max())
    miss_sym = (sigma << st.code_bits) | sigma
    statics = dict(
        steps=st.steps, nb_p0=st.p0_banks.shape[1], cb=st.code_bits,
        p0_miss=st.p0_miss, p0_mode=st.p0_mode, interpret=True, tpc=8,
        cond_from=resolve_cond_from(st, "auto"), grouped=st.trained,
        compact=None, seg_bytes=0, halo_bytes=0)
    want = np.asarray(jax_mp._mesh_plan_stacked_scan(
        data2d, jnp.asarray(st.p0_banks), jnp.asarray(st.packed_banks),
        jnp.asarray(st.side_banks), mesh=jax_make_mesh(n_data, n_pat),
        statics=statics, miss_sym=miss_sym))
    assert want.shape == (n_pat, n_pos)

    fields = {k: v for k, v in vars(st).items() if k != "steps"}
    carried = stacked_plan_tables_from_arrays(
        steps=[vars(s) for s in st.steps], **fields)
    flat = torch.from_numpy(np.asarray(data2d).reshape(-1).copy())
    staged = torch.cat([flat, torch.full((TILE,), miss_sym,
                                         dtype=torch.int32)])
    block = n_pos // n_data
    for s in range(n_pat):
        t = plan_ops.PlanKernelTables.from_plan(
            stacked_plan_shard(carried, s), "cpu")
        cells = [plan_ops.plan_scan_plain(
            staged[d * block:(d + 1) * block + TILE], t)[1]
            for d in range(n_data)]
        np.testing.assert_array_equal(torch.cat(cells).numpy(), want[s],
                                      f"shard {s}")


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 1)])
def test_plan_mesh_explicit_compaction_equals_uncompacted(mesh_shape,
                                                          monkeypatch):
    n_data, n_pat = mesh_shape
    data = _text(25, 16384)
    (pats, cfg, comp), (jcfg, jcomp) = _both(_words(n=300), n_pat)
    mesh = make_mesh(n_data, n_pat, CPU8)
    want = PlanMeshMatcher(comp, cfg, mesh, train=data[:8192],
                           compact="off").match(data)
    calls = []
    real = plan_ops.plan_scan_compact
    monkeypatch.setattr(
        plan_ops, "plan_scan_compact",
        lambda *a, **k: calls.append(k["cap"]) or real(*a, **k))
    pm = PlanMeshMatcher(comp, cfg, mesh, train=data[:8192],
                         compact=(2, 8192))
    assert (pm.stacked is not None) == (n_pat > 1)
    got = pm.match(data)
    assert calls == [8192] * (n_data * n_pat)  # K1' + K6 on every cell
    np.testing.assert_array_equal(got, want)
    assert _tuples(got) == match_oracle(pats, data, cfg)
    jm = jax_mp.PlanMeshMatcher(jcomp, jcfg, jax_make_mesh(n_data, n_pat),
                                interpret=True, train=data[:8192],
                                compact=(2, 8192))
    np.testing.assert_array_equal(got, np.asarray(jm.match(data)))


def test_plan_mesh_cell_overflow_rescans_uncompacted(monkeypatch):
    """One cell holds more survivors than the cap: its compacted result
    is a truncation, and the whole scan runs again uncompacted."""
    words = _words(n=200, lo=6, hi=12) + [b"a" * 11]
    # every position of cell 1 of 2 is live at the cut; cell 0 holds text
    data = _text(28, 16 << 10) + b"a" * (16 << 10)
    (pats, cfg, comp), _ = _both(words, 1)
    mesh = make_mesh(2, 1, CPU8)
    pm = PlanMeshMatcher(comp, cfg, mesh, compact=(1, 8192))
    truncated = []
    real = pm._scan_group

    def spy(staged, shards, block, cc, seg, halo):
        per_shard, counts = real(staged, shards, block, cc, seg, halo)
        truncated.append((cc, [int(c) for c in counts]))
        return per_shard, counts

    monkeypatch.setattr(pm, "_scan_group", spy)
    before = plan_ops.overflow_rescans
    got = _tuples(pm.match(data))
    assert plan_ops.overflow_rescans == before + 1
    (cc0, counts0), (cc1, counts1) = truncated
    assert cc0 == (1, 8192) and cc1 is None and counts1 == []
    assert counts0[0] <= 8192 < counts0[1]
    assert got == match_oracle(pats, data, cfg)


@pytest.mark.parametrize("compact", ["off", (2, 8192)])
def test_plan_mesh_segment_cut_parity(compact):
    """Segment mode: per-cell blocks start on segment boundaries, so the
    kernel's cell-local cut is the single-device one."""
    words = _words(n=200, lo=2, hi=24)
    longest = max(words, key=len)
    assert len(longest) > 12
    buf = bytearray(_text(26, 20000))
    for seg_end in (2048, 6144, 10240):  # run past segment end + halo
        buf[seg_end - 2:seg_end - 2 + len(longest)] = longest
    data = bytes(buf)
    kw = dict(width=1024, num_shards=2, truncation="segment",
              segment_bytes=2048, halo_bytes=8)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    cfg, jcfg = PfacConfig(**kw), JaxConfig(interpret=True, **kw)
    comp = compile_patterns(pats, cfg)
    jcomp = jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(words)],
                        jcfg)
    want = match_oracle(pats, data, cfg)
    exact = match_oracle(pats, data, PfacConfig(width=1024, num_shards=2,
                                                truncation="none"))
    assert len(want) < len(exact)  # the cut drops matches here
    single = Matcher(comp, cfg, device="cpu")
    assert _tuples(single.match(data)) == want
    pm = PlanMeshMatcher(comp, cfg, make_mesh(4, 2, CPU8),
                         train=data[:8192], compact=compact)
    got = pm.match(data)
    assert _tuples(got) == want
    jm = jax_mp.PlanMeshMatcher(jcomp, jcfg, jax_make_mesh(4, 2),
                                interpret=True, train=data[:8192],
                                compact=compact)
    np.testing.assert_array_equal(got, np.asarray(jm.match(data)))


def test_plan_mesh_refuses_segments_that_are_no_power_of_two():
    (_p, _cfg, comp), _ = _both(_words(), 1)
    cfg = PfacConfig(width=1024, num_shards=1, truncation="segment",
                     segment_bytes=6144, halo_bytes=8)
    with pytest.raises(PairUnsupported, match="power of 2"):
        PlanMeshMatcher(comp, cfg, make_mesh(4, 1, CPU8))


def test_plan_mesh_auto_compaction_is_opt_in(monkeypatch):
    data = _text(27, 8192)
    (_p, cfg, comp), _ = _both(_words(), 1)
    monkeypatch.delenv(plan_ops.AUTO_OPT_IN, raising=False)
    monkeypatch.setattr(
        plan_ops, "plan_scan_compact",
        lambda *a, **k: pytest.fail("the default route compacted"))
    pm = PlanMeshMatcher(comp, cfg, make_mesh(4, 1, CPU8), train=data)
    assert pm.compact == "auto"
    assert len(pm.match(data)) > 0
