"""The probes' plain versions (phfpfac_tpu_torch.probes) against
independent numpy loops: every arm and every K of the gather probe, the
compaction probe against ``tile[tile != 0]`` (tolerance 0: integers)."""

import numpy as np
import pytest
import torch

from phfpfac_tpu_torch.probes import compact, gather


def numpy_chain(table, idx, arm, reps, mul):
    """One walker at a time, in Python integers reduced mod 2**32."""
    M = 1 << 32

    def signed(x):
        x %= M
        return x - M if x >= M // 2 else x

    out = []
    for v in idx.tolist():
        for r in range(reps):
            if arm == "alu":
                a = signed(v + r + 1)
                b = a ^ v
                v = a if b > 0 else b
                continue
            if arm == "packed":
                at = v % (2 * len(table))
                g = (int(table[at >> 1]) % M >> (16 * (at & 1))) & 0xFFFF
            else:
                g = int(table[v % len(table)])
            v = signed((v + g + r + 1) * mul)
        out.append(v)
    return np.asarray(out, np.int64).astype(np.int32)


@pytest.mark.parametrize("mul", [1, gather.SCATTER])
@pytest.mark.parametrize("k", gather.KS)
@pytest.mark.parametrize("arm", gather.ARMS)
def test_gather_plain_equals_a_numpy_loop(arm, k, mul):
    rng = np.random.default_rng(10 * gather.ARMS.index(arm) + k)
    table = gather.make_table(rng, arm, 512)
    idx = rng.integers(-(1 << 31), 1 << 31, 64).astype(np.int32)
    want = numpy_chain(table, idx, arm, 5, mul)
    got = gather.probe_gather(
        None if table is None else torch.from_numpy(table),
        torch.from_numpy(idx), arm=arm, reps=5, k=k, mul=mul)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_tables_have_the_arms_types():
    rng = np.random.default_rng(0)
    assert gather.make_table(rng, "alu", 64) is None
    for arm, dt, n in (("i32", np.int32, 64), ("i16", np.int16, 64),
                       ("i8", np.int8, 64), ("packed", np.int32, 32)):
        t = gather.make_table(rng, arm, 64)
        assert t.dtype == dt and len(t) == n
        assert len(t) * t.itemsize == 64 * gather.entry_bytes(arm)
    big = gather.make_table(rng, "i32", 1 << 16)
    assert big.max() > 1 << 15  # values reach over the whole table


@pytest.mark.parametrize("bad", [
    dict(arm="i64"), dict(k=3), dict(reps=-1),
    dict(idx=torch.zeros(6, dtype=torch.int64)),
    dict(idx=torch.zeros(6, dtype=torch.int32), k=4),
    dict(table=torch.zeros(48, dtype=torch.int32)),
    dict(table=torch.zeros(64, dtype=torch.int16)),
    dict(table=None),
])
def test_gather_refuses_what_the_kernel_does_not_take(bad):
    kw = dict(table=torch.zeros(64, dtype=torch.int32),
              idx=torch.zeros(8, dtype=torch.int32), arm="i32", reps=2, k=1)
    kw.update(bad)
    table, idx = kw.pop("table"), kw.pop("idx")
    with pytest.raises(ValueError):
        gather.probe_gather(table, idx, **kw)


@pytest.mark.parametrize("density", [0.0, 0.04, 0.5, 1.0])
@pytest.mark.parametrize("m", compact.SWEEP_PLANES)
def test_compact_plain_equals_numpy_per_tile(m, density):
    rng = np.random.default_rng(m)
    disp = compact.make_disp(rng, 3 * compact.TILE, density)
    out, counts = compact.probe_compact(torch.from_numpy(disp), m)
    copied, firsts = compact.probe_copy(torch.from_numpy(disp), m)
    packed_all, total = compact.probe_compact_atomic(torch.from_numpy(disp),
                                                     m)
    everything = []
    for t in range(3):
        tile = disp[t * compact.TILE:(t + 1) * compact.TILE]
        fold = tile.copy()
        for j in range(1, m):
            fold[:-j] ^= tile[j:]
        want = fold[tile != 0]
        got = out[t * compact.TILE:(t + 1) * compact.TILE].numpy()
        np.testing.assert_array_equal(got[:len(want)], want)
        assert (got[len(want):] == 0).all()
        assert int(counts[t]) == len(want)
        np.testing.assert_array_equal(
            copied[t * compact.TILE:(t + 1) * compact.TILE].numpy(), fold)
        assert int(firsts[t]) == tile[0]
        everything.append(want)
    everything = np.concatenate(everything)
    assert int(total) == len(everything)
    np.testing.assert_array_equal(packed_all[:len(everything)].numpy(),
                                  everything)


def test_compact_with_one_plane_is_the_tiles_nonzeros():
    rng = np.random.default_rng(9)
    disp = compact.make_disp(rng, compact.TILE, 0.3)
    out, counts = compact.probe_compact(torch.from_numpy(disp))
    n = int(counts[0])
    np.testing.assert_array_equal(out[:n].numpy(), disp[disp != 0])
    assert n == (disp != 0).sum() and not out[n:].any()


@pytest.mark.parametrize("bad", [
    (torch.zeros(1000, dtype=torch.int32), 1),
    (torch.zeros(1024, dtype=torch.int64), 1),
    (torch.zeros(1024, dtype=torch.int32), 0),
    (torch.zeros(1024, dtype=torch.int32), 9),
])
def test_compact_refuses_what_the_kernel_does_not_take(bad):
    for fn in (compact.probe_compact, compact.probe_copy,
               compact.probe_compact_atomic):
        with pytest.raises(ValueError):
            fn(*bad)


def test_sweeps_and_the_entry_point_need_the_card(capsys):
    from phfpfac_tpu_torch.probes.__main__ import main

    with pytest.raises(ValueError, match="CUDA"):
        next(gather.sweep("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        next(compact.sweep("cpu"))
    if not torch.cuda.is_available():
        assert main([]) == 1
        assert "no CUDA device" in capsys.readouterr().err


def test_launch_counts_stay_zero_on_the_cpu():
    gather.probe_gather(None, torch.zeros(8, dtype=torch.int32), arm="alu",
                        reps=1)
    compact.probe_compact(torch.zeros(1024, dtype=torch.int32))
    assert gather.launches == 0
    assert compact.launches == compact.launches_copy == 0
    assert compact.launches_atomic == 0
