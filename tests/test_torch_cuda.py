"""CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA GPU and skips without one.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs, compared exactly (tolerance 0).
"""

import numpy as np
import pytest
import torch

from phfpfac_tpu_torch import Matcher, PfacConfig, compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.ops import depth as K2
from phfpfac_tpu_torch.ops import plan as K1
from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
from phfpfac_tpu_torch.ops.staging import to_device_bytes
from phfpfac_tpu_torch.oracle.ac import match_oracle

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _dictionary(name):
    """Dense p0 + nibble/byte pair steps, s0 + pair steps, or s0x."""
    rng = np.random.default_rng(0)
    if name == "s0x":
        raw = rng.integers(0, 256, (4000, 16), dtype=np.uint8).tobytes()
        words = list(dict.fromkeys(
            raw[i * 16: i * 16 + 3 + int(rng.integers(0, 6))]
            for i in range(4000)))
        data = bytearray(rng.integers(0, 256, 1 << 16, dtype=np.uint8))
    else:
        alpha = np.frombuffer(b"abcdefghijkl" if name == "dense"
                              else bytes(range(48, 80)), dtype=np.uint8)
        words = list(dict.fromkeys(
            bytes(alpha[rng.integers(0, len(alpha),
                                     int(rng.integers(1, 16)))])
            for _ in range(800)))
        data = bytearray(alpha[rng.integers(0, len(alpha), 1 << 16)])
    for i in range(0, len(data) - 16, 61):
        w = words[i % len(words)]
        data[i: i + len(w)] = w
    return words, bytes(data)


def _scanners(name, dev, train):
    words, data = _dictionary(name)
    cfg = PfacConfig(width=4096, num_shards=1)
    sh = compile_patterns([Pattern(i + 1, w) for i, w in enumerate(words)],
                          cfg).shards[0]
    ms = padded_steps(sh.max_pat_len)
    padded = to_device_bytes(pad_input(data, 1024, ms), dev)
    ps = K1.PlanShardScanner(sh, device=dev,
                             train=data[:8192] if train else None)
    ds = K2.DepthShardScanner(sh, device=dev)
    return (ps, ps.stage(padded, len(data), ms),
            ds, ds.stage(padded, len(data), ms), len(data))


GEOMS = [(0, 0), (64, 0), (128, 4), (4096, 512)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["dense", "s0", "s0x"])
def test_plan_kernel_equals_plain(name, train, dev):
    ps, staged, _ds, _st2, _n = _scanners(name, dev, train)
    before = K1.launches
    for seg, halo in GEOMS:
        got = K1.plan_scan(staged, ps.tables, seg_bytes=seg, halo_bytes=halo)
        want = K1.plan_scan_plain(staged, ps.tables, seg_bytes=seg,
                                  halo_bytes=halo)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[0].sum()) > 0
    prev = None
    for shift in (0, 1, 0):
        got = K1.plan_scan(staged, ps.tables, emit="count", shift=shift,
                           prev_total=prev)
        want = K1.plan_scan_plain(staged, ps.tables, emit="count",
                                  shift=shift, prev_total=prev)
        assert int(got) == int(want)
        prev = got
    torch.cuda.synchronize()
    assert K1.launches == before + len(GEOMS) + 3


@pytest.mark.parametrize("name", ["dense", "s0x"])
def test_depth_kernel_equals_plain_and_plan(name, dev):
    ps, pstaged, ds, staged, n = _scanners(name, dev, False)
    before = K2.launches
    for seg, halo in GEOMS + [(100, 3)]:
        got = K2.depth_scan(staged, ds.tables, input_size=n, seg_bytes=seg,
                            halo_bytes=halo)
        want = K2.depth_scan_plain(staged, ds.tables, input_size=n,
                                   seg_bytes=seg, halo_bytes=halo)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if seg & (seg - 1) == 0:  # the plan kernel takes these too
            plan_bits = K1.plan_scan(pstaged, ps.tables, seg_bytes=seg,
                                     halo_bytes=halo)[1]
            assert torch.equal(got[1][:n], plan_bits[:n])
    got = K2.depth_scan(staged, ds.tables, input_size=n, emit="count",
                        shift=1)
    assert int(got) == int(K2.depth_scan_plain(staged, ds.tables,
                                               input_size=n, emit="count",
                                               shift=1))
    assert K2.launches == before + len(GEOMS) + 2


def test_wrappers_refuse_bad_inputs(dev):
    ps, staged, ds, dstaged, n = _scanners("dense", dev, False)
    with pytest.raises(ValueError):
        K1.plan_scan(staged.to(torch.int64), ps.tables)
    with pytest.raises(ValueError):
        K1.plan_scan(staged, ps.tables, seg_bytes=100)
    with pytest.raises(ValueError):
        K2.depth_scan(dstaged[:, :64], ds.tables, input_size=n)


@pytest.mark.parametrize("trunc", ["segment", "none"])
def test_matcher_on_cuda_equals_oracle(trunc, dev):
    words, data = _dictionary("dense")
    cfg = PfacConfig(width=256, num_shards=4, truncation=trunc,
                     segment_bytes=512, halo_bytes=8)
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    m = Matcher(compile_patterns(pats, cfg), cfg)
    assert m.device.type == "cuda"
    data = data[:20000]
    got = [tuple(x) for x in m.match_chunked(data, chunk_bytes=4096)]
    assert got == match_oracle(pats, data, cfg)
