"""The port's multi-process runtime (parallel.distributed) on the CPU:
two real processes over gloo on a local TCP port, against the
one-process result, the oracle and the JAX package's MultiHostMatcher on
the same file (tolerance 0: match lists)."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from phfpfac_tpu.compile.tables import compile_patterns as jax_compile
from phfpfac_tpu.frontend.patterns import Pattern as JaxPattern
from phfpfac_tpu.parallel.distributed import (
    MultiHostMatcher as JaxMultiHostMatcher,
)
from phfpfac_tpu.utils.config import PfacConfig as JaxConfig
from phfpfac_tpu_torch.compile.tables import compile_patterns
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.oracle.ac import match_oracle
from phfpfac_tpu_torch.parallel import distributed
from phfpfac_tpu_torch.parallel.distributed import MultiHostMatcher
from phfpfac_tpu_torch.utils.config import PfacConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = [b"the", b"then", b"there", b"cat", b"dog", b"do", b"a", b"an",
         b"end of the story"]
TEXT = b"the cat sat on the dog and then there was an end of the story "
RANK_TIMEOUT = 120  # seconds: a hung rendezvous fails, it does not wait

WORKER = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    rank, nproc, port, corpus, out, exact = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6] == "exact")
    import numpy as np
    from phfpfac_tpu_torch.compile.tables import compile_patterns
    from phfpfac_tpu_torch.frontend.patterns import Pattern
    from phfpfac_tpu_torch.parallel import distributed as D
    from phfpfac_tpu_torch.utils.config import PfacConfig

    D.initialize(f"localhost:{{port}}", nproc, rank)
    assert D.process_count() == nproc and D.process_index() == rank

    # lists of unequal length, one of them empty
    mine = np.arange(2 * 3 * rank, dtype=np.int64).reshape(-1, 2) + 100 * rank
    got = D._allgather_matches(mine)
    want = np.concatenate([
        np.arange(2 * 3 * r, dtype=np.int64).reshape(-1, 2) + 100 * r
        for r in range(nproc)])
    assert np.array_equal(got, want), got
    assert D._allgather_matches(np.empty((0, 2), np.int64)).shape == (0, 2)

    data = open(corpus, "rb").read()
    sl, start, total = D.local_slice(corpus)
    assert total == len(data) and sl == data[start:start + len(sl)]
    assert start == rank * -(-len(data) // nproc)

    words = {words!r}
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    cfg = PfacConfig(width=256, num_shards=2,
                     truncation="none" if exact else "segment",
                     segment_bytes=1024, halo_bytes=32)
    mh = D.MultiHostMatcher(compile_patterns(pats, cfg), cfg, device="cpu")
    res = mh.match_file(corpus)
    assert mh.last_engine == "plan"
    np.save(out + f".{{rank}}.npy", res)
    D.finalize()
    print(f"rank {{rank}} done {{len(res)}}")
    """
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argvs) -> list[str]:
    """Run one process per argv; every one must exit 0 inside
    RANK_TIMEOUT.  Returns their outputs."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out}"
    return outs


def _configs(exact: bool):
    kw = dict(width=256, num_shards=2,
              truncation="none" if exact else "segment",
              segment_bytes=1024, halo_bytes=32)
    return PfacConfig(**kw), JaxConfig(interpret=True, **kw)


@pytest.mark.parametrize("mode", ["segment", "exact"])
def test_two_process_match_file(tmp_path, mode):
    # 4096 B per rank: slices start on segment boundaries, so that the
    # two-process cut is the one-process one
    data = (TEXT * 200)[:8192]
    corpus = tmp_path / "corpus.bin"
    corpus.write_bytes(data)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=REPO, words=WORDS))
    port, out = free_port(), str(tmp_path / "res")
    outs = run_ranks([
        [sys.executable, str(worker), str(r), "2", str(port), str(corpus),
         out, mode] for r in range(2)])
    for r in range(2):
        assert f"rank {r} done" in outs[r]

    cfg, jcfg = _configs(mode == "exact")
    pats = [Pattern(i + 1, w) for i, w in enumerate(WORDS)]
    want = match_oracle(pats, data, cfg)
    assert len(want) > 1000
    results = [np.load(out + f".{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(results[0], results[1])
    assert [tuple(x) for x in results[0].tolist()] == want
    one = MultiHostMatcher(compile_patterns(pats, cfg), cfg, device="cpu")
    np.testing.assert_array_equal(results[0], one.match_file(str(corpus)))
    jm = JaxMultiHostMatcher(
        jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(WORDS)],
                    jcfg), jcfg)
    np.testing.assert_array_equal(
        results[0], np.asarray(jm.match_file(str(corpus))))
    assert jm.last_engine == "plan"


@pytest.mark.parametrize("rank,nproc,size,want", [
    (0, 1, 10, (0, 10)), (0, 2, 10, (0, 5)), (1, 2, 10, (5, 10)),
    (0, 3, 10, (0, 4)), (2, 3, 10, (8, 10)), (3, 4, 2, (2, 2)),
    (1, 2, 7, (4, 7)),
])
def test_local_slice_by_rank(tmp_path, monkeypatch, rank, nproc, size, want):
    f = tmp_path / "c.bin"
    f.write_bytes(bytes(range(12)))
    monkeypatch.setattr(distributed, "process_count", lambda: nproc)
    monkeypatch.setattr(distributed, "process_index", lambda: rank)
    data, start, total = distributed.local_slice(str(f), input_size=size)
    assert (start, start + len(data)) == want and total == size
    assert data == bytes(range(12))[want[0]:want[1]]


def test_initialize_is_a_no_op_for_one_process():
    import torch.distributed as dist

    distributed.initialize(None, 1, 0)
    distributed.initialize()
    assert not dist.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0


def test_single_process_rides_the_plan_mesh(tmp_path):
    cfg, jcfg = _configs(exact=True)
    pats = [Pattern(i + 1, w) for i, w in enumerate(WORDS)]
    data = TEXT * 100
    corpus = tmp_path / "c.bin"
    corpus.write_bytes(data)
    mh = MultiHostMatcher(compile_patterns(pats, cfg), cfg,
                          devices=["cpu"] * 4)
    assert mh.mesh.shape == {"data": 2, "patterns": 2}
    got = mh.match_file(str(corpus))
    assert mh.last_engine == "plan" and mh._plan.stacked is not None
    assert [tuple(x) for x in got.tolist()] == match_oracle(pats, data, cfg)
    # the turbo mesh behind it gives the same list
    np.testing.assert_array_equal(mh.dm.match(data), got)
    jm = JaxMultiHostMatcher(
        jax_compile([JaxPattern(i + 1, w) for i, w in enumerate(WORDS)],
                    jcfg), jcfg)
    np.testing.assert_array_equal(got, np.asarray(jm.match(data)))


@pytest.mark.parametrize("why", ["long pattern", "segment size"])
def test_a_table_builds_refusal_goes_to_the_turbo_mesh(why):
    words = WORDS + ([b"x" * 40] if why == "long pattern" else [])
    pats = [Pattern(i + 1, w) for i, w in enumerate(words)]
    cfg = PfacConfig(width=256, num_shards=2, truncation="segment",
                     segment_bytes=4096 if why == "long pattern" else 1536,
                     halo_bytes=64)
    data = TEXT * 50 + b"x" * 45 + TEXT * 50
    mh = MultiHostMatcher(compile_patterns(pats, cfg), cfg,
                          devices=["cpu"] * 2)
    got = mh.match(data)
    assert mh.last_engine == "turbo" and mh._plan is None
    assert [tuple(x) for x in got.tolist()] == match_oracle(pats, data, cfg)


def test_a_fault_in_the_plan_mesh_propagates(monkeypatch):
    """No silent fallback: only a table build's refusal routes a scan
    to the turbo mesh."""
    from phfpfac_tpu_torch.parallel import mesh_pallas

    cfg, _ = _configs(exact=True)
    pats = [Pattern(i + 1, w) for i, w in enumerate(WORDS)]
    comp = compile_patterns(pats, cfg)

    def broken_scan(*a, **k):
        raise RuntimeError("plan_scan launch failed: CUDA error 700")

    mh = MultiHostMatcher(comp, cfg, devices=["cpu"] * 2)
    monkeypatch.setattr(mesh_pallas.plan_ops, "plan_scan", broken_scan)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        mh.match(TEXT * 20)
    assert mh.last_engine is None

    def broken_build(*a, **k):
        raise MemoryError("table build ran out of memory")

    monkeypatch.setattr(mesh_pallas, "build_stacked_plan_tables",
                        broken_build)
    mh = MultiHostMatcher(comp, cfg, devices=["cpu"] * 2)
    with pytest.raises(MemoryError):
        mh.match(TEXT * 20)


def test_default_devices_need_cuda():
    import torch

    cfg, _ = _configs(exact=True)
    comp = compile_patterns([Pattern(1, b"the")], cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MultiHostMatcher(comp, cfg)
    assert MultiHostMatcher(comp, cfg, device="cpu").mesh.shape == {
        "data": 1, "patterns": 1}
