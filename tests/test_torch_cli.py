"""The port's CLI (``--device cpu``) vs the JAX CLI: byte-identical
GPU_match_result.txt files."""

import numpy as np
import pytest

from phfpfac_tpu.cli import main as jax_main
from phfpfac_tpu_torch.cli import main


def _files(tmp_path, seed=3):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdefg \tx4", dtype=np.uint8)
    words = list(dict.fromkeys(
        bytes(alpha[rng.integers(0, len(alpha), int(rng.integers(1, 12)))])
        .strip() for _ in range(120)
    ))
    words = [w for w in words if w]
    words.append(b"a\\x41b")  # = "aAb" under --escapes
    text = bytearray(alpha[rng.integers(0, len(alpha), 9000)])
    text[100:103] = b"aAb"
    pat, inp = tmp_path / "pat.txt", tmp_path / "in.txt"
    pat.write_bytes(b"\n".join(words) + b"\n")
    inp.write_bytes(bytes(text) + b"\n")
    return pat, inp


@pytest.mark.parametrize("flags", [[], ["--exact"], ["--full-input"],
                                   ["--escapes"], ["--engine", "turbo"],
                                   ["--engine", "jnp"],
                                   ["--engine", "turbo", "--exact"],
                                   ["--engine", "jnp", "--exact"],
                                   ["--exact", "--num-shards", "3"]])
def test_cli_output_matches_jax(tmp_path, flags):
    pat, inp = _files(tmp_path)
    mine, theirs = tmp_path / "torch.txt", tmp_path / "jax.txt"
    common = [str(pat), "1", "256", str(inp), "--quiet", *flags]
    assert main([*common, "-o", str(mine), "--device", "cpu"]) == 0
    assert jax_main([*common, "-o", str(theirs)]) == 0
    assert mine.read_bytes() == theirs.read_bytes()
    assert mine.read_bytes().count(b"\n") > 100


def test_cli_phase_report(tmp_path, capsys):
    pat, inp = _files(tmp_path)
    out = tmp_path / "o.txt"
    assert main([str(pat), "1", "256", str(inp), "-o", str(out),
                 "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "state num on shard 3" in text
    assert "4.Time for  match progress" in text
    assert "The throughput is" in text


@pytest.mark.parametrize("flags", [["--save-tables", "x.npz"], ["--charset"],
                                   ["--mesh"], ["--load-tables", "x.npz"],
                                   ["--profile", "dir"],
                                   ["--coordinator", "h:1"],
                                   ["--num-processes", "2"]])
def test_unported_flags_exit_naming_the_roadmap(tmp_path, capsys, flags):
    pat, inp = _files(tmp_path)
    with pytest.raises(SystemExit) as e:
        main([str(pat), "1", "256", str(inp), "--device", "cpu", *flags])
    assert e.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err


def test_exact_reaches_the_pair_scanner(tmp_path, monkeypatch):
    """--exact tries the pair scanner where build_plan_tables refuses a
    shard; the output file stays byte-identical to the JAX CLI's."""
    from phfpfac_tpu.ops import pallas_plan as jax_plan
    from phfpfac_tpu_torch.compile.pair import PairUnsupported
    from phfpfac_tpu_torch.ops import pair
    from phfpfac_tpu_torch.parallel import matcher

    def refuse(*a, **k):
        raise PairUnsupported("plan tables refused (test)")

    monkeypatch.setattr(matcher, "PlanShardScanner", refuse)
    monkeypatch.setattr(jax_plan, "PlanShardScanner", refuse)
    scans = []
    real = pair.PairShardScanner.scan
    monkeypatch.setattr(
        pair.PairShardScanner, "scan",
        lambda self, *a, **k: scans.append(1) or real(self, *a, **k))
    pat, inp = _files(tmp_path)
    mine, theirs = tmp_path / "torch.txt", tmp_path / "jax.txt"
    common = [str(pat), "1", "256", str(inp), "--quiet", "--exact"]
    assert main([*common, "-o", str(mine), "--device", "cpu"]) == 0
    assert jax_main([*common, "-o", str(theirs)]) == 0
    assert mine.read_bytes() == theirs.read_bytes()
    assert len(scans) == 4  # one per shard
