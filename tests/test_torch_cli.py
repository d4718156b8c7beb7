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


@pytest.mark.parametrize("flags", [["--save-tables", "x.npz", "--mesh"],
                                   ["--charset", "--profile", "dir"],
                                   ["--mesh"],
                                   ["--load-tables", "x.npz",
                                    "--coordinator", "h:1"],
                                   ["--profile", "dir"],
                                   ["--coordinator", "h:1"],
                                   ["--num-processes", "2"]])
def test_unported_flags_exit_naming_the_roadmap(tmp_path, capsys, flags):
    pat, inp = _files(tmp_path)
    with pytest.raises(SystemExit) as e:
        main([str(pat), "1", "256", str(inp), "--device", "cpu",
              *[str(tmp_path / f) if f == "x.npz" else f for f in flags]])
    assert e.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not (tmp_path / "x.npz").exists()  # refused before any work


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


def _count_plan_builds(monkeypatch):
    from phfpfac_tpu_torch.ops import plan

    built = []
    real = plan.build_plan_tables
    monkeypatch.setattr(
        plan, "build_plan_tables",
        lambda *a, **k: built.append(1) or real(*a, **k))
    return built


@pytest.mark.parametrize("flags", [[], ["--exact"]])
def test_save_then_load_tables(tmp_path, monkeypatch, flags):
    """--save-tables writes format v3 with the scan's plan tables; a
    --load-tables run builds none and writes the same bytes."""
    from phfpfac_tpu_torch.compile.tables import CompiledDictionary

    pat, inp = _files(tmp_path)
    a, b, npz = tmp_path / "a.txt", tmp_path / "b.txt", tmp_path / "t.npz"
    built = _count_plan_builds(monkeypatch)
    common = ["1", "256", str(inp), "--quiet", "--device", "cpu", *flags]
    assert main([str(pat), *common, "-o", str(a),
                 "--save-tables", str(npz)]) == 0
    assert len(built) == 4  # one per shard
    saved = CompiledDictionary.load(npz)
    assert saved.plan_tables and all(p is not None
                                     for p in saved.plan_tables)
    assert all(p.trained for p in saved.plan_tables)
    # the pattern file is not read again
    assert main(["/nonexistent", *common, "-o", str(b),
                 "--load-tables", str(npz)]) == 0
    assert len(built) == 4
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes().count(b"\n") > 100


def test_torch_engines_save_without_plan_tables(tmp_path):
    from phfpfac_tpu_torch.compile.tables import CompiledDictionary

    pat, inp = _files(tmp_path)
    out, npz = tmp_path / "o.txt", tmp_path / "t.npz"
    assert main([str(pat), "1", "256", str(inp), "--quiet", "--device",
                 "cpu", "--engine", "turbo", "-o", str(out),
                 "--save-tables", str(npz)]) == 0
    assert not CompiledDictionary.load(npz).plan_tables


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tables_files_cross_the_packages(tmp_path, monkeypatch, writer):
    """A v3 file written by either package's CLI drives the other's
    --load-tables to the same output, with no plan build."""
    pat, inp = _files(tmp_path)
    a, b, npz = tmp_path / "a.txt", tmp_path / "b.txt", tmp_path / "t.npz"
    common = ["1", "256", str(inp), "--quiet"]
    cpu = ["--device", "cpu"]
    save = [str(pat), *common, "-o", str(a), "--save-tables", str(npz)]
    load = ["/nonexistent", *common, "-o", str(b), "--load-tables", str(npz)]
    if writer == "jax":
        assert jax_main(save) == 0
        built = _count_plan_builds(monkeypatch)
        assert main(load + cpu) == 0
        assert built == []
    else:
        from phfpfac_tpu.compile.tables import CompiledDictionary as JaxCD
        from phfpfac_tpu.ops import pallas_plan as jax_plan

        assert main(save + cpu) == 0
        loaded = JaxCD.load(npz)
        assert loaded.plan_tables and all(p is not None
                                          for p in loaded.plan_tables)

        def fault(*a, **k):
            raise AssertionError("the loading run built plan tables")

        monkeypatch.setattr(jax_plan, "build_plan_tables", fault)
        assert jax_main(load) == 0
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes().count(b"\n") > 100


def _class_files(tmp_path):
    rng = np.random.default_rng(4)
    specs = [b"a[bc]d", b"abd", b"[a-c][a-c]x", b"x[^a]", b"[ab]b", b"bb"]
    text = bytes(rng.integers(97, 101, 6000).astype(np.uint8))
    text = text[:100] + b"xabdxacdx" + text[100:]
    pat, inp = tmp_path / "cls.txt", tmp_path / "cin.txt"
    pat.write_bytes(b"\n".join(specs) + b"\n")
    inp.write_bytes(text + b"\n")
    return pat, inp


@pytest.mark.parametrize("flags", [[], ["--exact"], ["--engine", "turbo"],
                                   ["--num-shards", "3"]])
def test_charset_output_matches_jax(tmp_path, flags):
    pat, inp = _class_files(tmp_path)
    mine, theirs = tmp_path / "torch.txt", tmp_path / "jax.txt"
    common = [str(pat), "1", "256", str(inp), "--quiet", "--charset", *flags]
    assert main([*common, "-o", str(mine), "--device", "cpu"]) == 0
    assert jax_main([*common, "-o", str(theirs)]) == 0
    assert mine.read_bytes() == theirs.read_bytes()
    assert mine.read_bytes().count(b"\n") > 100
    assert b"At position  101, match pattern 1\n" \
        b"At position  101, match pattern 2\n" in mine.read_bytes()


def test_charset_save_load_preserves_multi_output(tmp_path):
    pat, inp = _class_files(tmp_path)
    a, b, c = (tmp_path / n for n in ("a.txt", "b.txt", "c.txt"))
    npz = tmp_path / "t.npz"
    common = ["1", "256", str(inp), "--quiet"]
    assert main([str(pat), *common, "-o", str(a), "--device", "cpu",
                 "--charset", "--save-tables", str(npz)]) == 0
    assert main(["/nonexistent", *common, "-o", str(b), "--device", "cpu",
                 "--load-tables", str(npz)]) == 0
    assert jax_main(["/nonexistent", *common, "-o", str(c),
                     "--load-tables", str(npz)]) == 0
    # both ids of a multi-output final survive the round trip
    assert a.read_bytes() == b.read_bytes() == c.read_bytes()
    assert b"position  101, match pattern 1\n" in b.read_bytes()
    assert b"position  101, match pattern 2\n" in b.read_bytes()
