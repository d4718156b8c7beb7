"""The CPU rehearsal, taken only when asked for (``BENCH_REHEARSE=1``):
``run.py --rehearse`` as a process, each cell, its last line of standard
output with the contract's keys and its numbers compared on standard
error's last lines.  And, on a card only, one short run of a cell."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_py(*args):
    return subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600)


@pytest.mark.parametrize("cell", ["englishdic.text", "bigenglishdic.text",
                                  "englishdic.invoke"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_rehearsal(cell, trace):
    if os.environ.get("BENCH_REHEARSE") != "1":
        pytest.skip("the CPU rehearsal runs when BENCH_REHEARSE=1")
    p = run_py("--workload", cell, "--seed", str(2**31 + 99),
               "--seconds", "1", "--trace", trace, "--rehearse")
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == KEYS and list(out)[-1] == "compared"
    assert out["correct"] and out["device"]["platform"] == "cpu"
    assert p.stderr.strip().splitlines()[-3:] == [
        f"{k} 0 (limit 0)" for k in ("missing", "extra", "misplaced")]


def test_no_card_no_result():
    """Without a card, a run exits non-zero and prints nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = run_py("--workload", "englishdic.text", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.cuda
def test_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    p = run_py("--workload", "englishdic.invoke", "--seed", "5",
               "--seconds", "2", "--trace", "0")
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the
    benchmark's files, a run exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark" / "run.py"),
         "--workload", "englishdic.invoke", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--rehearse"],
        capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "phfpfac_tpu_torch" in p.stderr
