"""What the harness loads: never ``jax``, ``jaxlib``, ``flax`` or the JAX
package, compared by whole top-level names (``phfpfac_tpu_torch`` begins
with ``phfpfac_tpu``); and the reference nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TOP = ("sorted({m.split('.')[0] for m in sys.modules})")


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
         f"{code}; import json; print(json.dumps({TOP}))"],
        capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = loaded("import benchmark.run as r; import benchmark.loops as "
                   "l; l.port(); import phfpfac_tpu_torch.cli")
    assert "phfpfac_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "phfpfac_tpu"}


def test_reference_loads_no_program():
    names = loaded("import benchmark.reference.ac; import benchmark.check; "
                   "import benchmark.work")
    assert not names & {"phfpfac_tpu_torch", "phfpfac_tpu", "jax", "torch"}


def test_forbidden_by_whole_name():
    from benchmark import run

    saved = dict(sys.modules)
    try:
        sys.modules["phfpfac_tpu_torch_x"] = sys
        sys.modules.pop("phfpfac_tpu", None)
        assert "phfpfac_tpu" not in run.forbidden_modules()
        sys.modules["phfpfac_tpu.sub"] = sys
        assert run.forbidden_modules() == ["phfpfac_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
