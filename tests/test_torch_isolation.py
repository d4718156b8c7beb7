"""The port imports neither jax nor the JAX package."""

import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "phfpfac_tpu")

_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "phfpfac_tpu"):
    sys.modules[name] = None  # any import of them now fails
import phfpfac_tpu_torch as P
from phfpfac_tpu_torch.frontend.patterns import Pattern
from phfpfac_tpu_torch.oracle.ac import match_oracle
pats = [Pattern(1, b"he"), Pattern(2, b"she"), Pattern(3, b"hers")]
cfg = P.PfacConfig(width=256, num_shards=2)
m = P.Matcher(P.compile_patterns(pats, cfg), cfg, device="cpu")
data = b"ushers and she said he" * 300
got = [tuple(x) for x in m.match(data).tolist()]
assert got == match_oracle(pats, data, cfg), "mismatch"
loaded = sorted(k for k in sys.modules if k.split(".")[0] in
                ("jax", "jaxlib", "phfpfac_tpu") and sys.modules[k])
assert not loaded, loaded
print("ok", len(got))
"""


def test_port_runs_with_jax_unimportable():
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok ")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_imports_in_port_sources():
    files = sorted((REPO / "phfpfac_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in BANNED, f"{f}: imports {mod}"
