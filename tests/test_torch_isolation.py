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
for engine in ("turbo", "jnp"):
    e = P.Matcher(m.compiled, cfg, engine=engine, device="cpu")
    assert [tuple(x) for x in e.match(data).tolist()] == got, engine
assert int(m.count_matches(data).sum()) == len(got)
from phfpfac_tpu_torch import convert
from phfpfac_tpu_torch.ops import engine_select, pair, reference, scan, turbo
from phfpfac_tpu_torch.ops.common import pad_input, padded_steps
sh = m.compiled.shards[0]
ms = padded_steps(sh.max_pat_len)
padded = pad_input(data, 1024, ms)
total = int(engine_select.best_count_scanner(sh, ms, device="cpu")(
    padded, len(data), 0))
for make in (pair.pair_count_scanner, scan.pallas_count_scanner,
             engine_select.xla_count_scanner):
    assert int(make(sh, ms, device="cpu")(padded, len(data), 0)) == total
from phfpfac_tpu_torch.compile.tables import compile_class_patterns
from phfpfac_tpu_torch.frontend.charset import parse_class_pattern
from phfpfac_tpu_torch.oracle.ac import match_oracle_charset
from phfpfac_tpu_torch.ops import plan
from phfpfac_tpu_torch.parallel.stream import StreamMatcher, match_many
sm = StreamMatcher(m.compiled, cfg, device="cpu")
fed = [tuple(x) for k in range(0, len(data), 1000)
       for x in sm.feed(data[k:k + 1000]).tolist()]
assert sorted(fed) == sorted(got)
assert sum(len(o) for o in match_many(m, [data[:500], data[500:900]])) > 0
staged = m.stage_for_chunked(data, chunk_bytes=2048)
assert [tuple(x) for x in m.match_chunked(
    data, chunk_bytes=2048, device_data=staged).tolist()] == got
cps = [parse_class_pattern(b"[sh]e", 1), parse_class_pattern(b"he[rs]", 2)]
cm = P.Matcher(compile_class_patterns(cps, cfg), cfg, device="cpu")
assert [tuple(x) for x in cm.match(data).tolist()] == \
    match_oracle_charset(cps, data, cfg)
sh1 = m.compiled.shards[1]  # "hers", "she": two steps past the prologue
sc = plan.PlanCountScan(sh1, ms, device="cpu", compact=(1, 32768))
big = pad_input(data * 8, 1024, ms)
off = plan.PlanCountScan(sh1, ms, device="cpu", compact="off")
real, calls = plan.plan_scan_compact, []
plan.plan_scan_compact = lambda *a, **k: calls.append(1) or real(*a, **k)
assert int(sc(big, len(data) * 8, 0)) == int(off(big, len(data) * 8, 0)) \
    >= 8 * 600
assert len(calls) == 1 and not sc.check_overflow()
from phfpfac_tpu_torch.dryrun import dryrun_multichip
from phfpfac_tpu_torch.parallel.distributed import MultiHostMatcher
from phfpfac_tpu_torch.parallel.mesh import DistributedMatcher, make_mesh
from phfpfac_tpu_torch.parallel.mesh_pallas import (
    PallasMeshMatcher, PlanMeshMatcher)
from phfpfac_tpu_torch.probes import compact, gather
from phfpfac_tpu_torch.probes import __main__ as probes_main
from phfpfac_tpu_torch.utils import profile
mesh = make_mesh(2, 2, ["cpu"] * 4)
assert [tuple(x) for x in DistributedMatcher(
    m.compiled, cfg, mesh).match(data).tolist()] == got
xcfg = P.PfacConfig(width=256, num_shards=2, truncation="none")
xc = P.compile_patterns(pats, xcfg)
for cls in (PallasMeshMatcher, PlanMeshMatcher):
    assert [tuple(x) for x in cls(xc, xcfg, mesh).match(data).tolist()] == got
mh = MultiHostMatcher(m.compiled, cfg, devices=["cpu"] * 4)
assert [tuple(x) for x in mh.match(data).tolist()] == got
assert mh.last_engine == "plan"
assert dryrun_multichip(2, ["cpu"] * 2)["multihost_engine"] == "plan"
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
    files += [REPO / "chip_smoke.py", REPO / "chip_fuzz.py",
              REPO / "plan_times.py", REPO / "chip_e2e.py"]
    assert len(files) > 25
    names = {f.name for f in files}
    assert {"turbo.py", "reference.py", "scan.py", "pair.py",
            "engine_select.py", "stream.py", "charset.py", "mesh.py",
            "mesh_pallas.py", "distributed.py", "dryrun.py", "gather.py",
            "compact.py", "profile.py"} <= names
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in BANNED, f"{f}: imports {mod}"
