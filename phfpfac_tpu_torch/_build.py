"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes``; no PyTorch headers are
involved, so a build takes seconds.  Libraries are cached under
``build/kernels/<hash>/`` at the repository root, keyed by the source
text, the shared headers (``csrc/*.cuh``) and the compiler flags, and built at the first CUDA launch (or
up front, in parallel, by ``build_all``).  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build" / "kernels"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
SOURCES = ("plan_scan", "planb_scan", "depth_scan", "pair_scan", "phf_scan",
           "probe_gather", "probe_compact")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str):
    """Spawn nvcc for one source; returns (process, tmp, target) or
    None when the cached library is already there."""
    so = _target(name)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, so = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    tmp.replace(so)  # atomic publication for concurrent builders


def build_all(names=SOURCES) -> None:
    """Compile every kernel source, one nvcc per source, concurrently."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
