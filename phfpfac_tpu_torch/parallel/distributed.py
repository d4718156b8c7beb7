"""Multi-process scale-out: ``torch.distributed`` + per-process data
parallelism.

The counterpart of the JAX package's ``parallel/distributed.py``.  The
reference has no multi-node story: multi-GPU is one process with OpenMP
threads (main.cc:180-241), and its author split corpora by hand.  This
automates that split:

* ``initialize()`` — the process group bootstrap (coordinator address,
  world size, rank);
* the byte stream is cut at PROCESS granularity (``local_slice``: each
  process seeks and reads only its contiguous range, plus a
  ``max_pat_len - 1``-byte tail re-read from the file, so walks that
  cross a process boundary survive without any traffic between
  processes);
* inside a process the slice is scanned on a local ("data", "patterns")
  mesh of its devices: the plan-kernel mesh (``parallel.mesh_pallas``)
  where the plan tables take the dictionary, else the turbo mesh
  (``parallel.mesh``);
* per-process match lists are exchanged with ``all_gather`` (sizes
  first, then payloads padded to the largest) and merged by position:
  positions partition across processes, so the reference's (position,
  shard-major) output order is preserved exactly.

What crosses processes is host-side int64 match lists, never device
tensors, so the default backend is ``gloo``; with ``nccl`` the payload
goes through the rank's device.

Only a table build's own refusal (``PairUnsupported``,
``DepthUnsupported``) sends a scan from the plan mesh to the turbo mesh;
any other exception is a fault and propagates.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from phfpfac_tpu_torch.compile.depth import DepthUnsupported
from phfpfac_tpu_torch.compile.pair import PairUnsupported
from phfpfac_tpu_torch.compile.tables import CompiledDictionary
from phfpfac_tpu_torch.ops.common import resolve_device
from phfpfac_tpu_torch.parallel.mesh import DistributedMatcher, make_mesh
from phfpfac_tpu_torch.utils.config import PfacConfig


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the process group (no-op for single-process runs)."""
    if num_processes is None or num_processes == 1:
        return
    dist.init_process_group(
        backend or "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def finalize() -> None:
    """Leave the process group ``initialize`` joined, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_slice(path: str, *, input_size: int | None = None) -> tuple:
    """This process's contiguous byte-stream slice and global metadata.

    Returns (local_bytes, global_start, global_input_size).  Only the
    local range is read: no process touches the full corpus.
    """
    total = os.path.getsize(path)
    if input_size is None:
        input_size = total
    n_proc, pid = process_count(), process_index()
    block = -(-input_size // n_proc)
    start = min(pid * block, input_size)
    end = min(start + block, input_size)
    with open(path, "rb") as f:
        f.seek(start)
        data = f.read(end - start)
    return data, start, input_size


def _gather_device() -> torch.device:
    """Where all_gather's tensors live: the host for gloo, the rank's
    current CUDA device for nccl."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather(x: torch.Tensor) -> torch.Tensor:
    """[world, *x.shape]: every process's ``x`` (equal shapes)."""
    outs = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, x)
    return torch.stack(outs)


def _allgather_matches(local: np.ndarray) -> np.ndarray:
    """Exchange variable-length (pos, id) lists across processes."""
    dev = _gather_device()
    sizes = _allgather(
        torch.tensor([local.size], dtype=torch.int64, device=dev)
    ).reshape(-1).cpu().numpy()
    cap = int(sizes.max(initial=0))
    if cap == 0:
        return np.empty((0, 2), dtype=np.int64)
    payload = np.zeros(cap, dtype=np.int64)
    payload[: local.size] = local.reshape(-1)
    gathered = _allgather(torch.from_numpy(payload).to(dev)).cpu().numpy()
    parts = [
        gathered[i, : int(sizes[i])].reshape(-1, 2)
        for i in range(len(sizes))
    ]
    return np.concatenate(parts)


class MultiHostMatcher:
    """Matcher over every process of the group: processes shard the
    input stream, each process's devices form a ("data", "patterns")
    mesh over its slice.

    ``devices``: this process's devices (default: every visible CUDA
    device; ``device="cpu"`` or an explicit list otherwise, in which one
    device may appear more than once)."""

    def __init__(
        self,
        compiled: CompiledDictionary,
        config: PfacConfig,
        *,
        n_patterns_axis: int | None = None,
        devices=None,
        device=None,
    ):
        if devices is None:
            dev = resolve_device(device)
            devices = (
                [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" and dev.index is None else [dev]
            )
        local = [torch.device(d) for d in devices]
        n_dev = len(local)
        n_pat = n_patterns_axis or min(compiled.num_shards, n_dev)
        while n_dev % n_pat or compiled.num_shards % n_pat:
            n_pat -= 1
        self.mesh = make_mesh(n_dev // n_pat, n_pat, devices=local)
        self.dm = DistributedMatcher(compiled, config, self.mesh)
        self.compiled = compiled
        self.config = config
        self._local = local
        # the plan kernel over the local mesh, built at the first scan
        # (its profile-guided layout trains on that input's head); the
        # turbo mesh carries what the plan tables refuse (patterns past
        # 32 steps, segments that are no power of two)
        self._plan = None
        self._plan_refused = False
        # which engine the last scan used ("plan" or "turbo"), so that a
        # caller can ASSERT the kernel path ran
        self.last_engine: str | None = None

    def _get_plan(self, train: bytes):
        if self._plan_refused:
            return None
        if self._plan is None:
            from phfpfac_tpu_torch.parallel.mesh_pallas import PlanMeshMatcher

            n_dev, ns = len(self._local), self.compiled.num_shards
            if n_dev % ns == 0:
                mesh = make_mesh(n_dev // ns, ns, devices=self._local)
            else:  # pure data mesh; shards loop on the host
                mesh = make_mesh(n_dev, 1, devices=self._local)
            try:
                self._plan = PlanMeshMatcher(
                    self.compiled, self.config, mesh, train=train,
                )
            except (PairUnsupported, DepthUnsupported):
                # the tables' own refusal, nothing else
                self._plan_refused = True
                return None
        return self._plan

    def _match_local(self, data: bytes, input_size: int):
        plan = self._get_plan(bytes(data[: 1 << 20]))
        if plan is not None:
            out = plan.match(data, input_size=input_size)
            self.last_engine = "plan"
            return out
        self.last_engine = "turbo"
        return self.dm.match(data, input_size=input_size)

    def match(self, data: bytes, *, input_size: int | None = None):
        """Match when this process holds the whole input."""
        if input_size is None:
            input_size = len(data)
        return self._match_local(data, input_size)

    def match_file(self, path: str, *, input_size: int | None = None):
        """Cooperatively match a corpus file, each process reading only
        its slice; every process returns the full merged match list."""
        if process_count() == 1:
            with open(path, "rb") as f:
                data = f.read()
            if input_size is None:
                input_size = len(data)
            return self._match_local(data, input_size)

        data, start, input_size = local_slice(path, input_size=input_size)
        halo = max(self.compiled.max_pat_len - 1, 0)
        with open(path, "rb") as f:
            f.seek(start + len(data))
            tail = f.read(halo)
        ext = data + tail

        local = np.asarray(
            self._match_local(ext, min(len(ext), input_size - start))
        )
        # keep matches starting inside this process's slice; global coords
        if local.size:
            local = local[local[:, 0] < max(len(data), 1)]
            local = local + np.array([start, 0], dtype=np.int64)
        out = _allgather_matches(local.astype(np.int64))
        # positions partition across processes and each part is already
        # in reference order, so a stable sort by position reproduces the
        # global reference order
        order = np.argsort(out[:, 0], kind="stable")
        return out[order]
