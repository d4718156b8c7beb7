"""Measurement probes of the card: the dependent-gather rate by table
size and element type (``probes.gather``) and the price of compacting a
block's live walkers inside a kernel (``probes.compact``).  Run
``python -m phfpfac_tpu_torch.probes`` for one JSON line per arm."""


import torch


def need_card(device) -> torch.device:
    """``device`` as a torch.device; the sweeps time kernels, so anything
    but a CUDA device is refused."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the sweep times the kernels: it needs a CUDA "
                         "device")
    return dev
