"""``python -m phfpfac_tpu_torch.probes``: run both probe sweeps on the
CUDA device and print one JSON line per arm."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from phfpfac_tpu_torch.probes import compact, gather


def main(argv=None) -> int:
    argparse.ArgumentParser(prog="python -m phfpfac_tpu_torch.probes",
                            description=__doc__).parse_args(argv)
    if not torch.cuda.is_available():
        print("the probes time CUDA kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)
    for row in gather.sweep():
        print(json.dumps({"probe": "gather", **row}), flush=True)
    for row in compact.sweep():
        print(json.dumps({"probe": "compact", **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
