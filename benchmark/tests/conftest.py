"""The benchmark's own tests: on the CPU, at sizes a test run holds.
Run from the repository root:

    python -m pytest benchmark/tests -q
    python -m pytest benchmark/tests -q -m cuda   # on a machine with a card

A test that needs the card is marked ``cuda`` and skips without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (skips where there is none)")
