"""The benchmark's own tests: `python -m pytest etlbench/tests -q` from
the root of the repository. They run on the CPU with the port's plain
versions at small sizes; the test marked `gpu` runs one cell on the card
and skips where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's kernel tests)")
