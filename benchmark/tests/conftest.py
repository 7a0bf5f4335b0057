"""The benchmark's own tests (run with ``python -m pytest benchmark/tests``
from the root of the repo). Tests marked ``chip`` need a CUDA card and
skip without one; they decide that inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (runs the cell's control on it)")
