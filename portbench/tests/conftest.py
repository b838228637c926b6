"""The benchmark's own tests (not part of the repository's tier-1 run):
``python -m pytest portbench/tests -q`` from the repository's root.

Tests marked ``card`` need a CUDA card; each decides inside itself
whether there is one and skips here with the reason. Nothing here
imports JAX or the JAX package."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")
