"""The benchmark's CPU tests: run them from the root of the checkout with

    python -m pytest -q portbench/tests

They import the harness and the port from the checkout (``portbench``,
``src/repro_torch``); the card's tests are marked ``cuda`` and skip
without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
