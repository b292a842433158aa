"""Registers the marker of the card-only tests (``pytest -m cuda
fieldbench`` runs them on a machine with a card) and puts the program
(``src/``) on the path, as ``run.py`` does."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parent.parent / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")
