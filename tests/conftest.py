"""Make ``src/`` and this directory importable regardless of invocation cwd.

Keeps the tier-1 command (``PYTHONPATH=src python -m pytest``) working while
also letting a bare ``pytest`` run find both ``repro`` and the ``_hyp``
hypothesis shim.
"""
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
for p in (str(_HERE), str(_HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skipped without one"
    )
