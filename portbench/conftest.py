"""pytest settings of the benchmark's own tests: the ``cuda`` marker (tests
that need a card skip without one), the checkout's ``src`` and root on the
path, and under pytest-xdist the cores shared among the workers."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
