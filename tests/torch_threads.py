"""Share the machine's cores among pytest-xdist workers.

Each worker process is a PyTorch process whose intra-op pool defaults to one
thread per core, so ``-n 6`` on eight cores runs 48 threads on eight cores
and the CPU versions of the kernels crawl.  Imported by every
``test_torch_*.py``: under xdist (``PYTEST_XDIST_WORKER_COUNT`` set) it caps
the pool once per worker at ``cpu_count // workers``; a plain ``pytest`` run
keeps PyTorch's default.
"""
import os

import torch


def share_cores() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))


share_cores()
