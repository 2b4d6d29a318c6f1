"""Loaded before ``tests/conftest.py``: under pytest-xdist each of the N
workers takes its share of the host's cores for torch (cpu count // N
intra-op threads, one inter-op thread), so that N workers do not start a
full pool each and oversubscribe the host. A run without xdist keeps
torch's defaults."""

import os

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _workers:
    import torch

    torch.set_num_threads(max(1, os.cpu_count() // _workers))
    torch.set_num_interop_threads(1)
