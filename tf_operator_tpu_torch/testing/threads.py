"""One torch thread in a test process, as in the processes the tests start.

The CPU tests run in several pytest workers at once on one host, and the
processes they start run with ``OMP_NUM_THREADS=1``. A worker's own torch
ops would otherwise take a thread per core each, every worker's threads
contending for the same cores with the other workers and their children.
A test module imports :func:`one_torch_thread`; being autouse, it holds
torch at one intra-op thread for the module's tests and its fixtures, and
restores the count after them.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
