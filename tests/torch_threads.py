"""Torch's intra-op threads in the port's CPU tests.

The tests run under pytest-xdist, several workers on one machine's
cores, and each worker's torch would start one OpenMP thread a core:
workers times cores threads, whose spinning barriers then wait on each
other's time slices, so a small op takes milliseconds.  Each test module
of the port imports ``capped_torch_threads``, which gives the module its
worker's share of the cores (all of them when it runs alone) and
restores the count after it.  Ranks that ``dist.spmd.run_ranks`` starts
run one thread each already.
"""
import os

import pytest
import torch


def thread_share() -> int:
    """This process's share of the cores: the cores it may run on over
    the pytest-xdist workers (1 outside xdist), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(1, workers))


@pytest.fixture(autouse=True, scope="module")
def capped_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, thread_share()))
    try:
        yield
    finally:
        torch.set_num_threads(before)
