"""Thread pools of the port's test files under pytest-xdist.

At their defaults every xdist worker runs PyTorch's OpenMP pool and
numpy's BLAS pool at one thread a core, and the workers' pools spin
against each other: with 6 workers on 8 cores the port's test files ran
about three times slower than with two threads a worker.  A test file
imports the module-scoped autouse fixture below by name, which sizes
both pools to the worker's share of the cores while the file's tests
run.  Without xdist, or with a thread count set in the environment,
nothing changes.
"""

import os

import pytest
import torch


def worker_share():
    """Threads a worker gets under xdist, or None to leave the pools be."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers < 2 or "OMP_NUM_THREADS" in os.environ:
        return None
    return max(1, -(-len(os.sched_getaffinity(0)) // workers))


@pytest.fixture(autouse=True, scope="module")
def share_the_cores():
    threads = worker_share()
    if threads is None:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        limits = None
    else:
        limits = threadpool_limits(threads, user_api="blas")
    try:
        yield
    finally:
        if limits is not None:
            limits.restore_original_limits()
        torch.set_num_threads(before)
