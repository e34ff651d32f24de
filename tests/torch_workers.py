"""Torch's CPU threads for the port's tests under pytest-xdist.

Every ``tests/test_torch_*.py`` imports this module, and the import applies
the cap, so it holds from collection on in every worker. Set threads
nowhere else in the tests.
"""

import os

import torch


def cap_threads():
    """Give each xdist worker its share of the cores, ``max(1, cores //
    workers)`` torch threads, and hand the same to the processes it spawns
    (``OMP_NUM_THREADS``, ``MKL_NUM_THREADS``; torch's own setting is not
    inherited). Without xdist, leave torch's defaults alone.

    Torch's default is a thread a core: 6 workers on an 8-core host ran 48
    spinning threads, and ``test_torch_bench.py``'s ``[train]`` case took
    355-368 s in the whole suite there, against 12.8 s with a thread a
    worker.
    """
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return
    n = max(1, len(os.sched_getaffinity(0)) // int(workers))
    torch.set_num_threads(n)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(n))


cap_threads()
