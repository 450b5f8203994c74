"""The torch thread count of the port's tests, set once on import.

Every ``tests/test_torch_*.py`` imports this module first. Under
``pytest -n N`` each of the N worker processes would otherwise run
torch's intra-op pool at one thread per core, N x cores busy threads on
cores cores, and an OpenMP pool that spins while it waits slows every
worker far more than its share. The workers split the cores instead:
``cores // N`` threads each (at least one); a run without xdist keeps
every core. ``OMP_NUM_THREADS`` is set to the same count, so the
processes a test spawns (dp ranks, CLI runs) start with it too.
"""

import os

import torch


def worker_threads() -> int:
    """Intra-op threads for one test process: the usable cores over the
    xdist worker count (PYTEST_XDIST_WORKER_COUNT, 1 without xdist)."""
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 1)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    return max(1, cores // max(1, workers))


THREADS = worker_threads()
os.environ["OMP_NUM_THREADS"] = str(THREADS)
torch.set_num_threads(THREADS)
