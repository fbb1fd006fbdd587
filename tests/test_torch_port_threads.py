"""Under pytest-xdist, each worker process runs torch's CPU kernels on its
share of the machine's cores.

torch starts as many intra-op threads as the machine has cores, in every
process. With several xdist workers the processes then run several times
more threads than there are cores, and their OpenMP threads wait on each
other: the port's test files took about five times longer under 6 workers
with torch's default than with 2 threads a worker (CHANGES.md, PR 16). Each
worker imports every test module while it collects, before any test runs,
so this module sets the share for the worker's whole run; a run without
xdist keeps torch's default.
"""

import os

import torch

#: the process's cores over the number of xdist workers (None without xdist)
WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
SHARE = (max(1, len(os.sched_getaffinity(0)) // int(WORKERS)) if WORKERS else None)
if SHARE is not None:
    torch.set_num_threads(SHARE)


def test_torch_threads_are_the_workers_share():
    """An xdist worker runs its share; a plain run keeps torch's default."""
    assert (SHARE is None) == ("PYTEST_XDIST_WORKER" not in os.environ)
    if SHARE is not None:
        assert torch.get_num_threads() == SHARE
