"""Cap torch's intra-op threads in each pytest-xdist worker.

Under `pytest -n N` every worker process would start one intra-op thread
per core beside JAX's own thread pool, N times over: on a box of a few
cores the workers then fight for the cores, and a test that takes seconds
alone takes minutes. Each of the port's test files imports this module,
and every xdist worker imports every test file while it collects them, so
each worker caps its threads at its share of the cores, whatever files it
runs. Outside xdist nothing changes. The subprocesses some tests start set
`OMP_NUM_THREADS=1` for the same reason.
"""

import os

import torch


def worker_threads() -> int | None:
    """Intra-op threads for this process: the cores over the xdist
    workers, at least 1; None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


if worker_threads() is not None:
    torch.set_num_threads(worker_threads())
