"""torch's CPU threads under pytest-xdist: each worker gets its share of
the cores.

torch starts one intra-op thread per core in every process.  Under
`-p xdist -n N` that is N times the cores, and the port's CPU checks,
whose threads spin while they wait, then run 10-50 times slower than
alone (the checkpoint digests of `test_torch_batch_digests.py`: 5 s
alone, 91 s in one of four workers).  pytest imports every test module
in every worker while it collects, before any test runs, so this
module, imported there, sets the count for every port test of the
worker.  Outside xdist the count stays torch's default.
"""

import os

import pytest

torch = pytest.importorskip("torch")


def share_of_the_cores() -> int:
    """The threads each worker gets: the cores this process may run on,
    divided among the workers, at least one; torch's default outside
    xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers <= 0:
        return torch.get_num_threads()
    return max(1, len(os.sched_getaffinity(0)) // workers)


torch.set_num_threads(share_of_the_cores())


def test_each_worker_gets_its_share_of_the_cores():
    assert torch.get_num_threads() == share_of_the_cores()
    if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
        workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
        assert torch.get_num_threads() * workers <= max(
            workers, len(os.sched_getaffinity(0)))
