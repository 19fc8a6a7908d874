"""The ``shared_cores`` fixture for the port's CPU tests.

PyTorch starts one intra-op thread a core in every process. Under
pytest-xdist each worker does so, and the workers' threads then contend
for the same cores: a model test that takes a fraction of a second alone
takes tens of seconds beside five busy workers. The fixture gives torch
its share of the cores for the module's tests and restores the count
after them. A module takes it with

    from torch_cores import shared_cores  # noqa: F401
    pytestmark = pytest.mark.usefixtures("shared_cores")
"""
import os

import pytest
import torch


def core_share() -> int:
    """This process's share of the cores it may run on, one part for each
    pytest-xdist worker (all of them outside xdist)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(1, workers))


@pytest.fixture(scope="module")
def shared_cores():
    before = torch.get_num_threads()
    torch.set_num_threads(core_share())
    yield
    torch.set_num_threads(before)
