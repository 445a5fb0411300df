"""One torch thread for the port's CPU tests.

The suite runs under pytest-xdist (``-n 6``), and every worker's torch
starts as many OpenMP threads as the machine has cores: six workers then
oversubscribe the cores, and OpenMP's spin-waits make a test's many small
ops 10-200x slower (the port's test files took 1,288 s together on six
workers of an eight-core machine, and 86 s with one thread a worker).
The port tests' shapes are small, so one thread loses little. A test
module opts in by importing the fixture:

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
