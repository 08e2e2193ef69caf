"""Shared settings of the benchmark's CPU tests."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Two CPU threads: on a shared host more threads than free cores slow
    a small convolution twenty-fold."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
