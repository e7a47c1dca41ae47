"""The CPU tests run tiny steps: two threads each, so that several pytest
workers on one host do not oversubscribe its cores (with a thread per core
in every worker, the workers' OpenMP threads starve each other)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _two_threads():
    torch.set_num_threads(2)
