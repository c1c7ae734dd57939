"""A fixture for the PyTorch port's heavier CPU test modules: two torch
intra-op threads while the module runs. The suite runs several worker
processes side by side (``-n 6``), and torch's default of one thread per
core oversubscribes the machine. Import it into a test module to apply it
there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
