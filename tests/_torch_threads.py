"""One intra-op PyTorch thread while a module of the port's CPU tests runs.

The port's tests run small shapes, where PyTorch's default of one
intra-op thread a core gains little, and where under ``pytest -n 6`` six
workers of eight threads each oversubscribe the cores, and spinning
threads made a file of these tests several times slower beside five
others. A test
module takes the fixture by importing it; the previous thread count comes
back when the module ends, so other modules in the same worker keep
theirs.
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
