"""One intra-op thread for the port's CPU work in a test module.

The tier-1 run puts six pytest workers on the machine's cores at once. A
torch process otherwise starts an OpenMP team of one thread a core for
every operator, and the teams' spin-waits then starve one another: one
epoch of YOLOv8 training in ``tests/test_torch_device_aug.py`` took 0.7 s
alone and 34 s beside six busy processes, and 0.7 s beside them with one
thread. A module imports ``one_torch_thread`` to run its tests so; the
count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
