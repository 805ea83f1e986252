"""A module fixture that runs torch on one thread, for the port's CPU test
files to import (``from torch_threads import one_torch_thread``).

The tier-1 run has six workers on the machine's cores. With torch's
intra-op threads in each, torch's small ops run hundreds of times slower
than alone (50 SGD steps of ConvNetW8 at 32x32: 0.25 s in one process,
102 s in each of six 8-thread processes at once, 5 s with one thread
each), and a file of them sets the run's wall.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for the importing module's tests, and back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
