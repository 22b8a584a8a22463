"""One intra-op thread for the port's CPU tests.

The suite runs in several worker processes at once, and PyTorch's OpenMP
pool, one thread per core in each worker, oversubscribes the cores: six
processes each running FRCRN's forward took 82 s a forward with the default
pool against 1–2 s with one thread each, on an 8-core host. Each port test
file imports this fixture; it holds for that file's tests and restores the
pool after them.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
