"""The port's CPU tests run torch on one intra-op thread.

In the suite's parallel run each worker's tiny CPU ops would otherwise
open OpenMP regions sized for every core and wait on the other workers'
(as tests/test_torch_port_distill_ab.py notes). A test module takes the
pin with one line:

    from _torch_threads import _one_thread  # noqa: F401
"""

import pytest
import torch

# the intra-op thread count each module in flight had before the pin
THREADS_FOUND: list[int] = []


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module that imports this fixture."""
    THREADS_FOUND.append(torch.get_num_threads())
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(THREADS_FOUND.pop())
