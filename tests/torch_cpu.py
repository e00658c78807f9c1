"""Shared by the port's CPU parity tests (``tests/test_torch_*.py``).

Under ``pytest -n 6`` every xdist worker's torch sizes its intra-op pool to
all of the machine's cores; beside the other workers those pools spin on
their own barriers, and a test of many small ops runs tens of times slower
(the W8A8 kernel emulation at M = 200, N = 8448 on an 8-core CPU box beside
five busy processes: 90.8 s on eight threads, 2.1 s on one).  Each port
test module therefore runs on one torch thread and restores the count
after."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
