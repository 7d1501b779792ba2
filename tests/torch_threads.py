"""One torch intra-op thread for a test module's runs (import the fixture
into the module: `from torch_threads import one_intra_op_thread`).

The tier-1 run has six pytest workers on eight cores, each process with
a pool of eight intra-op threads that spin at their barriers: a bf16
ResNet-50 gate of tests/test_torch_smoke_oracle.py took 6.6 s alone and
132 s beside four other test processes, and 12.3 s with one thread a
process under the same load."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
