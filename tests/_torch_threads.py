"""The thread policy of the port's tests: one autouse fixture that every
`tests/test_torch_*.py` file imports by name
(`from _torch_threads import _one_torch_thread`)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread while each test runs.

    The test suite runs as several pytest workers on one CPU. With torch's
    default of one OpenMP thread per core in every worker, the plain
    run-scatter's few hundred small ops spin their threads against each
    other: the window-edge case took 0.5 s alone and 80 s beside five busy
    copies of itself. One thread keeps it at 0.5 s. The count is restored
    after each test, because torch's setting also sets the OpenMP threads
    that numpy and JAX use in the same worker: one thread there made a JAX
    matmul 1.3-2x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
