"""PyTorch port, the CPU tests' torch thread pool: ``one_torch_thread``
is an autouse fixture the in-process port test files import. The tests
run as several workers on one shared CPU, where a pool of a thread a core
waits at every op's barrier for its descheduled threads: a small model's
training step ran ~30x slower under that load than alone. One intra-op
thread per file keeps each worker's torch work to its own core; the
count is restored after the file."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_torch_runs_on_one_thread_inside_a_file():
    assert torch.get_num_threads() == 1
