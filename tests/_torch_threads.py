"""A module-scoped fixture that runs a test file's torch ops on one
intra-op thread.

Under pytest-xdist every worker process's torch takes a thread a core by
default, so several workers on one machine's cores make each other's
small torch ops wait on busy threads: on an 8-core machine six copies of
``test_torch_hybrid_train.py``'s trainer cases ran ~80x slower together
than one alone, and ~1.5x slower with one thread each.  A file imports
``one_torch_thread`` to run its tests on one thread; the count it found is
restored after the file.  No tolerance depends on it.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
