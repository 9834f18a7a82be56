"""One CPU thread per test process for the port's tests.

The suite runs in several worker processes at once (``-n 6``), and each
worker's torch would start one OpenMP thread per core; the workers'
threads then spin on each other's cores, and a small op waits on its
whole pool — a tiny recipe run took 50 s instead of 0.5 s beside five
busy workers. ``one_thread`` is an autouse, module-scoped fixture: a port
test module imports it (``from torch_host import one_thread``) and its
tests, and the gangs they start (``OMP_NUM_THREADS``), run single-threaded;
the thread count and the environment are restored after the module. Like
the port, this module imports torch, never JAX.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(threads)
