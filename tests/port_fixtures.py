"""Fixtures of the port's CPU tests, imported by each ``test_torch_*.py``
file that needs them (``from port_fixtures import one_torch_thread``), so
that each setting is decided here once.

Importing this module imports the port and torch only, never JAX.
"""
import pytest
import torch

import mlqem_tpu_torch.parallel.mesh as mesh

# how long ``spawn`` waits for a rank's result in a test: a few times the
# slowest spawning case of the suite (~35 s beside six busy workers), so a
# rank that dies without a result fails its test in two minutes, not the
# program's RANK_TIMEOUT_S
TEST_RANK_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the importing file: the suite runs six
    workers on a few cores, and torch's thread pool, oversubscribed, makes
    small ops tens of times slower. Spawned ranks are new processes and
    keep torch's default."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def bounded_rank_wait():
    """``spawn`` gives up on a rank after TEST_RANK_TIMEOUT_S in the
    importing file, module fixtures that spawn included."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "RANK_TIMEOUT_S", TEST_RANK_TIMEOUT_S)
        yield
