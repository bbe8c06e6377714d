"""One intra-op thread for the port's CPU tests.

The tier-1 command runs the suite in six worker processes at once, and
each process's PyTorch starts an OpenMP pool as wide as the host.  The
port's CPU paths run many small operators; with every worker's pool
spinning at once, each parallel region waits for threads the host cannot
schedule.  ``test_torch_port_cli.py::test_cli_trains_both_phases_and_resumes``
took 462 s in such a run against 9 s alone, on an 8-core host.
Each port test module imports ``one_torch_thread``, an autouse fixture
that runs the module on one thread and gives the process its width back
after it (the mesh tests' ranks and references run on one thread
already, ``torch_mesh_worker.py``):

    from torch_port_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)
