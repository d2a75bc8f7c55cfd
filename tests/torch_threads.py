"""One intra-op thread for each process that runs the port's tests.

Every `tests/test_torch_*.py` imports this module first. The suite runs
under pytest-xdist with several workers on a few cores: with torch's
default (one OpenMP thread a core) each worker's kernels spin-wait on
threads that the other workers hold, and a 3 s test takes minutes. The
setting is per process, so it holds for every test a worker runs once any
of these modules is imported, whatever the order; the ranks that the
multi-process tests start set it themselves."""
import torch

torch.set_num_threads(1)
