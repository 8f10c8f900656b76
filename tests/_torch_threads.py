"""One torch intra-op thread per test process.

The suite runs under pytest-xdist with several workers in parallel, and
each worker's torch would otherwise start an intra-op pool as wide as the
machine, beside XLA's own pools: the workers then oversubscribe the cores
and a port test that takes a second alone takes minutes.  Every
``tests/test_torch_*.py`` imports this module first, so the pin holds in
each worker and in the rank processes the mesh tests spawn (they import
the test module that defines their function).  The package itself keeps
torch's default thread count.
"""
import torch

torch.set_num_threads(1)
