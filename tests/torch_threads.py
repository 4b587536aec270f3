"""One intra-op thread for PyTorch in a test process.

The suite runs under pytest-xdist with several workers on a machine with
few cores, and each worker would start one PyTorch intra-op thread per
core: the workers' threads then spin against each other, and a fit of
many small tensor operations ran ~25x slower than alone (a config-2 OU
fit with a smooth: 14 s alone on one thread, 363 s with six concurrent
8-thread processes, on an 8-core machine). The port's CPU tests work on
small tensors, where one thread loses nothing. Every torch test module
imports this; each xdist worker imports every module at collection, so
the setting holds for all of them.
"""

import torch

torch.set_num_threads(1)
