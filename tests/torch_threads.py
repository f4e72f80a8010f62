"""How many intra-op threads torch uses in a process that runs port tests.

The suite runs several pytest-xdist workers on the same cores. Left alone,
each worker's torch keeps a pool as large as the machine, and the port's
small models then spend most of their time with threads waiting on other
workers' threads. So each worker takes its share of the cores: the cores
this process may run on, divided by the number of workers (1 outside
xdist, which keeps the machine's count for a single file or a card run).
Subprocesses the tests start (the parallel ranks, the converter, the
exporter) inherit the count through ``OMP_NUM_THREADS`` unless it is set.

Every ``tests/test_torch_*.py`` imports this module, and importing it
applies the count, once per process, before the module's first test. It
imports neither JAX nor the JAX package, so ``--noconftest`` runs on the
card import it too.
"""

import os

import torch

THREADS = max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
torch.set_num_threads(THREADS)
