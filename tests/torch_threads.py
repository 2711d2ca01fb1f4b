"""Caps torch's intra-op threads in a test process of the port.

Under ``pytest -n N`` (xdist) every worker would start one torch thread
a core, so N workers oversubscribe the machine N times over and a CPU
training case runs many times slower than alone.  Each port test file
imports this module first: a worker then keeps its share of the cores,
``max(1, os.cpu_count() // PYTEST_XDIST_WORKER_COUNT)`` threads (all of
them without xdist).
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
torch.set_num_threads(min(torch.get_num_threads(),
                          max(1, (os.cpu_count() or 1) // max(1, _WORKERS))))
