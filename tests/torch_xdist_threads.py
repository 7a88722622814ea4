"""Torch's intra-op threads in a pytest-xdist worker: the cores shared out
among the workers (at least one each). Every worker otherwise starts a
thread a core, and with several workers on one machine the threads of the
CPU-bound torch tests wait on each other (the teacher's bf16 CLI test ran
4x slower beside five busy processes than with one thread). Imported by
every tests/test_torch_*.py module, so that each worker has set it when it
has collected the tests and before it runs any, whichever files it is then
given; a single-process run keeps torch's default."""

import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
