"""Torch's intra-op threads in a pytest-xdist worker: the cores shared out
among the workers (at least one each). Every worker otherwise starts a
thread a core, and with several workers on one machine the threads of the
CPU-bound torch tests wait on each other (the teacher's bf16 CLI test ran
4x slower beside five busy processes than with one thread). Imported by
every tests/test_torch_*.py module, so that each worker has set it when it
has collected the tests and before it runs any, whichever files it is then
given; a single-process run keeps torch's default.

`release_module_memory`, which each of those modules imports, frees a
module's memory when its last test is done: the module's own functools
caches (models, trees, JAX steps) and JAX's compiled executables. A worker
runs many modules in one process, and what each keeps adds to the peak of
every later one: a whole run under six workers holds 46-52 GB near its end
(JAX's 8-device dry run in tests/test_graft_entry.py alone 19-26 GB), on
machines of 62 GB."""

import gc
import os
import sys

import pytest
import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))


@pytest.fixture(scope="module", autouse=True)
def release_module_memory(request):
    yield
    for value in list(vars(request.module).values()):
        if callable(getattr(value, "cache_clear", None)) and \
                getattr(value, "__module__", None) == request.module.__name__:
            value.cache_clear()
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()
