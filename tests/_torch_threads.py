"""Test-process settings of the port's tests: one torch intra-op thread,
and JAX's persistent compilation cache while a port test module runs.

The suite runs under pytest-xdist with several workers in parallel, and
each worker's torch would otherwise start an intra-op pool as wide as the
machine, beside XLA's own pools: the workers then oversubscribe the cores
and a port test that takes a second alone takes minutes.  Every
``tests/test_torch_*.py`` imports this module first (``from
_torch_threads import jax_compile_cache``), so the pin holds in each
worker and in the rank processes the mesh tests spawn (they import the
test module that defines their function).  The package itself keeps
torch's default thread count.

Most of a port test's time is the JAX reference compiling its programs
(an ``Engine`` jits its steps afresh for every instance, and several test
files build the same smoke engines).  :func:`jax_compile_cache`, an
autouse fixture of every port test module, turns on JAX's persistent
compilation cache for that module only, in one directory per test session
shared by the xdist workers, so a program compiled once is loaded from
disk the next time, in any worker.  It changes no result: a cache entry is
the executable XLA compiled for the same program on the same host.  The
JAX package's own tests run with the cache off, as before.
"""
import os

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache(tmp_path_factory):
    try:
        from jax._src import compilation_cache as cc
        from jax._src import config as jcfg
    except ImportError:  # the card's machine has no JAX: the gpu tests need none
        yield None
        return

    base = tmp_path_factory.getbasetemp()
    # under xdist each worker's basetemp sits in the session's directory
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "jax_compile_cache"
    path.mkdir(exist_ok=True)
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    old = (jcfg.compilation_cache_dir.value, jcfg.persistent_cache_min_compile_time_secs.value,
           jcfg.persistent_cache_min_entry_size_bytes.value)
    for name, value in zip(names, (str(path), 0.0, old[2])):
        jcfg.config.update(name, value)
    cc.reset_cache()
    yield path
    for name, value in zip(names, old):
        jcfg.config.update(name, value)
    cc.reset_cache()
