"""The JAX package's reference results for the port's training and eval
tests (``tests/test_torch_train.py``, ``tests/test_torch_eval.py``),
computed in worker processes.

The references need compiles (the JAX Trainer's step alone takes ~25 s), so
they run in a pool of spawned workers, one thread each, while the port's own
tests run in the test process.  A test module names its references when it
is imported (:func:`register`).  The session fixture :func:`jax_refs`
starts the pool at its first use and submits every registered reference at
once, in the order registered; its value reads a result by name (waiting for
it).  The pool stops when every reference has been read, or at the end of
the session.  While it runs, the test process keeps at most 4 torch threads,
so that the workers do not stall its parallel regions.

The overlap is what keeps the port's tests inside their time budget, so the
first port module that runs (``tests/test_torch_detector.py``) asks for the
fixture too, though it reads nothing from it: ``pytest tests/test_torch_*.py``
took 61 s that way and 77 s with the pool started at the first module that
reads it (on an 8-core CPU; 39 s before the training tests came).
"""

import multiprocessing
import os

import pytest
import torch

WORKERS = 3
TEST_THREADS = 4

_REGISTERED = {}  # name -> (fn, args): fn(*args()) runs in a worker
_RUN = {"pool": None, "futures": {}, "results": {}, "threads": None}


def register(name, fn, args=tuple):
    """Name ``fn(*args())`` as a reference; ``fn`` is a module-level function
    (the workers import it by name) and ``args`` builds its arguments in the
    test process when the pool starts."""
    _REGISTERED[name] = (fn, args)


def _init_worker():
    """A worker: JAX on the CPU, one thread for XLA's and torch's kernels."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_multi_thread_eigen=false")
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)


def _start():
    if _RUN["pool"] is not None or _RUN["results"]:
        return
    _RUN["threads"] = torch.get_num_threads()
    torch.set_num_threads(min(_RUN["threads"], TEST_THREADS))
    _RUN["pool"] = multiprocessing.get_context("spawn").Pool(WORKERS, _init_worker)
    for name, (fn, args) in _REGISTERED.items():
        _RUN["futures"][name] = _RUN["pool"].apply_async(fn, args())


def _stop():
    """Stop the workers at once (what they have not finished is not read)."""
    pool = _RUN["pool"]
    if pool is not None:
        _RUN["pool"] = None
        _RUN["futures"].clear()
        pool.terminate()
        pool.join()
        torch.set_num_threads(_RUN["threads"])


class References:
    """``refs[name]``: the result of a registered reference."""

    def __getitem__(self, name):
        if name not in _RUN["results"]:
            _RUN["results"][name] = _RUN["futures"][name].get()
            if _RUN["results"].keys() >= _REGISTERED.keys():
                _stop()
        return _RUN["results"][name]


@pytest.fixture(scope="session")
def jax_refs():
    _start()
    try:
        yield References()
    finally:
        _stop()
