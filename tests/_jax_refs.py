"""The JAX package's reference results for the port's training and eval
tests (``tests/test_torch_train.py``, ``tests/test_torch_eval.py``),
computed in worker processes.

The references need compiles (the JAX Trainer's step alone takes ~25 s), so
they run in a pool of spawned workers, one thread each, while the port's own
tests run in the test process.  A test module names its references when it
is imported (:func:`register`), with the tests that read one where only
they do.  The session fixture :func:`jax_refs` starts the pool at its first
use and submits at once every reference that a selected test reads (a
reference of deselected tests, such as ``slow`` ones under ``-m 'not
slow'``, is not computed): the ``early`` ones first, then in the order of
the first test that reads each (a reference without named readers: the
first test of the module that registered it); its value reads a result by
name (waiting for it).  The pool stops when every submitted reference has been
read, or at the end of the session.  While it runs, the test process keeps
at most 4 torch threads, so that the workers do not stall its parallel
regions.

The overlap is what keeps the port's tests inside their time budget, so the
first port module that runs (``tests/test_torch_config.py``) asks for the
fixture too, though it reads nothing from it: ``pytest tests/test_torch_*.py``
took 61 s with the pool started at ``tests/test_torch_detector.py`` and 77 s
with the pool started at the first module that reads it (on an 8-core CPU;
39 s before the training tests came).  The longest references (the JAX
calibrations, ~18 s of a worker, the float64 JAX Trainer, ~29 s, which
``tests/test_torch_spatial.py`` reads before its own module runs, and the
float64 Trainer at the three multi-scale bucket shapes, one compile each)
are registered ``early``: submitted first, they are ready when their readers
come and hold up no shorter reference behind them.
"""

import multiprocessing
import os
import sys

import pytest
import torch

WORKERS = 4
TEST_THREADS = 4

_REGISTERED = {}  # name -> (fn, args, tests, early, module): fn(*args()) runs in a worker
_RUN = {"pool": None, "futures": {}, "results": {}, "submitted": set(), "threads": None}


def register(name, fn, args=tuple, tests=(), early=False):
    """Name ``fn(*args())`` as a reference; ``fn`` is a module-level function
    (the workers import it by name) and ``args`` builds its arguments in the
    test process when the pool starts.  ``tests``: the tests that read it,
    when only they do (it is computed only if one of them is selected): a
    test function's name (all its cases) or the start of a case's name
    (``"test_f[lite"``); empty for a reference computed in every session.
    ``early``: submit it before the others (a long reference)."""
    _REGISTERED[name] = (fn, args, tuple(tests), early, sys._getframe(1).f_globals["__name__"])


def _reads(test: str, names) -> bool:
    return any(n == test or n.startswith(test if "[" in test else test + "[") for n in names)


def _init_worker():
    """A worker: JAX on the CPU, one thread for XLA's and torch's kernels, at
    a lower scheduling priority.  XLA still compiles on several threads (a
    worker keeps 3-4 cores busy while it compiles), so three workers at the
    test process's priority crowd its cores; niced, they take the cores it
    leaves idle (the port's tests: 80-97 s against 113-131 s in one window
    of alternating runs on an 8-core CPU)."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_multi_thread_eigen=false")
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    os.nice(10)


def _start(items):
    if _RUN["pool"] is not None or _RUN["results"]:
        return
    selected = [item.name for item in items]
    modules = [item.module.__name__ for item in items]

    def order(name):
        _, _, tests, early, module = _REGISTERED[name]
        if tests:
            at = [i for i, n in enumerate(selected) if any(_reads(t, (n,)) for t in tests)]
        else:
            at = [i for i, m in enumerate(modules) if m == module]
        return not early, at[0] if at else len(selected)

    _RUN["threads"] = torch.get_num_threads()
    torch.set_num_threads(min(_RUN["threads"], TEST_THREADS))
    _RUN["pool"] = multiprocessing.get_context("spawn").Pool(WORKERS, _init_worker)
    for name in sorted(_REGISTERED, key=order):
        fn, args, tests, _, _ = _REGISTERED[name]
        if not tests or any(_reads(t, selected) for t in tests):
            _RUN["submitted"].add(name)
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
            if _RUN["results"].keys() >= _RUN["submitted"]:
                _stop()
        return _RUN["results"][name]


@pytest.fixture(scope="session")
def jax_refs(request):
    _start(request.session.items)
    try:
        yield References()
    finally:
        _stop()
