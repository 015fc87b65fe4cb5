"""Processes that the port's tests start early and read late.

The multi-process checks spend most of their time starting interpreters and
running ranks that need nothing from the test process.  Session fixtures
start them, where a test that reads them is selected, the first time a test
module asks for them: the first port module (``tests/test_torch_config.py``)
asks for both, so the ranks run while the pool of JAX references
(``tests/_jax_refs.py``) is still starting, and are done when their readers
come.  Alone, a reader's module starts them itself.  They run at ``nice 19``,
below the test process and the reference workers (``nice 10``): they use
the cores those leave idle, and do not hold up the references that the
modules in between read.  Each module that
imports a fixture holds a definition of its own, so the processes live in
``_STARTED``: the first definition used starts them, every later one gets
the same.

* :func:`dryrun_two_ranks`: ``python -m yolofastest_torch.parallel.dryrun
  --device cpu`` (two gloo ranks), read by
  ``tests/test_torch_parallel.py::test_dryrun_two_ranks_on_cpu``;
* :func:`two_rank_processes`: two gloo ranks of ``tests/_torch_ranks.py``
  ``trajectory_rank`` (data parallelism, then the (1, 2) spatial mesh),
  read by ``tests/test_torch_train.py::test_two_ranks_match_jax_float64``
  and ``tests/test_torch_spatial.py``;
* :func:`spatial_processes`: four gloo ranks of ``tests/_torch_ranks.py``
  ``spatial_rank``, read by ``tests/test_torch_spatial.py``.
"""

import multiprocessing
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN_TEST = "test_dryrun_two_ranks_on_cpu"
TWO_RANKS_TESTS = ("test_two_ranks_match_jax_float64", "test_spatial_executor_matches_folded_apply",
                   "test_spatial_trainer_matches_jax_float64",
                   "test_spatial_trainer_matches_jax_mesh_float64")
SPATIAL_TESTS = ("test_halo_rows_match_slicing", "test_row_window_conv_matches_unsharded",
                 "test_spatial_executor_matches_folded_apply", "test_sharded_detect_matches_jax",
                 "test_spatial_trainer_matches_jax_float64",
                 "test_spatial_trainer_matches_jax_mesh_float64",
                 "test_spatial_dryrun_four_processes", "test_mesh_places_and_halo_collectives")
SPATIAL_FRAMES = 4  # golden frames through the sharded detect pipeline
NICE = 19
_STARTED = {}  # name -> what its fixture yields


def _selected(request, names) -> bool:
    return any(item.name.split("[")[0] in names for item in request.session.items)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="session")
def dryrun_two_ranks(request):
    """The two-rank dry run's process (None where its test is not selected)."""
    if not _selected(request, (DRYRUN_TEST,)):
        yield None
        return
    if "dryrun" not in _STARTED:
        _STARTED["dryrun"] = subprocess.Popen(
            [sys.executable, "-m", "yolofastest_torch.parallel.dryrun", "--device", "cpu"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            preexec_fn=lambda: os.nice(NICE))
    proc = _STARTED["dryrun"]
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="session")
def two_rank_processes(request, tmp_path_factory):
    """The two ranks of ``trajectory_rank`` (``(procs, [output path of each
    rank])``, or None where none of their readers is selected): float64 over
    test_torch_train's four steps split 2 + 2 images, save and resume, then
    the (1, 2) spatial mesh."""
    if not _selected(request, TWO_RANKS_TESTS):
        yield None
        return
    if "two_ranks" not in _STARTED:
        from tests._torch_ranks import trajectory_rank

        td, args = _train_inputs(tmp_path_factory, "two_ranks")
        outs = [str(td / f"rank{r}.pt") for r in range(2)]
        _STARTED["two_ranks"] = _spawn(trajectory_rank, 2, (*args, str(td / "ckpt")), outs)
    yield from _join_at_end(_STARTED["two_ranks"])


@pytest.fixture(scope="session")
def spatial_processes(request, tmp_path_factory):
    """The four spatial ranks (``(procs, [output path of each rank])``, or
    None where no spatial test is selected); each writes its record with
    ``torch.save``."""
    if not _selected(request, SPATIAL_TESTS):
        yield None
        return
    if "spatial" not in _STARTED:
        from tests._torch_ranks import spatial_rank

        td, (cfg_json, batches) = _train_inputs(tmp_path_factory, "spatial")
        args = {"dir": str(td), "dryrun_port": free_port(), "frames": SPATIAL_FRAMES,
                "cfg_train": cfg_json, "batches": batches}
        outs = [str(td / f"rank{r}.pt") for r in range(4)]
        _STARTED["spatial"] = _spawn(spatial_rank, 4, (args,), outs)
    yield from _join_at_end(_STARTED["spatial"])


def _train_inputs(tmp_path_factory, name):
    """A temporary directory, test_torch_train's config (JSON) and its four
    steps (A, a non-finite batch, B, C) written there for the ranks."""
    from tests._torch_ranks import save_batches
    from tests.test_torch_train import _cfg, _sequence, train_inputs

    td = tmp_path_factory.mktemp(name)
    path = save_batches(str(td / "batches.npz"), _sequence(train_inputs()["batches"]))
    return td, (_cfg().to_json(), path)


def _niced(target, *args):
    os.nice(NICE)
    target(*args)


def _spawn(target, world, args, outs):
    """Start ``world`` ranks of ``target(rank, world, port, *args, out)``."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_niced, args=(target, r, world, port, *args, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def _join_at_end(started):
    procs, _ = started
    yield started
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
