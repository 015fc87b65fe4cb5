"""Processes that the port's tests start early and read late.

The multi-process checks spend most of their time starting interpreters and
running ranks that need nothing from the test process.  Session fixtures
start them, where a test that reads them is selected, the first time a test
module asks for them: the first port module (``tests/test_torch_config.py``)
asks for both, so the ranks run while the pool of JAX references
(``tests/_jax_refs.py``) is still starting, and are done when their readers
come.  Alone, a reader's module starts them itself.  The ranks run at
``nice 19``, below the test process and the reference workers (``nice
10``): they use the cores those leave idle, and do not hold up the
references that the modules in between read.  The exports' processes run
at the test process's priority, with one torch thread each: at ``nice 19``
they waited for the references' compiles and held up their readers by
20-40 s.
Each module that
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
  ``spatial_rank``, read by ``tests/test_torch_spatial.py``;
* :func:`port_exports`: three processes that run four ``export`` commands
  (each writes the ``.pt2`` programs and their StableHLO text, ~10-20 s;
  ``fastest`` then ``qat`` in one, ``missing`` and ``calib`` one each, so
  that ``tests/test_torch_export.py`` waits for none of them), read by
  ``tests/test_torch_export.py`` and ``tests/test_torch_quant_tools.py``,
  and one that runs ``tests/_torch_programs.py``'s exporter of the ``.pt2``
  programs and generic ONNX files, read by ``tests/test_torch_programs.py``;
  the ``fastest`` command's ``forward.mlir`` and ``detect.mlir`` are read by
  ``tests/test_torch_mlir.py`` too;
* :func:`recipe_outputs`: a process of ``tests/_torch_recipes.py`` ``run``
  (the deployment matrix on two frames, the 512x640 int8 recipe and the
  lite seed, ~10 s at ``nice 10``) and one of ``tests/_jax_recipes.py``
  (``tools/make_lite_seed.py --out``, ~27 s of CPU at ``nice 19``), read
  by ``tests/test_torch_recipes.py``;
* :func:`finetune_sets`: a process of ``tests/_finetune_sets.py`` ``run``
  (JAX's ``tools/make_finetune_set.py`` and the port's tool on the fixture's
  frames at both sizes, ~1 s at ``nice 10``), read by
  ``tests/test_torch_finetune.py``;
* :func:`mlir_programs`: a process of ``tests/_torch_mlir.py`` ``run``
  (``yf_shlo`` found or built, the seeded forwards, the NMS and sort
  programs written as StableHLO text and run through it, the refused
  lowerings tried, ~20 s), read by ``tests/test_torch_mlir.py``.
"""

import json
import multiprocessing
import os
import socket
import subprocess
import sys
import time

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
EXPORT_COMMANDS_TESTS = ("test_torchscript_heads_match_jax", "test_cli_export_writes_jax_files",
                         "test_cli_export_refusals", "test_cli_export_int8_files",
                         "test_cli_forward_mlir_matches_jax", "test_cli_detect_mlir_matches_jax",
                         "test_texts_are_valid_stablehlo")
MLIR_TESTS = ("test_forward_mlir_matches_port_and_jax", "test_nms_mlir_matches_port_and_jax",
              "test_sort_keeps_ties_in_input_order", "test_lowering_refuses_unsupported_ops",
              "test_texts_are_valid_stablehlo")
PROGRAMS_TESTS = ("test_exported_graphs_record_the_kernels", "test_forward_pt2_matches_jax",
                  "test_detect_pt2_matches_jax", "test_int8_pt2_matches_jax",
                  "test_detect_pt2_in_a_fresh_process", "test_full_model_generic_export_64x96")
RECIPES_TESTS = ("test_matrix_rows_on_two_frames", "test_matrix_row_names_match_committed",
                 "test_build_shipped_512x640_reproduces_committed",
                 "test_build_shipped_512x640_scales_match_jax_calibrate",
                 "test_lite_seed_matches_jax_tool", "test_nothing_written_to_weights")
FINETUNE_TESTS = ("test_set_tool_prints_jax_lines", "test_set_matches_jax_tool",
                  "test_loader_sees_the_fixture_frames")
NICE = 19
# the export commands' processes: each command's readers wait for its group only
COMMAND_GROUPS = {"commands": ("fastest", "qat"), "commands_missing": ("missing",),
                  "commands_calib": ("calib",)}
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


class Exports:
    """Processes of ``tests/_torch_programs.py`` ``run_exports``: three run the
    ``export`` commands (``argvs``, by name, split by :data:`COMMAND_GROUPS`;
    :meth:`command` waits for one), one the programs' exporter
    (:meth:`programs` waits for it).  Each pays the interpreter's start and
    the first trace's set-up once."""

    def __init__(self, root, argvs, programs: bool):
        from tests._torch_programs import run_exports

        self.root, self.argvs = root, argvs
        # the commands' readers come ~40 s into a run, the programs' ~90 s: the
        # programs' exporter runs beside the reference workers
        jobs = {}
        for group, names in COMMAND_GROUPS.items():
            mine = {n: argvs[n] for n in names if n in argvs}
            if mine:
                jobs[group] = (mine, str(root), False, 0)
        if programs:
            jobs["programs"] = ({}, str(root), True, 10)
        ctx = multiprocessing.get_context("spawn")
        self.procs = {name: ctx.Process(target=run_exports, args=args)
                      for name, args in jobs.items()}
        for proc in self.procs.values():
            proc.start()

    def command(self, name, timeout: float = 600):
        """``(returncode, stdout, error)`` of the command ``name``."""
        path = self.root / f"{name}.json"
        deadline = time.monotonic() + timeout
        while not path.exists():
            group = next(g for g, names in COMMAND_GROUPS.items() if name in names)
            assert self.procs[group].is_alive() or path.exists(), self._error()
            assert time.monotonic() < deadline, f"export command {name} still running"
            time.sleep(0.1)
        with open(path) as f:
            done = json.load(f)
        return done["rc"], done["out"], done["error"]

    def programs(self, timeout: float = 600) -> str:
        """The programs' directory, once its exporter has ended."""
        proc = self.procs["programs"]
        proc.join(timeout=timeout)
        assert proc.exitcode == 0, self._error()
        return str(self.root / "programs")

    def _error(self):
        path = self.root / "error.txt"
        return path.read_text() if path.exists() else "no traceback written"


@pytest.fixture(scope="session")
def port_exports(request, tmp_path_factory):
    """:class:`Exports` (or None where none of its readers is selected), with
    the commands where their readers are selected: ``fastest``, the 256x320
    zoo on the CPU; ``missing`` and ``calib``, the lite zoo at a 64x96
    config with a missing --calib-data directory and --qat-steps, and with a
    directory of one image; ``qat``, the same config with two images and
    ``--qat-steps 2``."""
    commands, programs = (_selected(request, EXPORT_COMMANDS_TESTS),
                          _selected(request, PROGRAMS_TESTS))
    if not (commands or programs):
        yield None
        return
    if "exports" not in _STARTED:
        root = tmp_path_factory.mktemp("exports")
        _STARTED["exports"] = Exports(root, _export_argvs(root) if commands else {}, programs)
    exports = _STARTED["exports"]
    yield exports
    for proc in exports.procs.values():
        if proc.is_alive():
            proc.kill()
        proc.join()


@pytest.fixture(scope="session")
def mlir_programs(request, tmp_path_factory):
    """``(process, directory)`` of ``tests/_torch_mlir.py`` ``run`` (or None
    where none of its readers is selected)."""
    if not _selected(request, MLIR_TESTS):
        yield None
        return
    if "mlir" not in _STARTED:
        from tests._torch_mlir import run

        root = tmp_path_factory.mktemp("mlir")
        proc = multiprocessing.get_context("spawn").Process(target=run, args=(str(root),))
        proc.start()
        _STARTED["mlir"] = (proc, root)
    proc, root = _STARTED["mlir"]
    yield proc, root
    if proc.is_alive():
        proc.kill()
    proc.join()


@pytest.fixture(scope="session")
def recipe_outputs(request, tmp_path_factory):
    """:class:`Outputs` of ``tests/_torch_recipes.py`` ``run`` and of the
    JAX lite seed tool (``tests/_jax_recipes.py``), or None where none of
    their readers is selected."""
    if not _selected(request, RECIPES_TESTS):
        yield None
        return
    if "recipes" not in _STARTED:
        from tests._torch_recipes import run

        root = tmp_path_factory.mktemp("recipes")
        proc = multiprocessing.get_context("spawn").Process(target=_niced_by,
                                                            args=(10, run, str(root)))
        proc.start()
        from tests._jax_recipes import XLA_FLAGS

        jax_tool = subprocess.Popen(
            [sys.executable, "-m", "tests._jax_recipes", str(root)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": XLA_FLAGS},
            preexec_fn=lambda: os.nice(NICE))
        _STARTED["recipes"] = Outputs(proc, jax_tool, root)
    outputs = _STARTED["recipes"]
    yield outputs
    if outputs.proc.is_alive():
        outputs.proc.kill()
    outputs.proc.join()
    if outputs.jax_tool.poll() is None:
        outputs.jax_tool.kill()
    outputs.jax_tool.communicate()


@pytest.fixture(scope="session")
def finetune_sets(request, tmp_path_factory):
    """:class:`Outputs` of ``tests/_finetune_sets.py`` ``run`` (both fine-tune
    set tools' sets), or None where none of their readers is selected."""
    if not _selected(request, FINETUNE_TESTS):
        yield None
        return
    if "finetune" not in _STARTED:
        from tests._finetune_sets import run

        root = tmp_path_factory.mktemp("finetune")
        proc = multiprocessing.get_context("spawn").Process(target=_niced_by,
                                                            args=(10, run, str(root)))
        proc.start()
        _STARTED["finetune"] = Outputs(proc, None, root)
    outputs = _STARTED["finetune"]
    yield outputs
    if outputs.proc.is_alive():
        outputs.proc.kill()
    outputs.proc.join()


class Outputs:
    """The port's process, which writes its outputs to ``root`` and
    ``done.json`` last (:meth:`wait` returns ``root`` once it has ended
    well), and the JAX tool's (:meth:`wait_jax`), where there is one."""

    def __init__(self, proc, jax_tool, root):
        self.proc, self.jax_tool, self.root = proc, jax_tool, root

    def wait(self, timeout: float = 600):
        self.proc.join(timeout=timeout)
        done = self.root / "done.json"
        assert done.exists(), f"exit code {self.proc.exitcode}, no done.json"
        result = json.loads(done.read_text())
        assert result["ok"], result.get("error")
        return self.root

    def wait_jax(self, timeout: float = 600):
        """``root`` once the JAX tool has exited 0."""
        out, _ = self.jax_tool.communicate(timeout=timeout)
        assert self.jax_tool.returncode == 0, out
        return self.root


def _niced_by(level, target, *args):
    os.nice(level)
    target(*args)


def _export_argvs(root):
    import dataclasses

    import cv2
    import numpy as np

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.models import zoo_path

    cfg = get_config("lite-256x320")
    tiny = root / "tiny.json"
    tiny.write_text(dataclasses.replace(cfg, io=dataclasses.replace(
        cfg.io, input_shape=(64, 96, 1))).to_json())
    for name, n in (("data", 1), ("data2", 2)):
        (root / name).mkdir()
        rng = np.random.default_rng(0)
        for i in range(n):
            cv2.imwrite(str(root / name / f"im{i}.jpg"), rng.integers(0, 255, (64, 96, 3),
                                                                     np.uint8))
    lite = ["export", "--config-json", str(tiny), "--arch", "lite", "--weights",
            zoo_path("lite_256x320"), "--device", "cpu"]
    return {"fastest": ["export", "--weights", zoo_path("256x320"), "--out",
                        str(root / "fastest"), "--device", "cpu"],
            "missing": lite + ["--out", str(root / "missing_out"), "--calib-data",
                               str(root / "missing"), "--qat-steps", "3"],
            "calib": lite + ["--out", str(root / "calib_out"), "--calib-data", str(root / "data")],
            "qat": lite + ["--out", str(root / "qat_out"), "--calib-data", str(root / "data2"),
                           "--qat-steps", "2"]}


def _train_inputs(tmp_path_factory, name):
    """A temporary directory, test_torch_train's config (JSON) and its four
    steps (A, a non-finite batch, B, C) written there for the ranks."""
    from tests._torch_ranks import save_batches
    from tests.test_torch_train import _cfg, _sequence, train_inputs

    td = tmp_path_factory.mktemp(name)
    path = save_batches(str(td / "batches.npz"), _sequence(train_inputs()["batches"]))
    return td, (_cfg().to_json(), path)


def _spawn(target, world, args, outs):
    """Start ``world`` ranks of ``target(rank, world, port, *args, out)``."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_niced_by, args=(NICE, target, r, world, port, *args, outs[r]))
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
