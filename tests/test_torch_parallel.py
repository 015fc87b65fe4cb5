"""The port's data parallelism (``yolofastest_torch/parallel``) and profiling
(``yolofastest_torch/utils/profiling.py``) on the CPU, and the public names
and command lines that the port shares with the JAX package.

JAX's names and parser are read without importing JAX: the names from the
JAX package's source (``ast``), the parser from
``yolofastest_tpu.cli.parser``, which imports no JAX.  The two-rank training
run that equals JAX's float64 trajectory is in ``tests/test_torch_train.py``
(``test_two_ranks_match_jax_float64``); here the two-rank dry run
(``python -m yolofastest_torch.parallel.dryrun --device cpu``) starts with the
module's first test and is read by the last.
"""

import ast
import glob
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from yolofastest_torch.models import zoo_path
from yolofastest_torch.parallel import (Mesh, batch_sharding, global_batch_size, host_to_global,
                                        init_distributed, make_mesh, replicate, shard_batch)
from yolofastest_torch.parallel.distributed import ENV_VARS, default_backend
from yolofastest_torch.utils.profiling import SectionTimer, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = os.path.join(ROOT, "yolofastest_tpu")
# every subpackage of the JAX package, and its one module of public names
# outside a subpackage's __init__ that the port keeps under the same path
MODULES = sorted(d for d in os.listdir(JAX_PACKAGE)
                 if os.path.isfile(os.path.join(JAX_PACKAGE, d, "__init__.py"))) + [
    "utils.profiling"]
# names the JAX package exports and the port does not: checked differences
# of ROADMAP.md section 3
NOT_PORTED = {
    "utils": {"enable_compile_cache"},  # XLA's persistent compilation cache
    # StableHLO / jaxpr export: they lower JAX programs
    "export": {"export_detect_pipeline", "export_folded_forward", "export_int8_forward",
               "export_jax_onnx", "load_exported", "save_exported", "save_exported_mlir"},
}
DRYRUN_TEST = "test_dryrun_two_ranks_on_cpu"


@pytest.fixture(scope="module", autouse=True)
def _dryrun_process(request):
    """The two-rank dry run, started with the module's first test where its
    test is selected (it runs beside the others)."""
    if not any(item.name == DRYRUN_TEST for item in request.session.items):
        yield None
        return
    proc = subprocess.Popen([sys.executable, "-m", "yolofastest_torch.parallel.dryrun",
                             "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def jax_public_names(module: str):
    """The public names of ``yolofastest_tpu.<module>``, read from its
    source: its ``__all__`` less the private ones, else its top-level public
    functions and classes."""
    path = os.path.join(JAX_PACKAGE, *module.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(path) else path + ".py"
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return {n for n in ast.literal_eval(node.value) if not n.startswith("_")}
    return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


@pytest.mark.parametrize("module", MODULES)
def test_public_names_match_jax(module):
    """Each subpackage (and ``utils.profiling``) exports JAX's public names,
    less the documented differences (``NOT_PORTED``)."""
    want = jax_public_names(module) - NOT_PORTED.get(module, set())
    assert want
    port = importlib.import_module(f"yolofastest_torch.{module}")
    exported = set(getattr(port, "__all__", ()))
    if not exported:  # a module without __all__: its public names
        exported = {n for n in vars(port) if not n.startswith("_")}
    assert not want - exported, sorted(want - exported)
    assert all(hasattr(port, n) for n in want)


def _parsers():
    from yolofastest_tpu.cli.parser import build_parser as jax_parser
    from yolofastest_torch.cli import build_parser

    return {"jax": jax_parser(), "port": build_parser()}


def test_serve_has_no_tta_like_jax(capsys):
    """`serve --tta` exits 2 from argparse in both packages; `video` and
    `detect` take `--tta` in both."""
    w = zoo_path("256x320")
    for name, parser in _parsers().items():
        with pytest.raises(SystemExit) as e:
            parser.parse_args(["serve", "--weights", w, "--tta"])
        assert e.value.code == 2, name
        assert "unrecognized arguments: --tta" in capsys.readouterr().err, name
        assert parser.parse_args(["video", "--weights", w, "--video", "v.avi", "--out", "o",
                                  "--tta"]).tta, name
        assert parser.parse_args(["detect", "--weights", w, "--data", "d", "--out", "o",
                                  "--tta"]).tta, name


@pytest.mark.parametrize("command", ["info", "prune"])
def test_unknown_config_raises_jax_key_error(command, tmp_path):
    """`info --config` and `prune --config` take any name in both parsers;
    an unknown one raises the KeyError of JAX's `get_config`, text and all
    (the JAX commands resolve it with `_get_config` before anything else)."""
    from yolofastest_torch.cli import main
    from yolofastest_tpu.cli._common import _get_config

    argv = [command, "--config", "no-such-preset"]
    if command == "prune":
        argv += ["--weights", zoo_path("256x320"), "--ratio", "0.4", "--out",
                 str(tmp_path / "p.npz")]
    parsers = _parsers()
    assert parsers["port"].parse_args(argv).config == "no-such-preset"
    with pytest.raises(KeyError) as want:
        _get_config(parsers["jax"].parse_args(argv))
    with pytest.raises(KeyError) as got:
        main(argv)
    assert str(got.value) == str(want.value) and "no-such-preset" in str(want.value)
    assert not os.listdir(tmp_path)


def test_init_distributed_rules(monkeypatch):
    """JAX's rules: an explicitly single process is a no-op; a bare call
    with no torchrun variable set is a no-op; a partial environment or
    partial arguments raise, joining nothing."""
    for v in ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    init_distributed(num_processes=1)
    init_distributed()
    assert not dist.is_initialized()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_PORT, RANK not set"):
        init_distributed()
    with pytest.raises(ValueError, match="together"):
        init_distributed("localhost:29500", num_processes=2)
    assert not dist.is_initialized()
    assert default_backend() == ("nccl" if torch.cuda.is_available() else "gloo")
    assert global_batch_size(8) == 8


def test_mesh_one_rank_and_shard_batch(monkeypatch):
    """One process: a one-rank data mesh on the named device, which reduces
    over nothing; shard_batch gives the whole batch (a fake two-rank mesh:
    rank 0's half, and an odd batch refused); the spatial axis and a data
    axis larger than the group are refused; without a card the default
    device raises."""
    from yolofastest_torch.parallel.worker import tiny_config
    from yolofastest_torch.train import Trainer

    mesh = make_mesh(devices=["cpu"])
    assert (mesh.size, mesh.rank, mesh.axis_names) == (1, 0, ("data",))
    assert mesh.reduce_group is None and mesh.device == torch.device("cpu")
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    y = np.arange(8).reshape(4, 2)
    a, b = shard_batch(mesh, x, y)
    assert torch.equal(a, torch.from_numpy(x)) and torch.equal(b, torch.from_numpy(y))
    assert shard_batch(mesh, x).shape == (4, 6)
    assert replicate(mesh).spec == () and batch_sharding(mesh, spatial=True).spec == ("data",)
    assert torch.equal(host_to_global(replicate(mesh), x), torch.from_numpy(x))
    two = Mesh(group=None, ranks=(0, 1), device=torch.device("cpu"))
    assert torch.equal(shard_batch(two, x), torch.from_numpy(x[:2]))
    with pytest.raises(ValueError, match="a batch of 3 does not divide over 2 ranks"):
        shard_batch(two, x[:3])
    with pytest.raises(NotImplementedError, match="halo exchange"):
        make_mesh(n_spatial=2, devices=["cpu"])
    with pytest.raises(ValueError, match="1 rank"):
        make_mesh(n_data=2, devices=["cpu"])
    cfg = tiny_config()
    with pytest.raises(NotImplementedError, match="halo exchange"):
        Trainer(cfg, shard_spatial=True, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        Trainer(cfg, mesh=mesh, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


def test_section_timer_reports():
    """tests/test_aux.py's checks of the JAX SectionTimer, on the port's."""
    t = SectionTimer()
    for _ in range(3):
        with t.section("work"):
            time.sleep(0.002)
    rep = t.report()
    assert rep["work"]["count"] == 3
    assert rep["work"]["avg_ms"] >= 1.0


def test_trace_writes_chrome_json_with_step_spans(tmp_path):
    """`trace` around a tiny train step on the CPU writes one Chrome trace
    (`*.pt.trace.json`) whose events include the step's spans."""
    from yolofastest_torch.parallel.worker import local_batch, tiny_config
    from yolofastest_torch.train import Trainer

    cfg = tiny_config()
    trainer = Trainer(cfg, batch_per_epoch=1, seed=0, device="cpu")
    with trace(str(tmp_path / "trace")) as prof:
        trainer.step(*local_batch(cfg, 0))
    assert prof is not None
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {"train_step/forward", "train_step/loss", "train_step/optimizer"} <= names


def test_dryrun_two_ranks_on_cpu(_dryrun_process):
    """The port's multi-process dry run, two gloo ranks at 64x96 in fp32:
    two steps on their own batches with one state on both ranks, save from
    the live group and resume bit for bit (MP_OK and MP_RESUME_OK on each
    rank)."""
    out, err = _dryrun_process.communicate(timeout=300)
    assert _dryrun_process.returncode == 0, err[-3000:]
    for r in range(2):
        assert f"MP_OK rank={r} backend=gloo device=cpu" in out, out
        assert f"MP_RESUME_OK rank={r}" in out, out
