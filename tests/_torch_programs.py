"""The port's exports for the tests, made in a process of their own.

:func:`run_exports` runs the ``export`` commands that
``tests/test_torch_export.py`` and ``tests/test_torch_quant_tools.py`` read,
then the programs of ``tests/test_torch_programs.py``: it writes the ``.pt2``
programs (the folded forward of both architectures, the detect pipeline, the
int8 forward) and the generic ONNX files (the trainable model in eval mode and the folded forward through
the chain operator) at 64x96; loads each program back (``load_exported``)
and runs it on the test inputs beside the port's in-process functions
(``outputs.npz``, and the operator nodes of each loaded graph in
``targets.json``); and runs :data:`CONSUMER` on ``detect.pt2``, a fresh
process that imports only ``yolofastest_torch.kernels`` (``consumer.npz``,
``consumer.json``).  ``tests/_background.py`` starts it with the first port
module, so that its ~40 s run beside other modules' tests; the test modules
hold what it wrote against the JAX package.  It imports no JAX.  The inputs
of the programs (the golden frames resized to 64x96, the configs) are made
here for both packages; the programs' calibration runs with one torch
thread, as the JAX workers' calls of the port's calibration do.
"""

import dataclasses
import json
import os
import subprocess
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
CONF_THRE = 0.1  # below the presets' 0.5, so that the small frames keep detections
FORWARD_BATCH, INT8_BATCH = 2, 4
ZOOS = {"fastest": "256x320", "lite": "lite_256x320"}

CONSUMER = """
import json, sys
import numpy as np
import torch
import yolofastest_torch.kernels  # the runtime of the port's programs: its operators

program, frames_path, out = sys.argv[1:]
torch.backends.cudnn.allow_tf32 = False
with torch.no_grad():
    det = torch.export.load(program).module()(torch.from_numpy(np.load(frames_path)))
np.savez(out + ".npz", **{k: v.numpy() for k, v in det.items()})
prefixes = ("yolofastest_torch.models", "yolofastest_torch.inference", "yolofastest_torch.export",
            "yolofastest_torch.quant", "yolofastest_torch.train", "yolofastest_tpu", "flax")
json.dump({"model_modules": sorted(m for m in sys.modules if m.startswith(prefixes))},
          open(out + ".json", "w"))
"""


def frames() -> np.ndarray:
    """The 20 golden frames (gray uint8) resized to 64x96 with cv2."""
    import cv2

    fx = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_256x320.npz"))
    return np.stack([cv2.resize(f, HW[::-1]) for f in fx["pre_imgs"]])


def net_input(n: int) -> np.ndarray:
    """The first ``n`` frames as (n, 64, 96, 1) net input."""
    return (frames()[:n].astype(np.float32)[..., None] - 128.0) / 255.0


def config_json(arch: str = "fastest") -> str:
    """The preset of ``arch`` at 64x96 with CONF_THRE, as JSON (both
    packages read it)."""
    from yolofastest_torch.configs import get_config

    cfg = get_config("256x320" if arch == "fastest" else "lite-256x320")
    return dataclasses.replace(cfg, io=dataclasses.replace(
        cfg.io, input_shape=(*HW, 1), conf_thre=CONF_THRE)).to_json()


def run_exports(argvs, root: str, programs: bool, nice: int = 0) -> None:
    """A process of ``tests/_background.py``'s ``port_exports``, with one
    torch thread: each ``export`` command of ``argvs`` through the CLI's
    ``main`` (``root/<name>.json``: its exit code, what it printed, the
    traceback of an exception), then, where ``programs``, every program
    into ``root/programs``, at ``nice``; ``root/error.txt`` holds the
    traceback of a failure."""
    import contextlib
    import io

    import torch

    os.nice(nice)

    from yolofastest_torch.cli import main

    torch.set_num_threads(1)  # the calibration's sums as the tests' references make them
    try:
        for name, argv in argvs.items():
            printed, error = io.StringIO(), ""
            with contextlib.redirect_stdout(printed):
                try:
                    rc = main(argv)
                except Exception:  # noqa: BLE001 (reported to the reading test)
                    rc, error = 1, traceback.format_exc()
            tmp = os.path.join(root, f"{name}.json.tmp")
            with open(tmp, "w") as f:
                json.dump({"rc": rc, "out": printed.getvalue(), "error": error}, f)
            os.replace(tmp, os.path.join(root, f"{name}.json"))
        if programs:
            os.makedirs(os.path.join(root, "programs"))
            _export_programs(os.path.join(root, "programs"))
    except BaseException:
        with open(os.path.join(root, "error.txt"), "a") as f:
            f.write(traceback.format_exc())
        raise


def _export_programs(out: str) -> None:
    import torch

    from yolofastest_torch.configs import Config
    from yolofastest_torch.export import (export_detect_pipeline, export_folded_forward,
                                          export_int8_forward, export_torch_onnx,
                                          load_exported, save_exported)
    from yolofastest_torch.models import (build_model, fold_batchnorm, folded_apply,
                                          folded_apply_lite, load_variables,
                                          torch_params_from_folded, zoo_path)

    path = {name: os.path.join(out, name) for name in (
        "forward_fastest.pt2", "forward_lite.pt2", "detect.pt2", "forward_int8.pt2",
        "model.onnx", "folded.onnx", "frames.npy", "consumer")}
    np.save(path["frames.npy"], frames())
    cfgs = {arch: Config.from_json(config_json(arch)) for arch in ZOOS}
    variables = {arch: load_variables(zoo_path(zoo)) for arch, zoo in ZOOS.items()}
    v = variables["fastest"]
    save_exported(export_detect_pipeline(v, cfgs["fastest"], batch=len(frames()), device="cpu"),
                  path["detect.pt2"])
    consumer = subprocess.Popen([sys.executable, "-c", CONSUMER, path["detect.pt2"],
                                 path["frames.npy"], path["consumer"]], cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for arch in ZOOS:
        save_exported(export_folded_forward(fold_batchnorm(variables[arch]), cfgs[arch],
                                            batch=FORWARD_BATCH, arch=arch, device="cpu"),
                      path[f"forward_{arch}.pt2"])
    save_exported(export_int8_forward(v, cfgs["fastest"], net_input(INT8_BATCH),
                                      batch=INT8_BATCH, device="cpu"), path["forward_int8.pt2"])
    x = torch.from_numpy(net_input(FORWARD_BATCH))
    export_torch_onnx(build_model(3, 3, variables=v).eval(), (x,), path["model.onnx"])
    params = torch_params_from_folded(fold_batchnorm(v), "cpu")
    export_torch_onnx(lambda x: folded_apply(params, x), (x,), path["folded.onnx"])

    # the programs loaded back and run, beside the port's own functions
    outputs, targets = {}, {}
    inputs = {"forward_fastest": x, "forward_lite": x,
              "forward_int8": torch.from_numpy(net_input(INT8_BATCH)),
              "detect": torch.from_numpy(frames())}
    for name, arg in inputs.items():
        program = load_exported(path[f"{name}.pt2"])
        targets[name] = [str(n.target) for n in program.exported.graph.nodes
                         if str(n.target).startswith("yolofastest.")]
        got = program.call(arg)
        items = got.items() if isinstance(got, dict) else enumerate(got)
        outputs.update({f"{name}/{k}": t.numpy() for k, t in items})
        if name == "detect":
            try:
                program.call(arg[:-1])
                targets["detect_short_batch"] = "accepted"
            except Exception as e:  # noqa: BLE001 (the guard's exception class is torch's)
                targets["detect_short_batch"] = type(e).__name__
    for arch, apply in (("fastest", folded_apply), ("lite", folded_apply_lite)):
        heads = apply(torch_params_from_folded(fold_batchnorm(variables[arch]), "cpu"), x)
        heads = heads if isinstance(heads, tuple) else (heads,)
        outputs.update({f"folded_{arch}/{j}": h.numpy() for j, h in enumerate(heads)})
    np.savez(os.path.join(out, "outputs.npz"), **outputs)
    stdout, stderr = consumer.communicate(timeout=600)
    targets["consumer_rc"] = consumer.returncode
    targets["consumer_stderr"] = stderr[-2000:]
    with open(os.path.join(out, "targets.json"), "w") as f:
        json.dump(targets, f)
