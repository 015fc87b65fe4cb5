"""The StableHLO text programs for ``tests/test_torch_mlir.py``, made in a
process of their own.

:func:`run` builds ``yf_shlo`` (``cpp/runner/shlo_runner.cpp``, with the
host compiler, ~7 s), writes the port's text programs with
``save_exported_mlir`` and runs each through ``yf_shlo``:

* ``forward_<arch>.mlir``: the folded forward of both architectures at
  64x96, batch 2, with weights drawn from a numpy seed
  (:func:`random_folded`), on the golden frames resized to 64x96;
* ``nms_<pixel_offset>.mlir``: ``batched_nms`` alone on the dense
  hand-made candidates of :func:`nms_candidates`, packed into one
  ``(B, K, 8)`` argument (``yf_shlo`` runs a ``@main`` of one argument);
* ``sort.mlir``: a stable descending ``torch.sort`` of :func:`sort_input`
  (three values, many ties);
* the programs of :data:`REFUSED`, whose lowering must raise: the error's
  type and message go to ``refused.json`` (and no file may be written).

It writes ``outputs.npz`` (``<program>/<i>``: ``yf_shlo``'s i-th result)
and ``texts.json`` (each program's operator counts).
``tests/_background.py`` starts it with the first port module; it imports
no JAX.  The seeded weights and candidates are made here for both packages.
"""

import json
import os
import re
import threading
import traceback
from collections import Counter

import numpy as np

from tests._torch_programs import FORWARD_BATCH, ZOOS, config_json, net_input

NMS_IOU_THRE = 0.5
NMS_MAX_DET = 16
PIXEL_OFFSETS = (0, 1)
# programs with an operator yf_shlo cannot run, and the operator's name
REFUSED = {"cumsum": "aten.cumsum", "strided_slice": "aten.slice.Tensor"}


def random_folded(arch: str, seed: int = 0):
    """A folded tree of ``arch`` (the zoo's layer names and shapes) with
    weights drawn from a numpy seed: kernels ~ N(0, 1/fan_in), biases ~
    N(0, 0.1^2).  Both packages take the tree as it is."""
    from yolofastest_torch.models import fold_batchnorm, load_variables, zoo_path

    rng = np.random.default_rng(seed)
    out = {}
    for name, layer in sorted(fold_batchnorm(load_variables(zoo_path(ZOOS[arch]))).items()):
        k = layer["kernel"]
        fan_in = int(np.prod(k.shape[:-1]))
        out[name] = {"kernel": (rng.standard_normal(k.shape) / np.sqrt(fan_in)).astype(np.float32),
                     "bias": (rng.standard_normal(layer["bias"].shape) * 0.1).astype(np.float32)}
    return out


def nms_candidates(pixel_offset: int, seed: int = 0):
    """Dense candidates for ``batched_nms``, conf-descending per image:
    (boxes (B, K, 4), conf, cls_score, cls_idx int32, valid bool).  Integer
    corners (decode's are rounded) in clusters of one class, so that many
    pairs overlap above and below the threshold; confidences drawn from 12
    values (ties); a few invalid rows among the valid ones and a tail of
    invalid rows; more survivors than ``NMS_MAX_DET``; and in every image a
    pair whose IOU is exactly the threshold (not suppressed: the test is
    strict), an exact duplicate (suppressed) and the same box in another
    class (kept)."""
    rng = np.random.default_rng(seed + pixel_offset)
    b, k = 3, 96
    centres = rng.integers(20, 300, (b, k // 4, 2))
    centres = np.repeat(centres, 4, axis=1) + rng.integers(-6, 7, (b, k, 2))
    half = rng.integers(4, 24, (b, k, 2))
    boxes = np.concatenate([centres - half, centres + half], -1).astype(np.float32)
    cls_idx = np.repeat(rng.integers(0, 3, (b, k // 4)), 4, axis=1).astype(np.int32)
    # the crafted rows at the front: IOU exactly 0.5 (10x10 against 10x5
    # sharing an edge), a duplicate of row 0, the same box in another class
    side = 10 - pixel_offset
    crafted = np.array([[0, 0, side, side], [0, 0, side, 5 - pixel_offset],
                        [0, 0, side, side], [0, 0, side, side]], np.float32) + 400
    boxes[:, :4] = crafted
    cls_idx[:, :4] = [[1, 1, 1, 2]] * b
    conf = np.sort(rng.choice(np.linspace(0.3, 0.95, 12), (b, k)).astype(np.float32), 1)[:, ::-1]
    conf[:, :4] = conf[:, 0:1]  # ties among the crafted rows
    cls_score = rng.uniform(0.2, 1.0, (b, k)).astype(np.float32)
    valid = np.arange(k)[None] < np.array([[80], [88], [60]])
    valid[:, [7, 30, 31, 55]] = False
    return boxes, np.ascontiguousarray(conf), cls_score, cls_idx, valid


def pack_candidates(cand) -> np.ndarray:
    """One (B, K, 8) float32 array: boxes, conf, cls_score, cls_idx, valid."""
    boxes, conf, cls_score, cls_idx, valid = cand
    return np.concatenate([boxes, conf[..., None], cls_score[..., None],
                           cls_idx[..., None].astype(np.float32),
                           valid[..., None].astype(np.float32)], -1)


def nms_program(pixel_offset: int):
    """``batched_nms`` on a packed (B, K, 8) argument, as a ``Program``."""
    import torch

    from yolofastest_torch.export.pt2 import Program, trace
    from yolofastest_torch.ops import batched_nms

    def fn(packed):
        return batched_nms(packed[..., 0:4], packed[..., 4], packed[..., 5],
                           packed[..., 6].to(torch.int32), packed[..., 7] > 0.5,
                           iou_thre=NMS_IOU_THRE, max_det=NMS_MAX_DET,
                           pixel_offset=float(pixel_offset))

    arg = torch.from_numpy(pack_candidates(nms_candidates(pixel_offset)))
    return Program(trace(fn, (arg,))), arg.numpy()


def sort_input() -> np.ndarray:
    return np.random.default_rng(3).choice([-1.0, 0.25, 0.5], (3, 200)).astype(np.float32)


def sort_program():
    """``torch.sort(dim=1, descending=True, stable=True)`` as a ``Program``."""
    import torch

    from yolofastest_torch.export.pt2 import Program, trace

    x = sort_input()
    return Program(trace(lambda t: torch.sort(t, dim=1, descending=True, stable=True),
                         (torch.from_numpy(x),))), x


def refused_program(name: str):
    """A program of :data:`REFUSED` on a (2, 6) argument."""
    import torch

    from yolofastest_torch.export.pt2 import Program, trace

    fn = {"cumsum": lambda t: torch.cumsum(t, 1), "strided_slice": lambda t: t[:, ::2] * 2.0}
    return Program(trace(fn[name], (torch.ones(2, 6),)))


def op_counts(text: str):
    return dict(Counter(re.findall(r"(?:stablehlo|\"stablehlo)\.([a-z_]+)", text)))


def run(root: str, nice: int = 10) -> None:
    """The process: ``yf_shlo`` built, the programs written and run;
    ``root/error.txt`` holds the traceback of a failure."""
    import torch

    os.nice(nice)
    torch.set_num_threads(1)
    try:
        from yolofastest_torch.configs import Config
        from yolofastest_torch.export import export_folded_forward, save_exported_mlir
        from yolofastest_torch.native import find_shlo_runner, run_shlo

        built = {}  # the compiler runs beside the traces and lowerings below

        def build():
            try:
                built["runner"] = find_shlo_runner()[0]
            except Exception as e:  # noqa: BLE001 (raised after the join)
                built["error"] = e

        build_thread = threading.Thread(target=build)
        build_thread.start()
        outputs, texts, refused = {}, {}, {}
        for name in REFUSED:
            path = os.path.join(root, f"{name}.mlir")
            try:
                save_exported_mlir(refused_program(name), path)
            except Exception as e:  # noqa: BLE001 (the test reads what was raised)
                refused[name] = {"type": type(e).__name__, "message": str(e)}
            refused[name] = {**refused.get(name, {}), "written": os.path.exists(path)}
        programs = {}
        x = net_input(FORWARD_BATCH)
        for arch in ZOOS:
            cfg = Config.from_json(config_json(arch))
            programs[f"forward_{arch}"] = (export_folded_forward(
                random_folded(arch), cfg, batch=FORWARD_BATCH, arch=arch, device="cpu"), x)
        for po in PIXEL_OFFSETS:
            programs[f"nms_{po}"] = nms_program(po)
        programs["sort"] = sort_program()
        for name, (program, _) in programs.items():
            path = os.path.join(root, f"{name}.mlir")
            save_exported_mlir(program, path)
            with open(path) as f:
                texts[name] = op_counts(f.read())
        build_thread.join()
        if "error" in built:
            raise built["error"]
        for name, (_, arg) in programs.items():
            outs, _ = run_shlo(os.path.join(root, f"{name}.mlir"), arg, runner=built["runner"])
            outputs.update({f"{name}/{i}": o for i, o in enumerate(outs)})
        np.savez(os.path.join(root, "outputs.npz"), **outputs)
        with open(os.path.join(root, "texts.json"), "w") as f:
            json.dump({"texts": texts, "refused": refused}, f)
    except BaseException:
        with open(os.path.join(root, "error.txt"), "a") as f:
            f.write(traceback.format_exc())
        raise
