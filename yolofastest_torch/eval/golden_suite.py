"""The deployment matrix: every backend at both resolutions over the golden
frames, with golden recall and time per image.

The port of ``tools/run_golden_suite.py`` (the script
``tools/torch_golden_suite.py`` is its shell).  :func:`run_resolution`
makes JAX's rows under JAX's names, ``jax-`` read as ``torch-``:

* ``torch-fp32``, ``torch-bf16``: the trainable model in eval mode
  (``Detector(fold_bn=False)``, JAX's ``model.apply``);
* ``int8``, ``int8-fused``: the shipped int8 artifact (its ``keep_fp``
  too), else amax PTQ over the first 8 frames;
* ``pruned040-bf16``: the pruned checkpoint's folded walk in bf16 (the
  chain kernel); ``pruned040-int8``, ``pruned040-int8-fused``: its hybrid
  int8 artifact;
* ``native-cpp``, ``native-cpp-int8``, ``pruned040-native-int8``: the C++
  engine of ``cpp/`` on the host CPU, image by image.

The device rows run one batch of all frames and are timed best-of-3 with
the detections fetched; the native rows are timed best-of-3 passes over the
frames.  :func:`methodology` names the card, the host CPU and its load.
"""

from __future__ import annotations

import datetime
import os
import platform
import subprocess
import time
from typing import Any, Callable, Dict, Optional

import torch

from yolofastest_torch.configs import get_config
from yolofastest_torch.eval.golden import (ROOT, fetch, golden_inputs, native_rows,
                                           recall_rows, recall_vs_golden)
from yolofastest_torch.utils.device import resolve_device

WEIGHTS = os.path.join(ROOT, "weights")


def _best_of(fn: Callable[[], Any]):
    """``(last result, best seconds)`` of three timed calls after a warm one."""
    out, best = fn(), float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def _row(m: int, n: int, **extra) -> Dict[str, Any]:
    return {"recall": f"{m}/{n}", "detection_rate": round(m / n, 4), **extra}


def run_resolution(res: str, out_dir: str, device=None, frames: Optional[int] = None,
                   native: bool = True, log: Callable[[str], None] = print) -> Dict[str, Dict]:
    """Every row of the matrix at ``res`` on the first ``frames`` golden
    frames (all 20 when None), the device rows on ``device`` (the card
    unless the caller asks for the CPU); the native rows where ``native``
    (the library found or built: a host without it makes the device rows),
    their ``.yfb`` files written to ``out_dir``."""
    from yolofastest_torch.export import save_native_weights
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.models import fold_batchnorm, load_variables, zoo_path
    from yolofastest_torch.native import NativeEngine
    from yolofastest_torch.quant import calibrate, load_int8_zoo, mixed_native_tree

    dev = resolve_device(device)
    cfg = get_config(res)
    imgs, golden = golden_inputs(res, frames)
    variables = load_variables(zoo_path(res))
    folded = fold_batchnorm(variables)

    zoo8 = load_int8_zoo(res)
    if zoo8 is not None:
        int8_folded, scales, keep_fp8 = zoo8
        int8_src = f"weights/yolofastest_int8_{res}.npz"
    else:
        int8_folded, keep_fp8 = folded, ()
        scales = calibrate(folded, [imgs[:8]], device=dev)
        int8_src = "on-the-fly amax-8 PTQ"

    def int8_detector(backend, art):
        if art is not None:
            return Detector(cfg, None, backend=backend, int8_artifact=art, device=dev)
        return Detector(cfg, variables, backend=backend, calibration=[imgs[:8]], device=dev)

    art8 = os.path.join(WEIGHTS, f"yolofastest_int8_{res}.npz") if zoo8 is not None else None
    detectors = {
        "torch-fp32": Detector(cfg, variables, fold_bn=False, device=dev),
        "torch-bf16": Detector(cfg, variables, torch.bfloat16, fold_bn=False, device=dev),
        "int8": int8_detector("int8", art8),
        "int8-fused": int8_detector("int8-fused", art8),
    }
    pruned_path = os.path.join(WEIGHTS, f"yolofastest_pruned040_{res}.npz")
    pruned_art = os.path.join(WEIGHTS, f"yolofastest_int8_pruned040_{res}.npz")
    zoo8p = load_int8_zoo(pruned_art)
    if os.path.exists(pruned_path):
        detectors["pruned040-bf16"] = Detector(cfg, load_variables(pruned_path), torch.bfloat16,
                                               device=dev)
        if zoo8p is not None:
            for backend in ("int8", "int8-fused"):
                detectors[f"pruned040-{backend}"] = Detector(cfg, None, backend=backend,
                                                             int8_artifact=pruned_art, device=dev)

    results = {}
    x = torch.from_numpy(imgs).to(dev)
    for name, det in detectors.items():
        out, best = _best_of(lambda: fetch(det.run(x)))
        m, n = recall_vs_golden(out, golden)
        dt = best * 1e3 / len(imgs)
        results[name] = _row(m, n, ms_per_img_batched=round(dt, 3))
        log(f"[{res}] {name}: recall {m}/{n}, {dt:.2f} ms/img (batch-{len(imgs)})")

    def native_row(name, tree, yfb, act_scales=None, **extra):
        save_native_weights(tree, os.path.join(out_dir, yfb), act_scales=act_scales,
                            io_config=cfg.io)
        eng = NativeEngine(os.path.join(out_dir, yfb), cfg)
        rows, best = _best_of(lambda: native_rows(eng, imgs))
        m, n = recall_rows(rows, golden)
        ms = best * 1e3 / len(imgs)
        if act_scales is not None:
            extra = {"int8_layers": eng.int8_layers, **extra}
        results[name] = _row(m, n, ms_per_img=round(ms, 2), **extra)
        log(f"[{res}] {name}: recall {m}/{n}, {ms:.2f} ms/img (single-image)")

    if not native:
        return results
    native_row("native-cpp", folded, f"model_{res}.yfb")
    native_scales = scales if zoo8 is not None else calibrate(folded, [imgs], device=dev)
    tree, nscales = mixed_native_tree(int8_folded, native_scales, keep_fp8)
    native_row("native-cpp-int8", tree, f"model_{res}_int8.yfb", act_scales=nscales,
               int8_source=int8_src)
    if zoo8p is not None:
        folded_8p, scales_8p, keep_8p = zoo8p
        tree, nscales = mixed_native_tree(folded_8p, scales_8p, keep_8p)
        native_row("pruned040-native-int8", tree, f"model_{res}_pruned_int8.yfb",
                   act_scales=nscales, keep_fp=list(keep_8p))
    return results


def card_name() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line, or None without the tool."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def host_cpu() -> str:
    """The host CPU: its model name (``lscpu``, else /proc/cpuinfo; a virtual
    machine may say "unknown"), vendor, family and model numbers, and count."""
    info = {}
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except OSError:
        out = ""
    names = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
             if ln.strip().startswith("Model name")]
    name = next((n for n in names + [info.get("model name", "")]
                 if n and n.lower() != "unknown"), "unknown")
    return (f"{name} ({info.get('vendor_id', '?')} family {info.get('cpu family', '?')} "
            f"model {info.get('model', '?')}, {os.cpu_count()} CPUs)")


def methodology(device=None) -> Dict[str, Any]:
    """How the numbers were taken: the device of the device rows (the card
    as ``nvidia-smi`` names it, with its power limit), the host CPU that
    runs the native rows, and its load when the run starts."""
    dev = resolve_device(device)
    try:
        load = os.getloadavg()
    except OSError:
        load = None
    return {
        "timestamp_utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "host": platform.platform(),
        "host_cpu": host_cpu(),
        "loadavg_at_start": load,
        "device": card_name() if dev.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "timing": "best-of-3 passes after a warm one, perf_counter around the call and the "
                  "fetch of its detections to the host; native engine timed single-image "
                  "sequential on the host CPU (OpenMP threads = host cpus)",
        "detection_rate": "fraction of the committed reference-PC golden detections "
                          "reproduced at IOU>0.5 with same class",
    }


def run_suite(out_dir: str, device=None, log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Both resolutions; ``summary.json`` written to ``out_dir``."""
    import json

    os.makedirs(out_dir, exist_ok=True)
    table = {"methodology": methodology(device)}
    for res in ("256x320", "512x640"):
        table[res] = run_resolution(res, out_dir, device, log=log)
    path = os.path.join(out_dir, "summary.json")
    with open(path, "w") as f:
        json.dump(table, f, indent=2)
    log(f"wrote {path}")
    return table
