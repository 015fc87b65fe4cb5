#!/usr/bin/env python3
"""Time the port's NMS stage on the card (H100), for one checkout.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/torch_nms_timing.py [--root DIR] [--label NAME] [--reps 50] [--phases]

It imports ``yolofastest_torch`` from ``--root`` (default: this checkout), so
that two commits can be timed in one call on one card: unpack the other
one's ``yolofastest_torch`` with ``git archive`` into a git-ignored
directory and run the two in turns (A, B, B, A).  The candidates are the
256x320 golden fixture's head logits (``tests/fixtures``, 4 images) through
``decode_heads`` (K=128, decode's strided views), and the same candidates
merged in pairs by the TTA merge (K=256, gathered), tiled to B=1 and B=64.
For each it prints one JSON line with:

* ``kernels``: every kernel one ``batched_nms(packed=True)`` call runs, with
  its launches per call and its mean device time per launch (ms), from a
  ``torch.profiler`` trace of ``reps`` calls;
* ``nms_kernel_device_ms``: the NMS kernel's mean device time per launch
  (the kernel whose name holds ``nms``);
* ``stage_busy_ms``: the union of the card's intervals per call;
* ``stage_queued_ms``: device time per call with no host gaps (events
  around ``reps`` calls queued behind a ~50 ms backlog);
* ``stage_host_ms``: the host's dispatch time per call (host clock, behind
  the backlog: the stage reads nothing back);
* ``stage_events_ms`` and ``kernel_events_ms``: events around ``reps``
  back-to-back calls of the stage and of the NMS wrapper alone, which is
  the host's pace where the card is faster than the host.

With ``--phases`` (a checkout whose ``nms.cu`` has the ``NMS_SKIP_*``
guards) it also builds the kernel with phases compiled out and prints their
device times per launch: ``base``, ``no_scan`` (no greedy scan) and
``io_only`` (no scan, no suppression matrix), which compute wrong outputs
and are for timing only.  The scan costs ``base - no_scan``, the matrix
``no_scan - io_only``.  Besides the golden sets it times a dense one
(random heavily overlapping boxes of two classes, 85% valid, K=128), and
``floor_ms`` is the device time of an empty launch
(``torch.cuda._sleep(1)``).  The first line is the card's name and power
limit.  The timing helpers are ``tools/torch_timing.py``'s, as in
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

from torch_timing import (cuda_ms, device_events, device_busy, dispatch_ms, kernel_device_ms,
                          queued_ms, tile_candidates)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = {"base": [], "no_scan": ["NMS_SKIP_SCAN"], "io_only": ["NMS_SKIP_SCAN", "NMS_SKIP_MATRIX"]}


def candidate_sets(dev):
    """{name: (boxes, conf, cls_score, cls_idx, valid, io)} at B=1 and B=64."""
    import numpy as np
    import torch
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference.detector import _merge_tta
    from yolofastest_torch.ops import decode_heads

    io = get_config("256x320").io
    fx = np.load(os.path.join(REPO, "tests", "fixtures", "golden_256x320.npz"))
    heads = [torch.from_numpy(fx[k].transpose(0, 2, 3, 1).copy()).to(dev)
             for k in ("logits_large", "logits_small")]
    with torch.inference_mode():
        cand = decode_heads(heads, io.anchors, io.input_hw, io.conf_thre, io.max_decode)
        tta = _merge_tta(*cand, float(io.input_hw[1]))
    return {(name, b): tile_candidates(*c, b) + (io,)
            for name, c in (("golden_256x320", cand), ("golden_256x320_tta", tta))
            for b in (1, 64)}


def dense_sets(dev):
    """Random heavily overlapping boxes of two classes on a small field,
    85% valid, conf-descending (K=128), at B=1 and B=64."""
    import numpy as np
    import torch
    from yolofastest_torch.configs import get_config

    io = get_config("256x320").io
    rng = np.random.default_rng(0)
    sets = {}
    for b in (1, 64):
        xy = rng.integers(0, 40, (b, 128, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + rng.integers(1, 30, (b, 128, 2))], -1)
        conf = -np.sort(-rng.random((b, 128), dtype=np.float32), axis=1)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            boxes.astype(np.float32), conf, rng.random((b, 128), dtype=np.float32),
            rng.integers(0, 2, (b, 128)).astype(np.int32), rng.random((b, 128)) < 0.85)]
        sets[("dense", b)] = (*t, io)
    return sets


def build_phases(root: str):
    """The NMS source built once per phase variant, all nvcc at once."""
    sys.path.insert(0, root)
    from yolofastest_torch.kernels import _build

    out = os.path.join(root, "build", "nms_phases")
    os.makedirs(out, exist_ok=True)
    jobs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
         "-o", os.path.join(out, f"{name}.so"), os.path.join(_build.CSRC, "nms.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macros in PHASES.items()}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    return {name: os.path.join(out, f"{name}.so") for name in PHASES}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO, help="checkout whose yolofastest_torch to time")
    parser.add_argument("--label", default="this")
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--phases", action="store_true",
                        help="also time the kernel with phases compiled out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_nms_timing: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from yolofastest_torch.kernels import nms as nms_kernel
    from yolofastest_torch.ops import nms as nms_ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    packed_entry = getattr(nms_kernel, "nms_packed", None)
    for (name, b), (boxes, conf, score, cls, valid, io) in candidate_sets(dev).items():
        def stage():
            return nms_ops.batched_nms(boxes, conf, score, cls, valid, iou_thre=io.nms_thre,
                                       max_det=io.max_det, packed=True)

        def kernel():
            if packed_entry is not None:
                return packed_entry(boxes, conf, score, cls, valid, io.nms_thre, io.max_det)
            return nms_kernel.nms_keep(boxes, cls, valid, io.nms_thre)

        for _ in range(3):
            stage()
        by_name = {}
        for start, end, n in device_events(stage, args.reps):
            if end > start:
                by_name.setdefault(n, []).append((end - start) / 1e3)
        print(json.dumps({
            "label": args.label, "candidates": name, "B": b, "K": int(valid.shape[1]),
            "box_strides": list(boxes.stride()),
            "kernels": {n: {"per_call": len(ts) / args.reps, "ms": sum(ts) / len(ts)}
                        for n, ts in sorted(by_name.items())},
            "launches_per_call": sum(len(ts) for ts in by_name.values()) / args.reps,
            "nms_kernel_device_ms": kernel_device_ms(stage, args.reps, "nms")[0],
            "stage_busy_ms": device_busy(stage, args.reps)[0],
            "stage_queued_ms": queued_ms(stage, args.reps),
            "stage_host_ms": dispatch_ms(stage, args.reps),
            "stage_events_ms": cuda_ms(stage, args.reps),
            "kernel_events_ms": cuda_ms(kernel, args.reps)}), flush=True)

    if not args.phases:
        return 0
    libs = build_phases(root)
    real_lib = nms_kernel._lib
    floor_ms = kernel_device_ms(lambda: torch.cuda._sleep(1), args.reps, "")[0]
    sets = {**candidate_sets(dev), **dense_sets(dev)}
    for (name, b), (boxes, conf, score, cls, valid, io) in sets.items():
        row = {"label": args.label, "phases": True, "candidates": name, "B": b,
               "K": int(valid.shape[1]), "valid_rows": int(valid.sum()),
               "floor_ms": floor_ms}
        for variant, path in libs.items():
            lib = ctypes.CDLL(path)
            for fn in ("yf_nms_packed", "yf_nms_max_rows", "yf_nms_error_string"):
                getattr(lib, fn).argtypes = getattr(real_lib(), fn).argtypes
                getattr(lib, fn).restype = getattr(real_lib(), fn).restype
            nms_kernel._lib = lambda lib=lib: lib
            try:
                def call():
                    return nms_kernel.nms_packed(boxes, conf, score, cls, valid, io.nms_thre,
                                                 io.max_det)

                for _ in range(3):
                    call()
                row[f"{variant}_ms"] = kernel_device_ms(call, args.reps, "nms")[0]
            finally:
                nms_kernel._lib = real_lib
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
