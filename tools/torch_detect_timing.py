#!/usr/bin/env python3
"""Time the port's detect path end to end on the card (H100), for one checkout.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/torch_detect_timing.py [--root DIR] [--label NAME] [--reps 20]

It imports ``yolofastest_torch`` from ``--root`` (default: this checkout), so
that two commits can be timed in one call on one card: unpack the other one
with ``git archive`` into a git-ignored directory and run the two in turns
(A, B, B, A).  On the 256x320 model with the golden frames tiled to the
batch, fp32 and bf16, B=1 and B=64, it prints one JSON line per case with:

* ``split_ms``: ``run_raw``'s preprocess, forward and decode+NMS, each
  between CUDA events (where the host is slower than the card these include
  the card waiting for the host's launches);
* ``latency_ms``: one ``run_raw`` call and its result fetched to the host,
  on an idle card (host clock, median of 5 x ``reps`` calls);
* ``images_per_s``: ``reps`` calls back to back and one fetch at the end
  (host clock, median of 5 bursts), so the card and the host overlap as a
  serving loop lets them;
* ``device_busy_ms`` and ``device_busy_share``: the union of the card's
  intervals in a ``torch.profiler`` trace of 10 back-to-back calls, per
  call and as a share of the traced span.

Where the checkout has them, it also times the lite model and flip TTA
(fp32, B=1 and B=64: ``latency_ms``, ``images_per_s``, busy), and streams 32
batches of 64 uint8 frames at depth 1, 2 and 4, sync and threaded, 5 runs
each, printing the median images/s and the busy share of one traced run.
The first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from torch_timing import device_busy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def end_to_end(det, frames, reps: int):
    """Median latency of one ``run_raw`` with its result fetched (5 x reps
    calls on an idle card), median images/s of 5 bursts of ``reps``
    back-to-back calls, and the card's busy time per call and busy share
    over 10 calls."""
    import numpy as np
    import torch

    lat = []
    for _ in range(5 * reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.run_raw(frames)["count"].cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    rates = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = det.run_raw(frames)
        out["count"].cpu()
        rates.append(frames.shape[0] * reps / (time.perf_counter() - t0))
    busy_ms, share = device_busy(lambda: det.run_raw(frames), 10)
    return {"latency_ms": float(np.median(lat)), "images_per_s": float(np.median(rates)),
            "device_busy_ms": busy_ms, "device_busy_share": share}


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO, help="checkout whose yolofastest_torch to time")
    parser.add_argument("--label", default="this")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_detect_timing: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.models import load_variables

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    fx = np.load(os.path.join(root, "tests", "fixtures", "golden_256x320.npz"))
    pre = fx["pre_imgs"]
    n_imgs = pre.shape[0]
    variables = load_variables(os.path.join(root, "weights", "yolofastest_256x320.npz"))

    def bgr(idx):
        up = np.repeat(np.repeat(pre[idx], 2, axis=1), 2, axis=2)
        return np.repeat(up[..., None], 3, axis=-1)

    for dt in (torch.float32, torch.bfloat16):
        det = Detector(get_config("256x320"), variables=variables, compute_dtype=dt, device="cuda")
        for b in (1, 64):
            frames = torch.from_numpy(bgr(np.arange(b) % n_imgs)).to(dev)
            for _ in range(3):
                det.run_raw(frames)
            torch.cuda.synchronize()
            ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(args.reps)]
            for e in ev:
                e[0].record()
                x = det.preprocess(frames)
                e[1].record()
                heads = det.forward_heads(x)
                e[2].record()
                det.postprocess(heads, packed=True)
                e[3].record()
            torch.cuda.synchronize()
            split = [float(np.mean([e[j].elapsed_time(e[j + 1]) for e in ev])) for j in range(3)]
            print(json.dumps({"label": args.label, "dtype": str(dt).split(".")[-1], "batch": b,
                              "split_ms": {"preprocess": split[0], "forward": split[1],
                                           "decode_nms": split[2], "total": sum(split)},
                              **end_to_end(det, frames, args.reps)}), flush=True)

    # The lite model and flip TTA, fp32, where the checkout has them.
    for name, cfg_name, weights, kwargs in (
            ("lite", "lite-256x320", "yolofastest_lite_256x320.npz", {"arch": "lite"}),
            ("tta", "256x320", "yolofastest_256x320.npz", {"tta": True})):
        try:
            det = Detector(get_config(cfg_name), variables=load_variables(
                os.path.join(root, "weights", weights)), device="cuda", **kwargs)
        except (NotImplementedError, TypeError):
            continue
        for b in (1, 64):
            frames = torch.from_numpy(bgr(np.arange(b) % n_imgs)).to(dev)
            for _ in range(3):
                det.run_raw(frames)
            print(json.dumps({"label": args.label, "variant": name, "dtype": "float32", "batch": b,
                              **end_to_end(det, frames, args.reps)}), flush=True)

    try:
        from yolofastest_torch.inference import StreamingDetector
    except ImportError:
        return 0
    det = Detector(get_config("256x320"), variables=variables, device="cuda")
    batches = [pre[(np.arange(64) + 7 * k) % n_imgs].copy() for k in range(32)]
    for threaded in (False, True):
        for depth in (1, 2, 4):
            sd = StreamingDetector.over(det, depth=depth, threaded=threaded)
            list(sd(iter(batches[:4])))
            rates = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                list(sd(iter(batches)))
                rates.append(64 * len(batches) / (time.perf_counter() - t0))
            busy_ms, share = device_busy(lambda: list(sd(iter(batches))), 1)
            print(json.dumps({"label": args.label, "streaming": True, "dtype": "float32",
                              "batch": 64, "batches": len(batches), "depth": depth,
                              "threaded": threaded, "images_per_s": float(np.median(rates)),
                              "images_per_s_runs": rates, "device_busy_ms": busy_ms,
                              "device_busy_share": share}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
