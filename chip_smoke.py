#!/usr/bin/env python3
"""Drive the PyTorch port (``yolofastest_torch``) end to end on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``yolofastest_torch/kernels/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version, runs the deployed detector (``Detector.run_raw``: uint8
frames in, detections out) on the golden fixtures at both resolutions and
checks the golden boxes, drives every other entry point of the port (lite,
TTA, sliced detection, streaming, the batcher and HTTP server, video with
tracking) at full width, then times the main path and the kernels, and
drives the training path (the Trainer's fit with validation and
checkpoints, the mAP evaluator through both backends, distillation, a
trained checkpoint deployed).  Phases print one JSON line each, in order:
device (after the raw ``nvidia-smi`` line), build, kernels, nms_kernel (the
NMS kernel's packed rows and keep mask bit for bit against its plain
version), golden (the main path, whose kernel launches are counted), k1_path
(the folded forward with its chains through the channels-first kernel),
bf16, pruned, lite, tta, sliced, timing (with the host return of a B=64
``run_packed``), streaming, serve, video, kernel_timing (the chains; the NMS
kernel's device time from the profiler beside its back-to-back events time,
which is the host's pace, and the NMS stage's kernels, device and host time
per call), train (fit, overfit, card against CPU in float64 and fp32,
restore, and the step's timing at B=16 and B=64, fp32 and bf16, split by
its profiler spans), eval, distill, deploy_trained; then
the ``{"kernels": [...]}`` summary, and last ``{"ok": true, "device":
{...}}``.  Every path resets the kernel launch counts before it runs and
checks them after.

Any failed check raises, so the script exits non-zero and prints no ok line;
without a CUDA card it exits 2 at once.  It imports nothing of JAX.  The
frames are built with numpy from ``tests/fixtures``; cv2 encodes the HTTP
request's image, writes the synthetic video and the synthetic VOC set the
training path reads (in a temporary directory).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
WEIGHTS = os.path.join(ROOT, "weights")

# Published dense peaks of one H100 SXM at its 700 W limit.  The 1x1 products
# run at the rate of the kernel's route: bf16 on the tensor cores (989
# TFLOP/s), fp32 as 3xTF32, three TF32 tensor-core products (495 TFLOP/s)
# for each; the depthwise runs at the fp32 FMA rate outside the tensor cores.
PRODUCT_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
FMA_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FP32_TOL = 1e-4  # rel and abs, as tests/test_kernels.py:49
BF16_TOL = 4 * 2.0 ** -7  # of max|y|: 4 ulp of bf16 (8 significant bits)
# Where the fp32 plain version is itself outside FP32_TOL of the float64
# chain, the kernel may be at most this many times as far from float64 as the
# plain version.  On the card the kernel's worst error is at most 1.36x the
# plain version's over 40 inputs (tools/torch_chain_precision.py --seeds 4);
# a kernel that lost bits in its accumulation was 2.5-4x as far.
FLOAT64_SLACK = 2.0
K1_SOURCE = "yolofastest_torch/kernels/csrc/res_chain.cu"
NMS_SOURCE = "yolofastest_torch/kernels/csrc/nms.cu"
# float32 operations of one IOU and its two comparisons in the NMS kernel
# (4 max/min, 2 x 3 for the clamped extents, 1 product, 2 x 5 for the
# areas, 3 for the union, 1 division, 2 comparisons)
NMS_PAIR_OPS = 27
# bytes the NMS reads a candidate (4 corners, conf, cls_score, cls_idx: 4
# each; valid: 1) and writes a candidate (keep: 1) and a packed place (8 x 4)
NMS_IN_BYTES, NMS_KEEP_BYTES, NMS_ROW_BYTES = 29, 1, 32


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def make_frames(pre_imgs: np.ndarray) -> np.ndarray:
    """Gray (N, H, W) uint8 -> (N, 2H, 2W, 3) BGR uint8 that the port's
    preprocess maps back exactly: the BT.601 coefficients sum to 2^14, and
    the 2x downsample averages four equal pixels."""
    up = np.repeat(np.repeat(pre_imgs, 2, axis=1), 2, axis=2)
    return np.repeat(up[..., None], 3, axis=-1)


def chain_planes(input_hw):
    """(H, W) of each of the six res chains at a net input size."""
    h, w = input_hw
    return [(h // s, w // s) for s in (2, 4, 8, 8, 16, 32)]


def golden_match(rows, ref_boxes, n_imgs):
    """Strict golden rule (tests/test_detect_parity.py:145-171): equal
    per-image counts; each reference box matched once by class, corners
    within 1 px, conf and cls_score within 1e-3.  Returns (matched, notes)."""
    matched, notes = 0, []
    for b in range(n_imgs):
        ref = ref_boxes[ref_boxes[:, 0] == b][:, 1:]
        mine = rows[b]
        if len(mine) != len(ref):
            notes.append(f"img {b}: {len(mine)} boxes vs reference {len(ref)}")
        used = set()
        for r in ref:
            for i, m in enumerate(mine):
                if (i not in used and int(m[6]) == int(r[6])
                        and max(abs(m[j] - r[j]) for j in range(4)) <= 1.0
                        and abs(m[4] - r[4]) < 1e-3 and abs(m[5] - r[5]) < 1e-3):
                    used.add(i)
                    matched += 1
                    break
            else:
                notes.append(f"img {b}: reference box {r.tolist()} unmatched")
    return matched, notes


def box_iou(a, b) -> float:
    """IoU of two xyxy boxes, the golden suite's (tools/run_golden_suite.py:29)."""
    inter = (max(min(a[2], b[2]) - max(a[0], b[0]), 0)
             * max(min(a[3], b[3]) - max(a[1], b[1]), 0))
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-9)


def tie_heads(io):
    """The tie fixture of tests/test_torch_ops.py: all-zero logits but a fixed
    objectness, so every candidate has the same conf and the corners land on
    exact .5 values; one higher-conf candidate in image 0."""
    heads = []
    for (h, w) in io.head_hw:
        a = np.zeros((2, h, w, io.num_out), np.float32)
        a[..., 4::8] = 1.0
        a[0, 0, 1, 8 + 4] = 3.0
        heads.append(a)
    return heads


def overlap_batch(rng, b, k):
    """Heavily overlapping boxes of two classes on a small field, with
    invalid rows among the valid ones (conf order is the row order)."""
    xy = rng.integers(0, 40, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.integers(1, 30, (b, k, 2))], -1).astype(np.float32)
    return boxes, rng.integers(0, 2, (b, k)).astype(np.int32), rng.random((b, k)) < 0.85


def nms_bound(valid, keep, max_det):
    """Least time (ms) and what bounds it for one NMS call (keep mask and
    packed rows), from this call's data.  Operations: one IOU and its
    comparisons for every pair the greedy loop evaluates (each row i kept at
    its step, against every later valid row of the image up to its last
    valid one) at the fp32 FMA peak.  Bytes: each input read once (29 a
    candidate), keep written once (1 a candidate) and the min(K, max_det)
    packed rows of each image written once (32 each)."""
    v = valid.cpu().numpy()
    kp = keep.cpu().numpy()
    pairs = 0
    for b in range(v.shape[0]):
        rows = np.flatnonzero(v[b])
        if rows.size:
            last = rows[-1]
            later_valid = np.cumsum(v[b][::-1])[::-1]  # valid rows at or after i
            for i in np.flatnonzero(kp[b][:last]):
                pairs += int(later_valid[i + 1])
    t_ops = pairs * NMS_PAIR_OPS / FMA_FLOPS
    b, k = v.shape
    t_bytes = (b * k * (NMS_IN_BYTES + NMS_KEEP_BYTES)
               + b * min(k, max_det) * NMS_ROW_BYTES) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", pairs


def recall_iou(rows, golden, strict=True):
    """Golden boxes found by a detection of the same class with IoU > 0.5
    (>= 0.5 where ``strict`` is False)."""
    found = 0
    for g in golden:
        ious = [box_iou(r[:4], g[1:5]) for r in rows[int(g[0])] if int(r[6]) == int(g[7])]
        found += any(v > 0.5 if strict else v >= 0.5 for v in ious)
    return found


def rows_close(a, b) -> bool:
    """Rows of one image through two batch sizes: fp32 sums in another order
    (tests/test_serve.py:48-52)."""
    return len(a) == len(b) and (not a or bool(np.allclose(np.asarray(a), np.asarray(b),
                                                           rtol=1e-5, atol=1e-4)))


def chain_bound(b, h, w, c, i, k, dtype_name):
    """Least time (ms) and what bounds it for one chain call.  Operations:
    K*4CI flops per pixel of 1x1 products at the rate of the kernel's route
    for the dtype plus K*18I of depthwise at the fp32 FMA peak.  Bytes: x
    read and y written once plus the weights, at the HBM rate."""
    px = b * h * w
    itemsize = 4 if dtype_name == "float32" else 2
    t_ops = (px * k * 4 * c * i / PRODUCT_FLOPS[dtype_name]
             + px * k * 18 * i / FMA_FLOPS)
    nbytes = 2 * c * px * itemsize + k * (c * i + 9 * i + i * c) * itemsize + k * (2 * i + c) * 4
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def fp32_ratio(got, ref) -> float:
    """Worst ratio of |got - ref| to the fp32 tolerance: above 1 fails it."""
    return float(((got - ref).abs() / (FP32_TOL + FP32_TOL * ref.abs())).max())


def train_path(card, counted) -> dict:
    """The training path on the card: train, eval, distill and
    deploy_trained, one JSON line each; returns the launch counts of each."""
    import dataclasses
    import tempfile

    import torch

    from torch_timing import device_busy, span_ms
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.data import DetectionLoader, ListLoader, VOCIndex, write_synthetic_voc
    from yolofastest_torch.eval import MAPEvaluator, make_backend_eval_fn
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.models import load_variables
    from yolofastest_torch.train import Trainer, checkpoint_variables, make_teacher_fn
    from yolofastest_torch.utils.logging import LineLog

    zoo = load_variables(os.path.join(WEIGHTS, "yolofastest_256x320.npz"))
    preset = get_config("256x320")
    tr = dataclasses.replace(preset.train, batch_size=16, total_epochs=2, val_after_epoch=-1,
                             ema_decay=0.999, ema_ramp=20, warmup_min_iters=2, log_every=2,
                             max_to_keep=2)
    cfg = dataclasses.replace(preset, train=tr)
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    gmap = np.load(os.path.join(FIXTURES, "golden_map.npz"))
    golden_x = (fx["pre_imgs"].astype(np.float32)[..., None] - 128.0) / 255.0
    counts = {}

    def cycle(loader):
        while True:
            yield from loader

    with tempfile.TemporaryDirectory(prefix="yf_train_") as td:
        # ---------------------------------------------------------- train
        # fit: 64 synthetic images at the preset's 512x640, B=16, 2 epochs
        # from the zoo weights, EMA, validation every epoch, checkpoints
        voc = os.path.join(td, "voc")
        write_synthetic_voc(voc, 64, cfg.io.origin_img_shape[:2], cfg.io.class_names, seed=0)
        index = VOCIndex(voc, cfg.io.class_names)
        loader = DetectionLoader(index, cfg, seed=0, cache=True)
        log = LineLog()
        trainer = Trainer(cfg, batch_per_epoch=len(loader), variables=zoo, logger=log,
                          device="cuda")
        validator = MAPEvaluator(cfg, DetectionLoader(index, cfg, augment=False, shuffle=False,
                                                      drop_last=False), logger=log, device="cuda")
        ckdir = os.path.join(td, "ckpt")
        t0 = time.perf_counter()
        history, counts["train"] = counted(lambda: trainer.fit(loader, validator=validator,
                                                               checkpoint_dir=ckdir))
        fit_s = time.perf_counter() - t0
        fit_losses = [float(ln.split("loss = ")[1].split(",")[0]) for ln in log.lines
                      if "loss = " in ln]
        check(len(fit_losses) == 4 and all(np.isfinite(fit_losses)), f"fit losses {fit_losses}")
        check(sorted(os.listdir(ckdir)) == ["epoch_0", "epoch_1"] and len(history) == 2
              and all("mAP" in h for h in history), f"fit: {history}, {os.listdir(ckdir)}")
        # validation is the path's only kernel: one NMS launch a val batch
        check(counts["train"]["nms"] == 2 * 4 and counts["train"]["res_chain_rows"] == 0,
              f"fit launches {counts['train']}")

        # a restored step equals the uninterrupted one (cuDNN deterministic)
        batch = next(iter(loader))
        fresh = Trainer(cfg, batch_per_epoch=len(loader), seed=1, device="cuda")
        fresh.restore_checkpoint(os.path.join(ckdir, "epoch_1"))
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            for t in (trainer, fresh):
                t.step(*batch)
        pairs = [(getattr(trainer.state, f), getattr(fresh.state, f))
                 for f in ("params", "batch_stats", "mu", "nu")]
        pairs += list(zip(trainer.state.ema, fresh.state.ema))
        restore_diff = max(float((a - b).abs().max()) for a, b in pairs)

        # one batch 20 times: the loss drops
        one = dataclasses.replace(cfg, train=dataclasses.replace(tr, ema_decay=0.0))
        over = Trainer(one, batch_per_epoch=1, variables=zoo, device="cuda")
        over_losses = [float(over.step(*batch)["total"]) for _ in range(20)]

        # card against CPU: two steps from the zoo weights on the same two
        # batches, in fp32 (TF32 off) and in float64 (Trainer.to_float64).
        # Per leaf, relative L2 of the step (the weights' change from the
        # zoo: step 0 has lr 0, so this is step 1's Adam update), of Adam's
        # first moment (the gradients) and of the weights, leaving out the
        # leaves whose float64 gradient is zero (BatchNorm biases of linear
        # layers that only feed train-mode BN).  float64: the card equals the
        # CPU (a wrong, skipped or sign-flipped update is off by 1-2 a leaf).
        # fp32: the card against the CPU, at 0.5 a leaf for the step and the
        # moment (fp32 sums over this many pixels put either side ~0.1 a leaf
        # from float64, the card and the CPU ~0.02 apart), and each side's
        # distance from float64.
        two = list(DetectionLoader(index, cfg, seed=3))[:2]
        runs = {}
        for name, device in (("card", "cuda"), ("cpu", "cpu"), ("card64", "cuda"),
                             ("cpu64", "cpu")):
            t = Trainer(one, batch_per_epoch=1, variables=zoo, device=device)
            if name.endswith("64"):
                t.to_float64()
            start = t.state.params.detach().to("cpu", torch.float64, copy=True)
            losses = [{k: float(v) for k, v in t.step(*b).items()} for b in two]
            params = t.state.params.detach().to("cpu", torch.float64, copy=True)
            vec = {"step": params - start, "mu": t.state.mu.detach().to("cpu", torch.float64),
                   "params": params}
            runs[name] = {"losses": losses,
                          **{k: t.layouts[0].views(v) for k, v in vec.items()}}
        mu64 = runs["cpu64"]["mu"]
        total = float(np.sqrt(sum(float(v.norm()) ** 2 for v in mu64.values())))
        kept = [n for n, v in mu64.items() if float(v.norm()) >= 1e-9 * total]

        def compare(a, b, what):
            rel = {n: rel_l2(runs[a][what][n], runs[b][what][n]) for n in kept}
            worst = max(rel, key=rel.get)
            whole = rel_l2(torch.cat([runs[a][what][n].reshape(-1) for n in kept]),
                           torch.cat([runs[b][what][n].reshape(-1) for n in kept]))
            return {"worst_leaf": [worst, rel[worst]],
                    "median": float(np.median(list(rel.values()))), "whole": whole}

        def loss_rel(a, b):
            return max(abs(x[k] - y[k]) / abs(y[k])
                       for x, y in zip(runs[a]["losses"], runs[b]["losses"])
                       for k in ("total", "x", "y", "w", "h", "conf", "cls"))

        card_vs_cpu = {"steps": 2, "leaves": len(kept),
                       "zero_gradient_leaves": len(mu64) - len(kept),
                       "loss_max_rel": {"float64": loss_rel("card64", "cpu64"),
                                        "fp32": loss_rel("card", "cpu")}}
        for a, b in (("card64", "cpu64"), ("card", "cpu"), ("card", "card64"), ("cpu", "cpu64")):
            card_vs_cpu[f"{a}_vs_{b}"] = {w: compare(a, b, w) for w in ("step", "mu", "params")}

        # the step's timing, fed by the loader (cache on) like fit, and on
        # batches already on the card; the split from the step's profiler
        # spans (device ms of each span's operations, host ms under the trace)
        timing = []
        for dt in (torch.float32, torch.bfloat16):
            for b in (16, 64):
                cb = dataclasses.replace(cfg, train=dataclasses.replace(tr, batch_size=b))
                lb = DetectionLoader(index, cb, seed=0, cache=True)
                tb = Trainer(cb, batch_per_epoch=len(lb), variables=zoo, compute_dtype=dt,
                             device="cuda")
                feed = cycle(lb)
                host = next(feed)
                resident = [tuple(tb.upload(a) for a in next(feed)) for _ in range(2)]
                for i in range(3):
                    tb.step(*resident[i % 2])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                n, wait = 10, 0.0
                t0 = time.perf_counter()
                for _ in range(n):
                    w0 = time.perf_counter()
                    imgs, tgts = next(feed)
                    wait += time.perf_counter() - w0
                    tb.step(tb.upload(imgs), tb.upload(tgts))
                torch.cuda.synchronize()
                fed_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                for i in range(n):
                    tb.step(*resident[i % 2])
                torch.cuda.synchronize()
                resident_s = time.perf_counter() - t0
                peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
                busy_ms, busy_share = device_busy(lambda: tb.step(*resident[0]), 3)
                spans = span_ms(lambda: tb.step(tb.upload(host[0]), tb.upload(host[1])), 3,
                                "train_step/")
                # the backward's kernels run on the autograd engine's thread
                split = {k: v[0] for k, v in spans.items() if k != "autograd_engine"}
                split["backward"] += spans["autograd_engine"][0]
                timing.append({
                    "dtype": str(dt).split(".")[-1], "batch": b, "steps": n,
                    "steps_per_s": n / fed_s, "images_per_s": n * b / fed_s,
                    "loader_wait_ms": wait * 1e3 / n,
                    "split_device_ms": split,
                    "split_host_ms_traced": {k: v[1] for k, v in spans.items()
                                             if k != "autograd_engine"},
                    "steps_per_s_resident": n / resident_s,
                    "images_per_s_resident": n * b / resident_s,
                    "device_busy_ms": busy_ms, "device_busy_share": busy_share,
                    "peak_memory_mb": peak_mb})
        emit("train", card=card, res="256x320", images=64, origin=list(cfg.io.origin_img_shape),
             fit={"epochs": 2, "batch": 16, "steps": 8, "seconds": fit_s, "losses": fit_losses,
                  "mAP": [h["mAP"] for h in history], "launches": counts["train"]},
             restored_step_max_abs_diff=restore_diff,
             overfit={"losses": over_losses[::4] + [over_losses[-1]],
                      "last3_over_first": float(np.mean(over_losses[-3:]) / over_losses[0])},
             card_vs_cpu={**card_vs_cpu,
                          "tolerance": "float64: losses and every leaf (step, mu, params) "
                                       "1e-9; fp32: losses 1e-4, params 1e-3 a leaf, step "
                                       "and mu 0.5 a leaf"},
             timing=timing,
             timing_note="steps_per_s: loader-fed (cache on) with the upload, like fit; "
                         "resident: batches already on the card; split: the step's "
                         "train_step/* profiler spans over 3 steps, ms a step (the "
                         "backward's device ms from the autograd engine's thread)")
        check(restore_diff == 0.0, f"restored step differs by {restore_diff}")
        check(np.mean(over_losses[-3:]) < 0.9 * over_losses[0],
              f"one batch 20 times: loss {over_losses[0]} -> {over_losses[-3:]}")
        f64 = card_vs_cpu["card64_vs_cpu64"]
        check(card_vs_cpu["loss_max_rel"]["float64"] <= 1e-9
              and all(f64[w]["worst_leaf"][1] <= 1e-9 for w in f64),
              f"card vs CPU in float64: {card_vs_cpu['loss_max_rel']}, {f64}")
        check(card_vs_cpu["loss_max_rel"]["fp32"] <= 1e-4,
              f"card vs CPU losses: {card_vs_cpu['loss_max_rel']}")
        check(card_vs_cpu["card_vs_cpu"]["params"]["worst_leaf"][1] <= 1e-3,
              f"card vs CPU weights: {card_vs_cpu['card_vs_cpu']['params']}")
        for w in ("step", "mu"):
            check(card_vs_cpu["card_vs_cpu"][w]["worst_leaf"][1] <= 0.5,
                  f"card vs CPU {w} in fp32: {card_vs_cpu['card_vs_cpu'][w]}")
        check(set(timing[0]["split_device_ms"]) == {"upload", "forward", "loss", "backward",
                                                    "optimizer"}
              and all(t["split_device_ms"]["backward"] > 0 for t in timing),
              f"step spans {timing[0]['split_device_ms']}")

        # the trained checkpoint (its EMA model) for deploy_trained
        trained = checkpoint_variables(os.path.join(ckdir, "epoch_1"))

    # ------------------------------------------------------ deploy_trained
    # through checkpoint_variables into the folded Detector: its heads equal
    # the trainable model's eval forward
    folded = Detector(preset, variables=trained, device="cuda")
    unfolded = Detector(preset, variables=trained, fold_bn=False, device="cuda")
    heads, counts["deploy_trained"] = counted(lambda: folded.forward_heads(golden_x))
    ref_heads = unfolded.forward_heads(golden_x)
    head_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(heads, ref_heads))
    emit("deploy_trained", card=card, dtype="float32", frames=int(golden_x.shape[0]),
         heads_max_abs_err_over_max=head_err, tolerance="1e-3 of the largest logit",
         launches=counts["deploy_trained"])
    check(head_err <= 1e-3, f"folded trained heads differ by {head_err}")
    check(counts["deploy_trained"]["res_chain_rows"] == 6 and counts["deploy_trained"]["nms"] == 0,
          f"deploy_trained launches {counts['deploy_trained']}")

    # ---------------------------------------------------------------- eval
    # the zoo 256x320 on the golden frames and golden_map targets (batches
    # of 8, 8 and a padded 4), through the training model and the deployed
    # Detector, the CPU port's mAP beside; then images/s on 4 batches of 64
    golden = ListLoader([(golden_x[i:i + 8], gmap["targets"][i:i + 8]) for i in (0, 8, 16)], 8)
    tiles = [np.arange(64 * k, 64 * k + 64) % 20 for k in range(4)]
    tiled = ListLoader([(golden_x[i], gmap["targets"][i]) for i in tiles], 64)

    def evaluator(backend, loader, device):
        if backend == "train":
            return MAPEvaluator(preset, loader, logger=LineLog(), device=device), zoo
        det = Detector(preset, variables=zoo, device=device)
        return MAPEvaluator(preset, loader, logger=LineLog(),
                            eval_fn=make_backend_eval_fn(det)), None

    ev = {}
    for backend in ("train", "fp"):
        e, v = evaluator(backend, golden, "cuda")
        m, counts[f"eval_{backend}"] = counted(lambda: e(v, 0))
        e_cpu, v_cpu = evaluator(backend, golden, "cpu")
        m_cpu = e_cpu(v_cpu, 0)
        e_t, v_t = evaluator(backend, tiled, "cuda")
        e_t(v_t, 0)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_t(v_t, 0)
        ips = 4 * 64 / (time.perf_counter() - t0)
        ev[backend] = {"mAP": m, "cpu_mAP": m_cpu, "target_num": e.last_metrics["target_num"],
                       "detection_rate": e.last_metrics["detection_rate"],
                       "images_per_s_4x64": ips, "launches": counts[f"eval_{backend}"]}
    emit("eval", card=card, res="256x320", weights="yolofastest_256x320.npz",
         ref_map=float(gmap["ref_map"]), backends=ev,
         tolerance="mAP within 1e-3 of the CPU port's")
    for backend, r in ev.items():
        check(abs(r["mAP"] - r["cpu_mAP"]) <= 1e-3,
              f"eval {backend}: {r['mAP']} vs CPU {r['cpu_mAP']}")
    check(counts["eval_train"]["nms"] == 3 and counts["eval_train"]["res_chain_rows"] == 0,
          f"eval train launches {counts['eval_train']}")
    check(counts["eval_fp"]["nms"] == 3 and counts["eval_fp"]["res_chain_rows"] == 18,
          f"eval fp launches {counts['eval_fp']}")

    # ------------------------------------------------------------- distill
    # a lite student (the lite zoo) against the full teacher (the 256x320
    # zoo, folded: 6 chain launches a step), 3 steps on the card; the first
    # step's losses against the CPU's
    lite = get_config("lite-256x320")
    lite = dataclasses.replace(lite, train=dataclasses.replace(lite.train, batch_size=16,
                                                               warmup_min_iters=2))
    student = load_variables(os.path.join(WEIGHTS, "yolofastest_lite_256x320.npz"))
    xb = golden_x[np.arange(16) % 20]
    tb = gmap["targets"][np.arange(16) % 20]
    runs = {}
    for device in ("cuda", "cpu"):
        t = Trainer(lite, batch_per_epoch=1, variables=student, arch="lite", device=device,
                    distill_fn=make_teacher_fn(zoo, device=device), distill_weight=1.0)
        if device == "cuda":
            steps, counts["distill"] = counted(lambda: [t.step(xb, tb) for _ in range(3)])
        else:
            steps = [t.step(xb, tb)]
        runs[device] = [{k: float(v) for k, v in m.items()} for m in steps]
    d_rel = max(abs(runs["cuda"][0][k] - runs["cpu"][0][k]) / abs(runs["cpu"][0][k])
                for k in ("total", "distill", "conf", "cls"))
    emit("distill", card=card, student="yolofastest_lite_256x320.npz",
         teacher="yolofastest_256x320.npz", batch=16, steps=3,
         losses=[{k: m[k] for k in ("total", "distill")} for m in runs["cuda"]],
         cpu_first_step={k: runs["cpu"][0][k] for k in ("total", "distill")},
         first_step_max_rel_vs_cpu=d_rel, tolerance="1e-4 relative", launches=counts["distill"])
    check(d_rel <= 1e-4, f"distill losses differ from the CPU's by {d_rel}")
    check(counts["distill"]["res_chain_rows"] == 18 and counts["distill"]["nms"] == 0,
          f"distill launches {counts['distill']}: want 6 chains a step")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from torch_timing import (cuda_ms, device_busy, dispatch_ms, kernel_device_ms, queued_ms,
                              stage_kernels, tile_candidates)
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import (DetectionServer, Detector, DynamicBatcher,
                                             IoUTracker, StreamingDetector, detect_video,
                                             detections_to_lists, make_batch_fn, sliced_detect)
    from yolofastest_torch.inference.detector import _merge_tta, image_to_net_input
    from yolofastest_torch.kernels import (LAUNCHES, _build, nms_keep, nms_keep_plain, nms_packed,
                                           nms_packed_plain)
    from yolofastest_torch.kernels import nms as nms_kernel
    from yolofastest_torch.kernels import res_block as rb
    from yolofastest_torch.ops import decode_heads, normalize
    from yolofastest_torch.ops import nms as nms_ops
    from yolofastest_torch.models import (RES_CHAINS, FoldedExecutor, fold_batchnorm,
                                          load_variables, torch_params_from_folded,
                                          walk_topology)
    from yolofastest_torch.utils.device import exact_fp32

    # The script's own fp32 references run without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    # ------------------------------------------------------------ 1 device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device_count=torch.cuda.device_count(), python=sys.version.split()[0])

    # ------------------------------------------------------------- 2 build
    seconds = _build.build()
    ptxas = [ln.strip() for log in _build.BUILD_LOGS.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(seconds, 2), libraries=sorted(_build.BUILD_LOGS), ptxas=ptxas)

    # ----------------------------------------------------------- 3 kernels
    zoo = {name: fold_batchnorm(load_variables(os.path.join(WEIGHTS, f"yolofastest_{name}.npz")))
           for name in ("256x320", "512x640", "pruned040_256x320")}
    rng = np.random.default_rng(0)
    cases = []  # (label, B, H, W, stacked numpy weights)
    for name, folded in zoo.items():
        hw0 = (512, 640) if name == "512x640" else (256, 320)
        for names, (h, w) in zip(RES_CHAINS, chain_planes(hw0)):
            cases.append((f"{name}/{names[0]}", 8, h, w,
                          rb.chain_weights_from_folded(folded, names)))
    # B=1 at the main path's six chains: the small tiles that fill the card
    for names, (h, w) in zip(RES_CHAINS, chain_planes((256, 320))):
        cases.append((f"256x320/{names[0]}/B1", 1, h, w,
                      rb.chain_weights_from_folded(zoo["256x320"], names)))

    def random_weights(k, c, i, scale=0.3):
        return tuple((rng.standard_normal(s) * sc).astype(np.float32) for s, sc in (
            ((k, c, i), scale), ((k, i), 0.1), ((k, 3, 3, i), scale), ((k, i), 0.1),
            ((k, i, c), scale), ((k, c), 0.1)))

    # ragged planes, tests/test_kernels.py's shapes, then multi-tile ragged
    # planes at B=1 with ragged widths (C=4; I = 20, 60, 84, 136; odd C and I,
    # whose bf16 weights stage without 4-byte pairs) (B, K, H, W, C, I)
    for b, k, h, w, c, i in [(3, 1, 13, 17, 8, 20), (3, 5, 13, 17, 48, 136),
                             (2, 1, 16, 20, 8, 32), (3, 2, 8, 10, 4, 8), (2, 3, 8, 12, 16, 48),
                             (2, 2, 8, 10, 48, 224), (4, 1, 16, 20, 24, 136),
                             (1, 1, 29, 37, 4, 20), (1, 2, 23, 31, 8, 60), (1, 4, 19, 27, 24, 84),
                             (1, 3, 13, 17, 24, 136), (1, 5, 11, 13, 48, 136), (2, 2, 9, 11, 5, 17)]:
        cases.append((f"random/B{b}K{k}H{h}W{w}C{c}I{i}", b, h, w, random_weights(k, c, i)))

    # fp32: within FP32_TOL of the plain version (summation order only).  A
    # deep chain with large weights can amplify fp32 rounding until the plain
    # version itself misses that tolerance against exact arithmetic; there it
    # is no oracle to 1e-4, and the case passes only if the plain version is
    # outside FP32_TOL of the float64 chain and the kernel is at most
    # FLOAT64_SLACK times as far from it.  Every such case is printed, with
    # how far the plain version on the CPU (another fp32 order) is from the
    # plain version on the card.
    checks, failures, by_float64 = [], [], []
    worst = {("cf", "float32"): 0.0, ("cf", "bfloat16"): 0.0,
             ("rows", "float32"): 0.0, ("rows", "bfloat16"): 0.0}
    rb.reset_launch_counts()
    for label, b, h, w, st in cases:
        c = st[0].shape[1]
        x = torch.from_numpy((rng.standard_normal((b, h, w, c)) * 0.5).astype(np.float32)).to(dev)
        wt = [torch.from_numpy(a).to(dev) for a in st]
        exact = None
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            x_rows, x_cf = xd.reshape(-1, c), xd.permute(3, 0, 1, 2).reshape(c, -1).contiguous()
            for layout, kern, plain, xin in (
                    ("rows", rb.fused_res_chain_rows, rb.res_chain_rows_plain, x_rows),
                    ("cf", rb.fused_res_chain_cf, rb.res_chain_cf_plain, x_cf)):
                got = kern(xin, *wt, (h, w)).float()
                ref = plain(xin, *wt, (h, w)).float()
                torch.cuda.synchronize()
                err = (got - ref).abs()
                dname = str(dt).split(".")[-1]
                if dt == torch.float32:
                    ratio = fp32_ratio(got, ref)
                    ok = ratio <= 1.0
                    tol = f"{FP32_TOL} rel+abs"
                    if not ok:
                        if exact is None:
                            exact = rb.res_chain_float64(x, *wt)
                        ex = (exact.reshape(-1, c) if layout == "rows"
                              else exact.permute(3, 0, 1, 2).reshape(c, -1))
                        r_plain = fp32_ratio(ref.cpu().double(), ex)
                        r_kern = fp32_ratio(got.cpu().double(), ex)
                        r_cpu = fp32_ratio(plain(xin.cpu(), *(t.cpu() for t in wt), (h, w)),
                                           ref.cpu())
                        ok = r_plain > 1.0 and r_kern <= FLOAT64_SLACK * r_plain
                        tol += f"; else <= {FLOAT64_SLACK} x plain's distance from float64"
                        by_float64.append({"case": label, "layout": layout,
                                           "ratio_vs_plain": ratio,
                                           "cpu_plain_ratio_vs_plain": r_cpu,
                                           "plain_ratio_vs_float64": r_plain,
                                           "kernel_ratio_vs_float64": r_kern, "ok": ok})
                else:
                    bound = BF16_TOL * ref.abs().max().item()
                    ok = bool(err.max().item() <= bound)
                    tol = f"{bound:.3g} (4 bf16 ulp of max|y|)"
                e = err.max().item()
                ok = ok and bool(torch.isfinite(got).all())
                worst[(layout, dname)] = max(worst[(layout, dname)], e)
                checks.append({"case": label, "layout": layout, "dtype": dname,
                               "max_abs_err": e, "tol": tol, "ok": ok})
                if not ok:
                    failures.append(checks[-1])
    launched = dict(rb.LAUNCHES)
    emit("kernels", checks=len(checks), failed=failures[:10],
         max_abs_err={f"{k[0]}/{k[1]}": v for k, v in worst.items()},
         tolerance={"float32": f"{FP32_TOL} rel+abs against plain, TF32 off; where plain "
                               "itself misses it against float64, the kernel at most "
                               f"{FLOAT64_SLACK} x as far from float64 as plain",
                    "bfloat16": "4 bf16 ulp of max|y|"},
         decided_by_float64=by_float64,
         launches=launched)
    check(not failures, f"{len(failures)} kernel checks out of tolerance: {failures[:3]}")
    check(launched["res_chain_rows"] == launched["res_chain_cf"] == 2 * len(cases),
          f"kernel launch counts {launched}")

    # --------------------------------------------------------- 3b nms kernel
    # Bit for bit against the plain version (on the card too): the packed
    # rows and keep of the candidates of the golden frames at both
    # resolutions (decode's strided views; and TTA's doubled K, gathered),
    # the tie fixture of tests/test_torch_ops.py, and 200 random batches of
    # heavily overlapping boxes of two classes under both IOU conventions
    # and four max_det (every other batch as strided views).  Each check also
    # holds keep against the greedy loop and against nms_keep (the same
    # kernel with one packed place an image): two launches a check.
    def candidates(res, heads=None, tta=False):
        io = get_config(res).io
        if heads is None:
            d = Detector(get_config(res), variables=load_variables(
                os.path.join(WEIGHTS, f"yolofastest_{res}.npz")), device="cuda", tta=tta)
            fr = make_frames(np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))["pre_imgs"])
            with torch.inference_mode():
                heads = d.forward_heads(d.preprocess(fr))
                cand = decode_heads(heads, io.anchors, io.input_hw, io.conf_thre, io.max_decode)
                if tta:
                    cand = _merge_tta(*cand, float(io.input_hw[1]))
            return cand, io
        heads = [torch.from_numpy(h).to(dev) for h in heads]
        return decode_heads(heads, io.anchors, io.input_hw, io.conf_thre, io.max_decode), io

    nms_sets = {f"golden_{res}": candidates(res) for res in ("256x320", "512x640")}
    nms_sets["golden_256x320_tta"] = candidates("256x320", tta=True)
    nms_sets["ties"] = candidates("256x320", heads=tie_heads(get_config("256x320").io))

    def nms_check(args, thre, max_det, off):
        """Mismatched packed rows and mask bits of one check, and keep."""
        rows, keep = nms_packed(*args, thre, max_det, off)
        want_rows, want_keep = nms_packed_plain(*args, thre, max_det, off)
        loop = nms_keep_plain(args[0], args[3], args[4], thre, off)
        alone = nms_keep(args[0], args[3], args[4], thre, off)
        bad = int((rows.view(torch.int32) != want_rows.view(torch.int32)).any(-1).sum())
        for mask in (want_keep, loop, alone):
            bad += int((keep != mask).sum())
        return bad, keep

    rb.reset_launch_counts()
    nms_checks, mismatched = 0, 0
    per_set = {}
    for name, (cand, io) in nms_sets.items():
        for off in (0.0, 1.0):
            bad, keep = nms_check(cand, io.nms_thre, io.max_det, off)
            per_set[f"{name}/offset{int(off)}"] = {
                "shape": list(keep.shape), "box_strides": list(cand[0].stride()),
                "kept": int(keep.sum()), "mismatches": bad}
            mismatched += bad
            nms_checks += 1
    rng_nms = np.random.default_rng(1)
    random_kept = 0
    nms_max_dets = (1, 64, 128, 200)
    for n in range(200):
        boxes, cls_idx, valid = overlap_batch(rng_nms, 8, 128)
        conf = -np.sort(-rng_nms.random((8, 128), dtype=np.float32), axis=1)
        rows = torch.from_numpy(np.concatenate(
            [boxes, conf[..., None], rng_nms.random((8, 128, 1), dtype=np.float32)], -1)).to(dev)
        if n % 2:  # decode's layout: views of one (B, K, 6) tensor
            args = (rows[..., 0:4], rows[..., 4], rows[..., 5])
        else:
            args = (rows[..., 0:4].contiguous(), rows[..., 4].contiguous(),
                    rows[..., 5].contiguous())
        args += (torch.from_numpy(cls_idx).to(dev), torch.from_numpy(valid).to(dev))
        for off in (0.0, 1.0):
            bad, keep = nms_check(args, 0.4, nms_max_dets[n % 4], off)
            mismatched += bad
            random_kept += int(keep.sum())
            nms_checks += 1
    torch.cuda.synchronize()
    nms_launches = LAUNCHES["nms"]
    emit("nms_kernel", checks=nms_checks, mismatches=mismatched, launches=nms_launches,
         sets=per_set, random={"batches": 200, "shape": [8, 128], "iou_thre": 0.4,
                               "pixel_offsets": [0, 1], "max_det": list(nms_max_dets),
                               "kept": random_kept},
         tolerance="bit for bit: packed rows and keep against nms_packed_plain, keep "
                   "against nms_keep_plain and nms_keep, on the card")
    check(mismatched == 0, f"NMS kernel differs from its plain version in {mismatched} places")
    check(nms_launches == 2 * nms_checks, f"NMS launches {nms_launches} for {nms_checks} checks")

    # ---------------------------------------------- 4 golden, the main path
    def detector(res, dtype=torch.float32, weights=None, **kwargs):
        path = os.path.join(WEIGHTS, f"yolofastest_{weights or res}.npz")
        return Detector(get_config(res), variables=load_variables(path),
                        compute_dtype=dtype, device="cuda", **kwargs)

    def counted(fn):
        """Run one path with every launch count set to 0 just before it;
        returns its result and the counts read just after."""
        rb.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(LAUNCHES)

    def check_path(name, counts, forwards):
        check(counts["res_chain_rows"] == 6 * forwards and counts["nms"] == forwards
              and counts["res_chain_cf"] == 0,
              f"{name}: kernel launches {counts}, want 6 chains and 1 NMS per forward "
              f"({forwards} forwards)")

    fixtures = {res: np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
                for res in ("256x320", "512x640")}
    golden = {}
    rb.reset_launch_counts()
    for n_fwd, res in enumerate(("256x320", "512x640"), start=1):
        fx = fixtures[res]
        det = detector(res)
        out = det.run_raw(make_frames(fx["pre_imgs"]))
        rows = detections_to_lists(out)
        counts = dict(rb.LAUNCHES)
        matched, notes = golden_match(rows, fx["boxes"], fx["pre_imgs"].shape[0])
        golden[res] = {"matched": matched, "reference": int(fx["boxes"].shape[0]),
                       "detections": sum(len(r) for r in rows), "notes": notes[:5],
                       "launches_after": counts}
        check(counts["res_chain_rows"] == 6 * n_fwd and counts["res_chain_cf"] == 0
              and counts["nms"] == n_fwd,
              f"{res}: kernel launches {counts}, want 6 chains and 1 NMS per forward")
    main_path_launches = dict(rb.LAUNCHES)
    emit("golden", dtype="float32", results=golden, launches=main_path_launches)
    for res, g in golden.items():
        check(g["matched"] == g["reference"] and not g["notes"],
              f"golden {res}: {g['matched']}/{g['reference']} {g['notes']}")

    # ------------------------------------------ K1's path: fused_res_chain
    class CFExecutor(FoldedExecutor):
        chain_fn = staticmethod(rb.fused_res_chain)

    fx = fixtures["256x320"]
    x8 = torch.from_numpy((fx["pre_imgs"][:8].astype(np.float32)[..., None] - 128.0) / 255.0).to(dev)
    params = torch_params_from_folded(zoo["256x320"], dev)
    with torch.inference_mode(), exact_fp32():
        rb.reset_launch_counts()
        heads_cf = walk_topology(x8, CFExecutor(params))
        k1_launches = dict(rb.LAUNCHES)
        heads_rows = walk_topology(x8, FoldedExecutor(params))
    diff = max((a - b).abs().max().item() for a, b in zip(heads_cf, heads_rows))
    emit("k1_path", what="folded 256x320 forward, B=8, chains through fused_res_chain (K1)",
         launches=k1_launches, heads_max_abs_diff_vs_k2=diff)
    check(k1_launches["res_chain_cf"] == 6 and k1_launches["res_chain_rows"] == 0,
          f"K1 path launches {k1_launches}")
    # the same kernel body with another index map: the same sums in the same order
    check(diff <= 1e-5, f"K1 and K2 forwards differ by {diff}")

    # ---------------------------------------------------------------- 5 bf16
    det = detector("256x320", torch.bfloat16)
    rb.reset_launch_counts()
    rows = detections_to_lists(det.run_raw(make_frames(fx["pre_imgs"])))
    n_imgs = fx["pre_imgs"].shape[0]
    ref_counts = [int((fx["boxes"][:, 0] == b).sum()) for b in range(n_imgs)]
    agree = sum(len(rows[b]) == ref_counts[b] for b in range(n_imgs))
    emit("bf16", res="256x320", images_with_equal_count=agree, images=n_imgs,
         need=int(0.9 * n_imgs), detections=sum(len(r) for r in rows),
         reference=int(sum(ref_counts)), launches=dict(rb.LAUNCHES))
    check(agree >= int(0.9 * n_imgs), f"bf16 count rule: {agree}/{n_imgs}")
    check(rb.LAUNCHES["res_chain_rows"] == 6 and rb.LAUNCHES["nms"] == 1,
          f"bf16 launches {rb.LAUNCHES}")

    # -------------------------------------------------------------- 6 pruned
    # The JAX package records 34/34 for this checkpoint by the golden suite's
    # rule (tools/run_golden_suite.py:37-47: same class, IoU > 0.5); by the
    # +-3 px rule of tests/test_detect_parity.py:195-202 it scores 27/34 on
    # the CPU, as the port does.  The gate is the suite's rule; both print.
    det = detector("256x320", weights="pruned040_256x320")
    out, counts = counted(lambda: det.run_raw(make_frames(fx["pre_imgs"])))
    check_path("pruned", counts, 1)
    rows = detections_to_lists(out)
    n_ref = len(fx["boxes"])
    by_iou = sum(any(int(r[6]) == int(g[7]) and box_iou(r[:4], g[1:5]) > 0.5
                     for r in rows[int(g[0])]) for g in fx["boxes"])
    by_px = sum(any(int(r[6]) == int(g[7]) and max(abs(np.array(r[:4]) - g[1:5])) <= 3.0
                    for r in rows[int(g[0])]) for g in fx["boxes"])
    emit("pruned", weights="yolofastest_pruned040_256x320.npz", dtype="float32",
         recall_iou_0_5=f"{by_iou}/{n_ref}", need=">= 90% by IoU > 0.5 and class",
         recall_within_3px=f"{by_px}/{n_ref}", jax_cpu_within_3px=f"27/{n_ref}",
         detections=sum(len(r) for r in rows), launches=counts)
    check(by_iou >= 0.9 * n_ref, f"pruned recall {by_iou}/{n_ref} (IoU > 0.5)")

    # ---------------------------------------------------------------- 6b lite
    # The single-head lite zoo at both resolutions through run_raw: >= 90% of
    # the golden boxes by class and IoU > 0.5 (tests/test_lite_zoo.py:48-58).
    lite = {}
    for res in ("256x320", "512x640"):
        fxr = fixtures[res]
        det = detector(f"lite-{res}", weights=f"lite_{res}", arch="lite")
        out, counts = counted(lambda: det.run_raw(make_frames(fxr["pre_imgs"])))
        rows = detections_to_lists(out)
        found = recall_iou(rows, fxr["boxes"])
        lite[res] = {"recall_iou_0_5": f"{found}/{len(fxr['boxes'])}",
                     "detections": sum(len(r) for r in rows), "launches": counts}
        check_path(f"lite {res}", counts, 1)
        check(found >= 0.9 * len(fxr["boxes"]), f"lite {res} recall {found}/{len(fxr['boxes'])}")
    emit("lite", dtype="float32", need=">= 90% by IoU > 0.5 and class", results=lite)

    # ----------------------------------------------------------------- 6c tta
    # Flip TTA: the frames and their mirror as one doubled batch through the
    # six chains, golden recall 34/34 (class, IoU >= 0.5: tests/test_tta.py:
    # 107-115), and flip-equivariance on 4 frames (tests/test_tta.py:63-79).
    det_tta = detector("256x320", tta=True)
    out, tta_counts = counted(lambda: det_tta.run_raw(make_frames(fx["pre_imgs"])))
    rows = detections_to_lists(out)
    tta_found = recall_iou(rows, fx["boxes"], strict=False)
    x4 = torch.from_numpy((fx["pre_imgs"][:4].astype(np.float32)[..., None] - 128.0) / 255.0).to(dev)
    a = detections_to_lists(det_tta.run(x4))
    bm = detections_to_lists(det_tta.run(x4.flip(2)))
    w_net = get_config("256x320").io.input_hw[1]
    equivariant = all(
        len(ra) == len(rb_) > 0 and all(
            any(int(da[6]) == int(db[6]) and np.allclose(da[4:6], db[4:6], rtol=1e-3)
                and np.allclose(da[:4], [w_net - db[2], db[1], w_net - db[0], db[3]], atol=1.0)
                for db in rb_) for da in ra)
        for ra, rb_ in zip(a, bm))
    emit("tta", res="256x320", dtype="float32", recall_iou_0_5=f"{tta_found}/{len(fx['boxes'])}",
         flip_equivariant_on_4=equivariant, detections=sum(len(r) for r in rows),
         launches=tta_counts)
    check_path("tta", tta_counts, 1)
    check(tta_found == len(fx["boxes"]), f"TTA recall {tta_found}/{len(fx['boxes'])}")
    check(equivariant, "TTA detections of mirrored frames are not each other's mirrors")

    # -------------------------------------------------------------- 6d sliced
    # One 1024x1280 frame of four golden frames, over a 2x2 grid: the card's
    # detections equal the CPU's within 1 px, with the same classes.
    big = np.concatenate([np.concatenate(list(make_frames(fx["pre_imgs"][i:i + 2])), 1)
                          for i in (0, 2)], 0)
    det_cpu = Detector(get_config("256x320"), variables=load_variables(
        os.path.join(WEIGHTS, "yolofastest_256x320.npz")), device="cpu")
    det = detector("256x320")
    on_card, sliced_counts = counted(lambda: sliced_detect(det, big, (2, 2), 0.2))
    on_cpu = sliced_detect(det_cpu, big, (2, 2), 0.2)
    unmatched = [b.tolist() for b, c in zip(on_card["boxes"], on_card["cls_idx"])
                 if not any(int(c) == int(c2) and np.abs(b - b2).max() <= 1.0
                            for b2, c2 in zip(on_cpu["boxes"], on_cpu["cls_idx"]))]
    emit("sliced", frame=list(big.shape), grid=[2, 2], overlap=0.2, detections=on_card["count"],
         cpu_detections=on_cpu["count"], unmatched=unmatched[:5], launches=sliced_counts)
    check_path("sliced", sliced_counts, 1)
    check(on_card["count"] == on_cpu["count"] > 0 and not unmatched,
          f"sliced: {on_card['count']} detections on the card, {on_cpu['count']} on the CPU, "
          f"unmatched {unmatched[:3]}")

    # -------------------------------------------------------------- 7 timing
    class TimedExecutor(FoldedExecutor):
        """FoldedExecutor that records a CUDA event pair around every layer."""

        def __init__(self, params, dt):
            super().__init__(params, dt)
            self.marks = []

        def _timed(self, kind, fn, *a):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            y = fn(*a)
            e.record()
            self.marks.append((kind, s, e))
            return y

        def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
            kind = "conv_depthwise" if depthwise else ("conv_1x1" if kernel == 1 else "conv_3x3")
            return self._timed(kind, super().conv, x, name, kernel, stride, depthwise, act)

        def deconv2x(self, x, name):
            return self._timed("deconv", super().deconv2x, x, name)

        def res_chain(self, x, names):
            return self._timed("chain_kernel", super().res_chain, x, names)

    timing = []
    frames_all = make_frames(fx["pre_imgs"])
    for dt in (torch.float32, torch.bfloat16):
        det = detector("256x320", dt)
        for b in (1, 64):
            frames = torch.from_numpy(frames_all[np.arange(b) % n_imgs]).to(dev)
            reps = 20
            for _ in range(3):
                det.run_raw(frames)
            torch.cuda.synchronize()
            ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(reps)]
            t0 = time.perf_counter()
            for e in ev:
                e[0].record()
                x = det.preprocess(frames)
                e[1].record()
                heads = det.forward_heads(x)
                e[2].record()
                det.postprocess(heads, packed=True)
                e[3].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
            split = [float(np.mean([e[j].elapsed_time(e[j + 1]) for e in ev])) for j in range(3)]
            # per-layer device time of the forward (events around each layer)
            tex = TimedExecutor(det.params, dt)
            with torch.inference_mode(), exact_fp32():
                for _ in range(3):
                    tex.marks.clear()
                    walk_topology(det.preprocess(frames), tex)
            torch.cuda.synchronize()
            layers = {}
            for kind, s, e in tex.marks:
                layers[kind] = layers.get(kind, 0.0) + s.elapsed_time(e)
            busy_ms, busy_share = device_busy(lambda: det.run_raw(frames), 10)
            timing.append({
                "dtype": str(dt).split(".")[-1], "batch": b,
                "preprocess_ms": split[0], "forward_ms": split[1],
                "decode_nms_ms": split[2], "total_ms": sum(split),
                "wall_ms": wall, "images_per_s": b / (sum(split) / 1e3),
                "forward_layers_ms": layers, "device_busy_ms": busy_ms,
                "device_busy_share": busy_share})
    # The detect path reads nothing back to the host (the NMS is one
    # kernel), so a B=64 run_packed returns before the card is done:
    # torch's sync debug mode raises on any synchronising operation in it;
    # the host's return time is set beside the card's time for the same call;
    # and behind a 50 ms backlog on the card (torch.cuda._sleep) the call
    # returns with the card still busy, where the plain NMS, swapped in for
    # one call, waits for the backlog.
    det = detector("256x320")
    x64 = det.preprocess(torch.from_numpy(frames_all[np.arange(64) % n_imgs]).to(dev))
    for _ in range(3):
        det.run_packed(x64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        det.run_packed(x64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host_ms = []  # one call on an idle card
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.run_packed(x64)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # 20 calls back to back: the host's pace
    for _ in range(20):
        det.run_packed(x64)
    steady_ms = (time.perf_counter() - t0) * 1e3 / 20
    ev = torch.cuda.Event()
    ev.record()
    steady_busy = not ev.query()
    torch.cuda.synchronize()
    packed_cuda_ms = cuda_ms(lambda: det.run_packed(x64), 20)

    def behind_backlog():
        torch.cuda._sleep(100_000_000)  # ~50 ms of the card's clock
        t0 = time.perf_counter()
        det.run_packed(x64)
        ms = (time.perf_counter() - t0) * 1e3
        ev = torch.cuda.Event()
        ev.record()
        busy = not ev.query()
        torch.cuda.synchronize()
        return ms, busy

    kernel_return = [behind_backlog() for _ in range(3)]
    nms_kernel.nms_packed = nms_packed_plain
    try:
        plain_return = behind_backlog()
    finally:
        nms_kernel.nms_packed = nms_packed
    host_return = {
        "batch": 64, "dtype": "float32", "sync_debug_mode_error": "no synchronising operation",
        "host_return_ms_idle_card": float(np.mean(host_ms)),
        "host_ms_per_call_back_to_back": steady_ms, "cuda_ms": packed_cuda_ms,
        "card_busy_after_20_back_to_back": steady_busy,
        "behind_50ms_backlog": [{"host_return_ms": m, "card_busy_at_return": b}
                                for m, b in kernel_return],
        "plain_nms_behind_backlog": {"host_return_ms": plain_return[0],
                                     "card_busy_at_return": plain_return[1]}}
    emit("timing", res="256x320", card=card, reps=20, runs=timing, run_packed_host_return=host_return,
         device_busy="torch.profiler trace of 10 run_raw calls: union of device "
                     "intervals per call, and its share of the traced device span")
    check(all(b for _, b in kernel_return), f"run_packed waited for the card: {kernel_return}")

    # ----------------------------------------------------------- 7b streaming
    # Golden frames tiled to B=64, 8 batches, depth 1, 2 and 4, sync and
    # threaded: every packed result equals Detector.run_packed on the same
    # batch; images/s over the run, and the card's busy share from a
    # torch.profiler trace of a second run.
    det = detector("256x320")
    pre = fx["pre_imgs"]
    batches = [pre[(np.arange(64) + 7 * k) % n_imgs].copy() for k in range(8)]
    want = []
    for frames in batches:
        want.append(det.run_packed(normalize(torch.from_numpy(frames).to(dev))[..., None]).cpu().numpy())
    streaming = []
    for threaded in (False, True):
        for depth in (1, 2, 4):
            sd = StreamingDetector.over(det, depth=depth, threaded=threaded)
            list(sd(iter(batches[:2])))  # warm the pinned buffers and the streams
            torch.cuda.synchronize()
            got, counts = counted(lambda: list(sd(iter(batches))))
            t0 = time.perf_counter()
            list(sd(iter(batches)))
            wall = time.perf_counter() - t0
            busy_ms, busy_share = device_busy(lambda: list(sd(iter(batches))), 1)
            equal = len(got) == len(batches) and all(
                np.array_equal(g["boxes"], w[..., 0:4]) and np.array_equal(g["conf"], w[..., 4])
                and np.array_equal(g["cls_idx"], w[..., 6].astype(np.int32))
                and np.array_equal(g["valid"], w[..., 7] > 0.5) for g, w in zip(got, want))
            streaming.append({"depth": depth, "threaded": threaded,
                              "images_per_s": 64 * len(batches) / wall, "wall_ms": wall * 1e3,
                              "device_busy_ms": busy_ms, "device_busy_share": busy_share,
                              "equal_to_run_packed": equal, "launches": counts})
            check_path(f"streaming depth {depth} threaded={threaded}", counts, len(batches))
            check(equal, f"streaming depth {depth} threaded={threaded}: results differ from "
                         "Detector.run_packed")
    emit("streaming", res="256x320", dtype="float32", batch=64, batches=len(batches), card=card,
         runs=streaming, device_busy="torch.profiler trace of one 8-batch run")

    # -------------------------------------------------------------- 7c serve
    # A DynamicBatcher (max_batch 8, window 5 ms) under 32 client threads of
    # 20 requests each: every reply equals Detector.run on that frame alone
    # (fp32 sums in another order: rtol 1e-5, atol 1e-4).  Then one
    # DetectionServer round trip on 127.0.0.1.
    import threading
    import urllib.request

    import cv2

    nets = (pre.astype(np.float32)[..., None] - 128.0) / 255.0
    expect = [detections_to_lists(det.run(nets[i:i + 1]))[0] for i in range(n_imgs)]
    batcher = DynamicBatcher(make_batch_fn(det), det.config.io.input_hw, max_batch=8,
                             window_ms=5.0)
    replies, errors = {}, []

    def client(c):
        try:
            for r in range(20):
                i = (7 * c + r) % n_imgs
                replies[(c, r)] = (i, batcher.submit(nets[i]))
        except BaseException as e:  # reported by the check below
            errors.append(repr(e))

    try:
        def serve_all():
            threads = [threading.Thread(target=client, args=(c,)) for c in range(32)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            return time.perf_counter() - t0

        serve_wall, serve_counts = counted(serve_all)
        snap = batcher.snapshot()
        wrong = [k for k, (i, rows) in replies.items() if not rows_close(rows, expect[i])]
        frame = make_frames(pre[:1])[0]
        body = cv2.imencode(".png", frame)[1].tobytes()
        want_http = detections_to_lists(det.run(image_to_net_input(frame, det.config.io)[None]))[0]
        server = DetectionServer(batcher, det.config, port=0)
        server.start()
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}/detect", data=body,
                                         method="POST")
            reply = json.load(urllib.request.urlopen(req, timeout=60))
            health = json.load(urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=60))
        finally:
            server.httpd.shutdown()
            server.httpd.server_close()
    finally:
        batcher.close()
    http_rows = [d["box_net"] + [d["conf"], d["cls_score"], d["cls"]] for d in reply["detections"]]
    emit("serve", clients=32, requests_each=20, max_batch=8, window_ms=5.0, card=card,
         requests_per_s=len(replies) / serve_wall, wall_s=serve_wall,
         latency_ms=snap.get("latency_ms"), batches=snap["batches"],
         batch_fill=snap["batch_fill"], errors=errors[:3], wrong_replies=len(wrong),
         launches=serve_counts,
         http={"status": health["status"], "count": reply["count"], "server_ms": reply["ms"],
               "equal_to_run": rows_close(http_rows, want_http)})
    check(not errors and len(replies) == 640 and not wrong,
          f"serve: {len(replies)} replies, {len(wrong)} wrong, errors {errors[:3]}")
    check_path("serve", serve_counts, snap["batches"])
    check(rows_close(http_rows, want_http) and reply["count"] >= 1,
          f"HTTP reply {http_rows} vs Detector.run {want_http}")

    # -------------------------------------------------------------- 7d video
    # A 64-frame synthetic video (8 golden frames, each held for 8 frames,
    # MJPG) through detect_video with the IoU tracker.
    import tempfile

    with tempfile.TemporaryDirectory(prefix="yf_video_") as td:
        src = os.path.join(td, "golden.avi")
        writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (640, 512))
        check(writer.isOpened(), "cannot open a cv2.VideoWriter for the synthetic video")
        for i in range(64):
            writer.write(frames_all[(i // 8) % n_imgs])
        writer.release()
        stats, video_counts = counted(lambda: detect_video(
            det, det.config, src, os.path.join(td, "out.avi"), batch_size=8, depth=2,
            tracker=IoUTracker()))
        written = cv2.VideoCapture(os.path.join(td, "out.avi"))
        n_written = int(written.get(cv2.CAP_PROP_FRAME_COUNT))
        written.release()
    stats.pop("out")
    emit("video", card=card, frames_written=n_written, launches=video_counts, **stats)
    check(stats["frames"] == n_written == 64 and stats["tracks"] >= 1,
          f"video: {stats['frames']} frames, {n_written} written, {stats.get('tracks')} tracks")
    # the warm-up batch, then 8 batches of 8 frames
    check_path("video", video_counts, 9)

    # ------------------------------------------------------- 8 kernel timing
    kt = []
    sums = {}
    folded = zoo["256x320"]
    for b in (1, 64):
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            tot = {"rows_ms": 0.0, "cf_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "ops_bound_ms": 0.0, "bytes_bound_ms": 0.0}
            for names, (h, w) in zip(RES_CHAINS, chain_planes((256, 320))):
                st = [torch.from_numpy(a).to(dev)
                      for a in rb.chain_weights_from_folded(folded, names)]
                k, c, i = st[0].shape
                x = torch.from_numpy((rng.standard_normal((b, h, w, c)) * 0.5).astype(
                    np.float32)).to(dev, dt)
                x_rows, x_cf = x.reshape(-1, c), x.permute(3, 0, 1, 2).reshape(c, -1).contiguous()
                wprep = rb._prepare(x_rows, c, x_rows.shape[0], (h, w), st)
                rows_ms = cuda_ms(lambda: rb.fused_res_chain_rows(x_rows, *wprep, (h, w)), 20)
                cf_ms = cuda_ms(lambda: rb.fused_res_chain_cf(x_cf, *wprep, (h, w)), 20)
                plain_ms = cuda_ms(lambda: rb.res_chain_rows_plain(x_rows, *wprep, (h, w)), 10)
                bound, by = chain_bound(b, h, w, c, i, k, dname)
                kt.append({"chain": names[0], "dtype": dname, "B": b, "H": h, "W": w, "C": c,
                           "I": i, "K": k,
                           "tile_chunk_cluster": list(
                               rb.pick_tile(h, w, c, i, k, b, n_sm, x.element_size())),
                           "rows_ms": rows_ms, "cf_ms": cf_ms, "plain_ms": plain_ms,
                           "bound_ms": bound, "bound_by": by,
                           "rows_share_of_bound": bound / rows_ms})
                tot["rows_ms"] += rows_ms
                tot["cf_ms"] += cf_ms
                tot["plain_ms"] += plain_ms
                tot["bound_ms"] += bound
                tot["ops_bound_ms" if by == "operations" else "bytes_bound_ms"] += bound
            tot["rows_share_of_bound"] = tot["bound_ms"] / tot["rows_ms"]
            sums[f"{dname}/B{b}"] = tot
    # The NMS kernel on the golden frames' candidates (K = 128, decode's
    # strided views; TTA's 256, gathered) tiled to B=1 and B=64: its device
    # time per launch from the profiler, the same launches queued behind a
    # backlog, and the back-to-back events time of earlier PRs, which is the
    # host's pace through the wrapper; the plain version on the card; the
    # bound from this data.  Then the NMS stage, batched_nms(packed=True):
    # the kernels one call runs (between two markers), its device time per
    # call and the host's dispatch time per call.
    nms_timing = []
    for name in ("golden_256x320", "golden_256x320_tta"):
        (boxes, conf, score, cls_idx, valid), io = nms_sets[name]
        for b in (1, 64):
            args = tile_candidates(boxes, conf, score, cls_idx, valid, b)

            def kernel():
                return nms_packed(*args, io.nms_thre, io.max_det)

            def stage():
                return nms_ops.batched_nms(*args, iou_thre=io.nms_thre, max_det=io.max_det,
                                           packed=True)

            for _ in range(3):
                kernel()
            device_ms, per_call = kernel_device_ms(kernel, 20, "nms")
            events_ms = cuda_ms(kernel, 20)
            plain_ms = cuda_ms(lambda: nms_packed_plain(*args, io.nms_thre, io.max_det), 5)
            bound, by, pairs = nms_bound(args[4], kernel()[1], io.max_det)
            stage_busy_ms, _ = device_busy(stage, 20)
            nms_timing.append({
                "candidates": name, "B": b, "K": int(valid.shape[1]), "max_det": io.max_det,
                "box_strides": list(args[0].stride()), "device_ms": device_ms,
                "kernels_per_call": per_call, "queued_ms": queued_ms(kernel, 20),
                "events_ms_host_pace": events_ms, "host_ms": dispatch_ms(kernel, 20),
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "iou_pairs": pairs,
                "share_of_bound": bound / device_ms if device_ms else None,
                "stage": {"kernels_in_5_calls": stage_kernels(stage),
                          "device_ms": stage_busy_ms, "host_ms": dispatch_ms(stage, 20)}})
    emit("kernel_timing", card=card, res="256x320", n_sm=n_sm, library_ms=None,
         library_note="no single PyTorch call computes a res chain or the greedy NMS",
         chains=kt, sums=sums, nms=nms_timing,
         nms_note="device_ms: torch.profiler kernel duration per launch; queued_ms: events "
                  "around launches queued behind a backlog; events_ms_host_pace: events "
                  "around back-to-back calls, the host's pace; host_ms: host clock per call")
    for t in nms_timing:  # the NMS kernel alone runs in the stage
        seen = t["stage"]["kernels_in_5_calls"]
        check(t["device_ms"] is not None and 0 < len(seen) <= 5
              and all("nms_packed" in name for name in seen),
              f"the NMS stage runs another kernel than the NMS kernel: {t}")

    # ------------------------------------------------------- training path
    train_path(card, counted)

    # ------------------------------------------------------- kernels summary
    f32 = sums["float32/B64"]
    by = "operations" if f32["ops_bound_ms"] >= f32["bytes_bound_ms"] else "bytes"
    at = "sum over the six chains of one 256x320 forward, B=64, float32"
    summary = []
    for name, replaces, key, launches, ms in (
            ("res_chain_cf", "yolofastest_tpu/kernels/res_block.py:41", "cf",
             k1_launches["res_chain_cf"], f32["cf_ms"]),
            ("res_chain_rows", "yolofastest_tpu/kernels/res_block.py:172", "rows",
             main_path_launches["res_chain_rows"], f32["rows_ms"])):
        summary.append({
            "name": name, "route": "cuda", "source": K1_SOURCE, "replaces": replaces,
            "launches": launches, "max_abs_err": worst[(key, "float32")],
            "max_abs_err_bf16": worst[(key, "bfloat16")],
            "ms": ms, "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": by, "library_ms": None, "at": at})
    nms64 = next(t for t in nms_timing if t["candidates"] == "golden_256x320" and t["B"] == 64)
    summary.append({
        "name": "nms_packed", "route": "cuda", "source": NMS_SOURCE,
        "replaces": "yolofastest_tpu/ops/nms.py:49 (batched_nms: an XLA fori_loop, a stable "
                    "argsort and a gather; no Pallas kernel)",
        "launches": main_path_launches["nms"], "max_abs_err": 0.0 if mismatched == 0 else 1.0,
        "mismatches": mismatched, "ms": nms64["device_ms"],
        "events_ms_host_pace": nms64["events_ms_host_pace"], "plain_ms": nms64["plain_ms"],
        "bound_ms": nms64["bound_ms"], "bound_by": nms64["bound_by"], "library_ms": None,
        "at": "golden 256x320 candidates tiled to B=64, K=128, max_det 64; ms from the profiler"})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
