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
trained checkpoint deployed), export and the int8 backends.  Phases print
one JSON line each, in order: device (after the raw ``nvidia-smi`` line),
build, kernels, nms_kernel (the NMS kernel's packed rows and keep mask bit
for bit against its plain version), golden (the main path, whose kernel
launches are counted), k1_path (the folded forward with its chains through
the channels-first kernel), bf16, pruned, lite, tta, sliced, timing (with
the host return of a B=64 ``run_packed``), streaming, serve, video, kernel_timing (the chains; the NMS
kernel's device time from the profiler beside its back-to-back events time,
which is the host's pace, and the NMS stage's kernels, device and host time
per call), train (fit, overfit, card against CPU in float64 and fp32,
restore, and the step's timing at B=16 and B=64, fp32 and bf16, split by
its profiler spans), eval, distill, deploy_trained, export (the ``export``
command's files imported back through the Detector, ``model.pt`` on the
card, ``detect`` on a checkpoint directory), programs (the ``.pt2``
programs of ``export --calib-data --device cuda`` loaded here and in a
fresh process that imports only ``yolofastest_torch.kernels``: golden
34/34 with 6 chain and 1 NMS launches a call, the folded and int8 heads
against the Detector's, B=1 and B=64 times beside ``run_packed``, the host
cost of the chain operator's dispatch, and the generic ONNX exporter's file
of the card-traced forward), mlir (the StableHLO text of those programs,
and of a 512x640 detect program, run on the host CPU by the unchanged C++
consumer ``yf_shlo`` built from the checkout: forward.mlir against the
kernel-run folded forward within 2e-4, detect.mlir golden 34/34, and at
512x640 equal to ``detect.pt2`` on the card; its host ms beside the host
CPU), int8 (the shipped int8
artifacts through both int8 backends: golden recall, rows and heads against
the CPU port, every layer's integer accumulators against exact int64 ones,
calibration on the card against the CPU with a cache written and read,
launches, and both backends timed beside fp32), quant2 (the sensitivity
sweep, timed, and against the CPU port's, QAT steps card against CPU in float64 and
fp32 with the teacher's chain launches and the steps/s, and ``export
--calib-data --qat-steps --device cuda``'s int8 files), recipes (the
deployment matrix of ``tools/run_golden_suite.py`` at both sizes, every
row's golden recall against ``docs/golden_suite_summary.json``'s, with ms
per image and launches; the 512x640 int8 recipe against the committed
artifact; the pruned hybrid keep-fp search against the committed set; the
recall-selected QAT search with ``tools/make_int8_zoo.py``'s shipped flags,
a shipped snapshot loaded back through the int8 backends), native (the C++
engine of ``cpp/`` on the host CPU, found or built from the checkout's
sources: fp32 at both sizes against the fp Detector on the card and timed
beside its B=1 latency, with the host CPU's model; ``native-int8`` from the
three shipped artifacts; ``native-int8`` calibrated on the card; ``detect``,
``serve``, ``video`` and ``eval`` with ``--backend native``, none of which
launches a CUDA kernel), finetune (the pseudo-GT fine-tune set of
``tools/torch_make_finetune_set.py``; two runs of the train step, fp32 and
bf16, and of QAT from one state, bit for bit; the prune040 recipe at full
depth through the ``prune`` and ``train`` commands with its golden recall;
the full-scale recipe from random init, cut to 200 steps; the lite-512 zoo
on the 512x640 val set through the fp Detector and the native engine),
demos (short forms of ``tools/torch_run_train_demos.py``'s demos through
the ``train`` command: ``--freeze backbone`` with the pinned modules bit
for bit, ``--multiscale`` with the bucket of every batch against the
loader's, ``--resume latest`` against the uninterrupted run bit for bit,
the distillation arms from one init with the teacher's chain launches, and
the lite architecture at 512x640 from its seed with a validation),
parallel (data parallelism over a process group:
two spawned gloo ranks on the one card, each with half of a global batch of
16, float64 steps equal to one process to 1e-9, fp32 distillation steps
with the teacher's chain launches on each rank, save and resume bit for
bit, steps/s beside one process; a one-rank NCCL group), spatial (the
mesh's spatial axis: four gloo ranks on a (2, 2) mesh and two on (1, 2),
image rows split with halo exchanges: the sharded detect pipeline at
512x640 and 256x320 against one process and the golden boxes, with its
chain launches and halo exchanges on each rank; the chain kernel on every
row-shard plane against its plain version and timed beside the whole
plane; float64 and fp32 distillation steps with ``shard_spatial=True``
against the parallel phase's one process; the four-process dry run;
images/s and steps/s), profile
(``utils.profiling.trace`` around a ``run_raw`` and a train step, its
kernel events against the launch counts, and a ``SectionTimer`` report);
then the ``{"kernels": [...]}`` summary, and last ``{"ok": true, "device":
{...}}``.  Every path resets the kernel launch
counts before it runs and checks them after.

Any failed check raises, so the script exits non-zero and prints no ok line;
without a CUDA card it exits 2 at once.  It imports nothing of JAX.  The
frames are built with numpy from ``tests/fixtures``; cv2 encodes the HTTP
request's image, writes the synthetic video and the synthetic VOC set the
training path reads (in a temporary directory).  The parallel phase's two
ranks are spawned processes; the script joins (or kills) both before it
goes on; so does the spatial phase with its six ranks and the dry run's
four processes.
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
# The parallel phase's fp32 runs: a value outside the train phase's fp32
# rule may be at most this many times as far from one process on the card
# as that process is from one on the CPU over the same steps.
FP32_NOISE_SLACK = 2.0
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


def stage_times(det, frames, reps: int = 20) -> dict:
    """One Detector on one batch of uint8 frames on the card, as the timing
    phase measures it: CUDA events around preprocess, forward and
    decode+NMS of ``reps`` calls (after 3 warm ones), whose sum is the
    latency and gives images/s; the host's wall ms per call; the card's busy
    ms per ``run_raw`` call and busy share from a profiler trace of 10; and
    the device operations of one call in a trace of its own."""
    import torch
    from torch_timing import device_busy, device_events

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
    busy_ms, busy_share = device_busy(lambda: det.run_raw(frames), 10)
    return {"preprocess_ms": split[0], "forward_ms": split[1], "decode_nms_ms": split[2],
            "total_ms": sum(split), "wall_ms": wall,
            "images_per_s": frames.shape[0] / (sum(split) / 1e3),
            "device_busy_ms": busy_ms, "device_busy_share": busy_share,
            "device_ops_per_call": len(device_events(lambda: det.run_raw(frames), 1))}


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

        # a restored step equals the uninterrupted one (the step is
        # deterministic on its own)
        batch = next(iter(loader))
        fresh = Trainer(cfg, batch_per_epoch=len(loader), seed=1, device="cuda")
        fresh.restore_checkpoint(os.path.join(ckdir, "epoch_1"))
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


def export_path(card, counted) -> dict:
    """The export phase on the card: the ``export`` command on the 256x320
    zoo; ``model.onnx``, ``model.param``/``.bin`` and a reference-layout
    ``.pth`` (written here from the zoo) imported, each through the folded
    Detector on the golden frames (34/34; 6 K2 and 1 NMS launch a forward);
    ``model.pt`` on the card against the folded forward over the chain
    kernel; ``detect --weights <epoch dir> --fold-bn``.  One JSON line;
    returns the launch counts of each run."""
    import contextlib
    import io
    import tempfile

    import cv2
    import torch

    from yolofastest_torch.cli import main as cli_main
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.export import import_ncnn, import_onnx
    from yolofastest_torch.inference import Detector, detections_to_lists
    from yolofastest_torch.models import (fold_batchnorm, folded_apply, load_variables,
                                          torch_params_from_folded, unfold_to_variables)
    from yolofastest_torch.models.torch_io import (load_torch_checkpoint,
                                                   variables_to_torch_state_dict)
    from yolofastest_torch.train import Trainer
    from yolofastest_torch.utils.device import exact_fp32

    t0 = time.perf_counter()
    cfg = get_config("256x320")
    zoo_file = os.path.join(WEIGHTS, "yolofastest_256x320.npz")
    zoo = load_variables(zoo_file)
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    frames = make_frames(fx["pre_imgs"])
    n_img = int(fx["pre_imgs"].shape[0])
    counts = {}
    with tempfile.TemporaryDirectory(prefix="yf_export_") as tmp:
        out = os.path.join(tmp, "export")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["export", "--weights", zoo_file, "--out", out])
        check(rc == 0, f"export exited {rc}")
        sizes = {f: os.path.getsize(os.path.join(out, f)) for f in sorted(os.listdir(out))}
        pth = os.path.join(tmp, "ref.pth")
        torch.save(variables_to_torch_state_dict(zoo), pth)
        trees = {"model.onnx": import_onnx(os.path.join(out, "model.onnx"))[0],
                 "model.param": unfold_to_variables(
                     import_ncnn(os.path.join(out, "model.param"))[0]),
                 "ref.pth": load_torch_checkpoint(pth)}
        golden = {}
        for name, variables in trees.items():
            det = Detector(cfg, variables=variables, device="cuda")
            got, counts[name] = counted(lambda: det.run_raw(frames))
            matched, notes = golden_match(detections_to_lists(got), fx["boxes"], n_img)
            golden[name] = {"matched": matched, "reference": int(fx["boxes"].shape[0]),
                            "notes": notes[:5], "launches": counts[name]}

        # model.pt (traced at B=1 on the host) on the card, fp32 without TF32,
        # against the folded forward whose chains are the kernel
        x = torch.from_numpy((fx["pre_imgs"].astype(np.float32)[:, None] - 128.0)
                             / 255.0).cuda()
        scripted = torch.jit.load(os.path.join(out, "model.pt"), map_location="cuda")
        params = torch_params_from_folded(fold_batchnorm(zoo), "cuda")
        with torch.no_grad(), exact_fp32():
            ts_heads = scripted(x)
            ref_heads, counts["folded_forward"] = counted(
                lambda: folded_apply(params, x.permute(0, 2, 3, 1)))
        ts_ratio = max(fp32_ratio(a.permute(0, 2, 3, 1), b) for a, b in zip(ts_heads, ref_heads))
        ts_err = max(float((a.permute(0, 2, 3, 1) - b).abs().max())
                     for a, b in zip(ts_heads, ref_heads))

        # detect --weights <a port checkpoint directory> (BN folded: the kernels)
        ck = Trainer(cfg, batch_per_epoch=1, variables=zoo, device="cuda").save_checkpoint(
            os.path.join(tmp, "ck"), 1)
        data, dout = os.path.join(tmp, "data"), os.path.join(tmp, "detect")
        os.makedirs(data)
        for i, frame in enumerate(frames[:2]):
            cv2.imwrite(os.path.join(data, f"g{i}.jpg"), frame)
        rc, counts["detect"] = counted(lambda: cli_main(
            ["detect", "--weights", ck, "--data", data, "--out", dout, "--fold-bn",
             "--device", "cuda"]))
        detect_files = sorted(os.listdir(dout))
    emit("export", card=card, res="256x320", files=sizes, golden=golden,
         torchscript={"heads_max_abs_err": ts_err, "ratio_to_tolerance": ts_ratio,
                      "tolerance": f"{FP32_TOL} rel+abs of the folded forward (chain "
                                   "kernel), fp32 without TF32",
                      "launches_of_the_folded_forward": counts["folded_forward"]},
         detect_epoch_dir={"rc": rc, "files": detect_files, "launches": counts["detect"]},
         seconds=time.perf_counter() - t0)
    for name, g in golden.items():
        check(g["matched"] == g["reference"] and not g["notes"],
              f"export: golden from {name}: {g['matched']}/{g['reference']} {g['notes']}")
        check(g["launches"]["res_chain_rows"] == 6 and g["launches"]["nms"] == 1
              and g["launches"]["res_chain_cf"] == 0,
              f"export: {name} launches {g['launches']}, want 6 chains and 1 NMS")
    check(ts_ratio <= 1.0, f"model.pt heads off the folded forward: {ts_ratio} x tolerance")
    check(counts["folded_forward"]["res_chain_rows"] == 6,
          f"folded forward launches {counts['folded_forward']}")
    c = counts["detect"]
    check(rc == 0 and detect_files == ["detect_info.log", "result_g0.jpg", "result_g1.jpg"],
          f"detect --weights <epoch dir>: rc {rc}, files {detect_files}")
    check(c["nms"] == 3 and c["res_chain_rows"] == 6 * c["nms"],
          f"detect --weights <epoch dir> launches {c}: want a warm-up and 2 images, "
          "6 chains and 1 NMS each")
    return counts


# The programs phase's fresh process: the three .pt2 files of the export
# command, with only the kernels' package imported (their operators).
PROGRAM_CONSUMER = r"""
import json, os, sys
import numpy as np
import torch
from yolofastest_torch import kernels

out, tmp = sys.argv[1:]
torch.backends.cudnn.allow_tf32 = False
frames = torch.from_numpy(np.load(os.path.join(tmp, "frames.npy"))).cuda()
x = torch.from_numpy(np.load(os.path.join(tmp, "x.npy"))).cuda()
res, launches = {}, []
with torch.no_grad():
    detect = torch.export.load(os.path.join(out, "detect.pt2")).module()
    for i in range(frames.shape[0]):
        kernels.reset_launch_counts()
        d = detect(frames[i:i + 1])
        torch.cuda.synchronize()
        launches.append(dict(kernels.LAUNCHES))
        for k, v in d.items():
            res.setdefault("detect/" + k, []).append(v.cpu().numpy())
    for name in ("forward", "forward_int8"):
        m = torch.export.load(os.path.join(out, name + ".pt2")).module()
        for i in range(x.shape[0]):
            for j, h in enumerate(m(x[i:i + 1])):
                res.setdefault(name + "/" + str(j), []).append(h.cpu().numpy())
np.savez(os.path.join(tmp, "consumer.npz"), **{k: np.concatenate(v) for k, v in res.items()})
prefixes = ("yolofastest_torch.models", "yolofastest_torch.inference", "yolofastest_torch.export",
            "yolofastest_torch.quant", "yolofastest_torch.train", "yolofastest_tpu", "jax", "flax")
print(json.dumps({"launches": launches,
                  "model_modules": sorted(m for m in sys.modules if m.startswith(prefixes))}))
"""


class _StampedOut:
    """A stdout that keeps the host time at which each line ends, so that
    the export command's seconds a file are the time between its ``wrote``
    lines."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, text):
        now = time.perf_counter()
        *done, self._part = (self._part + text).split("\n")
        self.lines += [(now, line) for line in done]
        return len(text)

    def flush(self):
        pass

    def seconds_per_file(self, start):
        last, out = start, {}
        for t, line in self.lines:
            if line.startswith("wrote "):
                out[os.path.basename(line.split()[1])] = t - last
                last = t
        return out


def _host_ms(fn, reps: int) -> float:
    """Median host ms of one call with its result on the host, on an idle
    card."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _images_per_s(fn, batch: int, reps: int) -> float:
    """``reps`` calls back to back and one synchronise: images a second."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return batch * reps / (time.perf_counter() - t0)


def _host_us_per_call(fn, reps: int = 200) -> float:
    """Host microseconds a call of ``reps`` back-to-back calls, before the
    card is waited for: the time to dispatch and launch."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def programs_path(card, counted, mlir_dir) -> dict:
    """The programs phase on the card: ``export --calib-data <8 golden
    frames> --device cuda`` on the 256x320 zoo (the seconds of each ``.pt2``
    from its ``wrote`` lines); ``forward.pt2``, ``detect.pt2`` and
    ``forward_int8.pt2`` (B=1) loaded here (``load_exported``) and in a fresh
    process that imports only ``yolofastest_torch.kernels``: detect.pt2 on
    the 20 golden frames one at a time (34/34 by the strict rule; 6 K2 and 1
    NMS launches a call), forward.pt2 within FP32_TOL of the folded forward
    over the chain kernel (fp32 without TF32; 6 K2 a call), forward_int8.pt2
    equal to ``Detector(backend="int8")``'s heads with the same calibration;
    a B=64 detect program exported, saved and loaded, its rows against the
    B=1 program's, its B=1 latency and B=64 images/s beside
    ``Detector.run_packed``'s; the host time of a K2 call through its
    registered operator beside the ctypes launch it wraps; and
    ``export_torch_onnx`` of the folded forward traced with CUDA tensors (the
    chain operator inlined through its plain version), run by
    tools/onnx_check.py, within 2e-4 of the kernel-run heads.  The
    command's ``forward.mlir`` and ``detect.mlir`` are copied into
    ``mlir_dir`` for the mlir phase.  One JSON line; returns the launch
    counts."""
    import contextlib
    import shutil
    import tempfile

    import cv2
    import torch

    from yolofastest_torch.cli import main as cli_main
    from yolofastest_torch.cli._common import load_calibration
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.export import (export_detect_pipeline, export_torch_onnx,
                                          load_exported, save_exported)
    from yolofastest_torch.inference import Detector, detections_to_lists
    from yolofastest_torch.kernels import res_block as rb
    from yolofastest_torch.models import (RES_CHAINS, fold_batchnorm, folded_apply,
                                          load_variables, torch_params_from_folded)
    from yolofastest_torch.ops import normalize
    from yolofastest_torch.utils.device import exact_fp32

    t0 = time.perf_counter()
    cfg = get_config("256x320")
    zoo_file = os.path.join(WEIGHTS, "yolofastest_256x320.npz")
    zoo = load_variables(zoo_file)
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    pre = fx["pre_imgs"]
    n_img = int(pre.shape[0])
    frames = torch.from_numpy(pre).cuda()  # (N, H, W) uint8 gray: the detect program's input
    x = normalize(frames[:4])[..., None]  # the forward programs' input
    counts = {}
    with tempfile.TemporaryDirectory(prefix="yf_programs_") as tmp, contextlib.ExitStack() as stack:
        calib, out = os.path.join(tmp, "calib"), os.path.join(tmp, "out")
        os.makedirs(calib)
        for i, frame in enumerate(make_frames(pre[:8])):
            cv2.imwrite(os.path.join(calib, f"g{i}.jpg"), frame)
        stamped = _StampedOut()
        c0 = time.perf_counter()
        saved_stdout, sys.stdout = sys.stdout, stamped
        try:
            rc, counts["export"] = counted(lambda: cli_main(
                ["export", "--weights", zoo_file, "--out", out, "--calib-data", calib,
                 "--device", "cuda"]))
        finally:
            sys.stdout = saved_stdout
        export_s = time.perf_counter() - c0
        per_file = stamped.seconds_per_file(c0)
        files = sorted(os.listdir(out))
        check(rc == 0 and {"forward.pt2", "detect.pt2", "forward_int8.pt2", "forward.mlir",
                           "detect.mlir"} <= set(files) and "forward_int8.mlir" not in files,
              f"programs: export rc {rc}, files {files}")
        for name in ("forward.mlir", "detect.mlir"):
            shutil.copy(os.path.join(out, name), os.path.join(mlir_dir, name))
        # the same three files in a fresh process with only the kernels' package
        np.save(os.path.join(tmp, "frames.npy"), pre)
        np.save(os.path.join(tmp, "x.npy"), x.cpu().numpy())
        child_t0 = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", PROGRAM_CONSUMER, out, tmp], cwd=ROOT,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        stack.callback(lambda: child.poll() is None and (child.kill(), child.communicate()))

        load_s, programs = {}, {}
        for name in ("forward", "detect", "forward_int8"):
            c1 = time.perf_counter()
            programs[name] = load_exported(os.path.join(out, f"{name}.pt2"))
            load_s[name] = time.perf_counter() - c1

        # detect.pt2 (B=1) on every golden frame
        outs, detect_counts = [], []
        for i in range(n_img):
            d, c = counted(lambda: programs["detect"].call(frames[i:i + 1]))
            outs.append(d)
            detect_counts.append(c)
        rows = [r for d in outs for r in detections_to_lists(d)]
        matched, notes = golden_match(rows, fx["boxes"], n_img)

        # forward.pt2 against the folded forward over the chain kernel
        params = torch_params_from_folded(fold_batchnorm(zoo), "cuda")
        with torch.no_grad(), exact_fp32():
            ref, counts["folded_forward"] = counted(lambda: folded_apply(params, x))
        fwd, fwd_counts = [], []
        for i in range(x.shape[0]):
            heads, c = counted(lambda: programs["forward"].call(x[i:i + 1]))
            fwd.append(heads)
            fwd_counts.append(c)
        fwd_ratio = max(fp32_ratio(h, r[i:i + 1]) for i, heads in enumerate(fwd)
                        for h, r in zip(heads, ref))
        fwd_err = max(float((h - r[i:i + 1]).abs().max()) for i, heads in enumerate(fwd)
                      for h, r in zip(heads, ref))

        # forward_int8.pt2 against the int8 Detector with the command's calibration
        det8 = Detector(cfg, zoo, backend="int8", calibration=load_calibration(calib, cfg.io),
                        device="cuda")
        int8_equal, int8_counts = True, []
        for i in range(x.shape[0]):
            heads, c = counted(lambda: programs["forward_int8"].call(x[i:i + 1]))
            int8_counts.append(c)
            want = det8.forward_heads(x[i:i + 1])
            int8_equal &= all(torch.equal(a, b) for a, b in zip(heads, want))

        # the generic ONNX exporter on the folded forward traced with CUDA tensors
        x2 = x[:2]
        c1 = time.perf_counter()
        onnx_path = export_torch_onnx(lambda v: folded_apply(params, v), (x2,),
                                      os.path.join(tmp, "folded.onnx"))
        onnx_s = time.perf_counter() - c1
        np.save(os.path.join(tmp, "x2.npy"), x2.cpu().numpy())
        onnx = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "onnx_check.py"),
                               onnx_path, os.path.join(tmp, "x2.npy"),
                               os.path.join(tmp, "y2.npz")], capture_output=True, text=True,
                              timeout=600)
        onnx_err = None
        if onnx.returncode == 0:
            with np.load(os.path.join(tmp, "y2.npz")) as y:
                onnx_err = max(float(np.abs(y[f"output_{j}"] - ref[j][:2].cpu().numpy()).max())
                               for j in range(2))
        # the fresh process, started after the export, read here (it overlaps the
        # checks above; the times below are taken after it ended)
        child_out, child_err = child.communicate(timeout=600)
        child_s = time.perf_counter() - child_t0
        check(child.returncode == 0, f"programs: fresh process exited {child.returncode}: "
                                     f"{child_err[-2000:]}")
        child_report = json.loads(child_out.strip().splitlines()[-1])
        got = np.load(os.path.join(tmp, "consumer.npz"))
        child_det = {k[len("detect/"):]: got[k] for k in got.files if k.startswith("detect/")}
        child_rows = detections_to_lists(child_det)
        child_matched, child_notes = golden_match(child_rows, fx["boxes"], n_img)
        child_rows_equal = all(rows_close(a, b) for a, b in zip(child_rows, rows))
        child_fwd_ratio = max(
            fp32_ratio(torch.from_numpy(got[f"forward/{j}"][i:i + 1]), fwd[i][j].cpu())
            for i in range(x.shape[0]) for j in range(2))
        child_int8_equal = all(
            np.array_equal(got[f"forward_int8/{j}"][i:i + 1], programs["forward_int8"].call(
                x[i:i + 1])[j].cpu().numpy()) for i in range(x.shape[0]) for j in range(2))

        # the host cost of the operator: K2 through ``yolofastest::res_chain_rows``
        # beside the ctypes launch it wraps, on the res1 plane at B=1
        (h1, w1), = chain_planes(cfg.io.input_hw)[:1]
        chain_w = params["chains"][RES_CHAINS[0]]
        x_rows = torch.zeros((h1 * w1, chain_w[0].shape[1]), device="cuda")
        chain_w = rb._prepare(x_rows, x_rows.shape[1], x_rows.shape[0], (h1, w1), chain_w)
        dispatch = {"op_us": [], "ctypes_us": []}
        for _ in range(3):
            dispatch["op_us"].append(_host_us_per_call(
                lambda: rb.CHAIN_OPS[True](x_rows, *chain_w, h1, w1)))
            dispatch["ctypes_us"].append(_host_us_per_call(
                lambda: rb._launch(True, x_rows, *chain_w, (h1, w1))))

        # a B=64 detect program beside Detector.run_packed
        c1 = time.perf_counter()
        p64 = export_detect_pipeline(zoo, cfg, batch=64, device="cuda")
        export64_s = time.perf_counter() - c1
        save_exported(p64, os.path.join(tmp, "detect64.pt2"))
        c1 = time.perf_counter()
        p64 = load_exported(os.path.join(tmp, "detect64.pt2"))
        load64_s = time.perf_counter() - c1
        frames64 = frames[torch.arange(64) % n_img]
        d64, counts["detect64"] = counted(lambda: p64.call(frames64))
        rows64 = detections_to_lists(d64)[:n_img]
        rows64_equal = all(rows_close(a, b) for a, b in zip(rows64, rows))
        det = Detector(cfg, zoo, device="cuda")
        det.warmup(1)
        det.warmup(64)
        timing = {}
        for _ in range(2):  # program, Detector, program, Detector
            for key, b1, b64 in (
                    ("detect_pt2", lambda: programs["detect"].call(frames[:1])["count"].cpu(),
                     lambda: p64.call(frames64)),
                    ("run_packed", lambda: det.run_packed(normalize(frames[:1])[..., None]).cpu(),
                     lambda: det.run_packed(normalize(frames64)[..., None]))):
                t = timing.setdefault(key, {"b1_latency_ms": [], "b64_images_per_s": []})
                t["b1_latency_ms"].append(_host_ms(b1, 50))
                t["b64_images_per_s"].append(_images_per_s(b64, 64, 20))

    emit("programs", card=card, res="256x320", export_seconds=export_s,
         seconds_per_file={k: v for k, v in per_file.items()
                           if k.endswith(".pt2") or k.endswith(".mlir")},
         load_seconds=load_s, export_launches=counts["export"],
         detect_pt2={"matched": matched, "reference": int(fx["boxes"].shape[0]),
                     "notes": notes[:5], "launches_per_call": detect_counts[0],
                     "calls_with_other_launches": sum(c != detect_counts[0]
                                                      for c in detect_counts)},
         forward_pt2={"heads_max_abs_err": fwd_err, "ratio_to_tolerance": fwd_ratio,
                      "tolerance": f"{FP32_TOL} rel+abs of the folded forward (chain "
                                   "kernel), fp32 without TF32",
                      "launches_per_call": fwd_counts[0],
                      "launches_of_the_folded_forward": counts["folded_forward"]},
         forward_int8_pt2={"equal_to_int8_detector": bool(int8_equal),
                           "launches_per_call": int8_counts[0]},
         fresh_process={"seconds": child_s, "matched": child_matched, "notes": child_notes[:5],
                        "rows_close_to_this_process": child_rows_equal,
                        "forward_ratio_to_tolerance": child_fwd_ratio,
                        "int8_equal": child_int8_equal,
                        "launches_per_call": child_report["launches"][0],
                        "calls_with_other_launches": sum(
                            c != child_report["launches"][0] for c in child_report["launches"]),
                        "model_modules": child_report["model_modules"]},
         detect64={"export_seconds": export64_s, "load_seconds": load64_s,
                   "launches": counts["detect64"], "rows_close_to_b1_program": rows64_equal},
         timing={k: {m: float(np.median(v)) for m, v in t.items()} | {"runs": t}
                 for k, t in timing.items()},
         timing_note="b1_latency_ms: median host ms of 50 calls on an idle card with the result "
                     "fetched; b64_images_per_s: 20 calls back to back and one synchronise; "
                     "both include the normalise; two alternating runs each",
         op_dispatch={"op_us": float(np.median(dispatch["op_us"])),
                      "ctypes_us": float(np.median(dispatch["ctypes_us"])), "runs": dispatch,
                      "what": "host us a call of K2 on the res1 plane at B=1, 200 back to back "
                              "before a synchronise: through the registered operator and "
                              "through the ctypes launch it wraps (three alternating runs)"},
         onnx={"seconds": onnx_s, "rc": onnx.returncode, "out": onnx.stdout.strip()[-120:],
               "heads_max_abs_err": onnx_err, "tolerance": 2e-4},
         seconds=time.perf_counter() - t0)
    want1 = {"res_chain_cf": 0, "res_chain_rows": 6, "nms": 1}
    check(matched == fx["boxes"].shape[0] and not notes,
          f"programs: detect.pt2 golden {matched}/{fx['boxes'].shape[0]} {notes[:3]}")
    check(all(c == want1 for c in detect_counts),
          f"programs: detect.pt2 launches {detect_counts[:3]}, want 6 K2 and 1 NMS a call")
    check(fwd_ratio <= 1.0 and all(c == {**want1, "nms": 0} for c in fwd_counts),
          f"programs: forward.pt2 {fwd_ratio} x tolerance, launches {fwd_counts}")
    check(int8_equal and all(not any(c.values()) for c in int8_counts),
          f"programs: forward_int8.pt2 equal {int8_equal}, launches {int8_counts}")
    check(child_matched == fx["boxes"].shape[0] and not child_notes and child_rows_equal
          and all(c == want1 for c in child_report["launches"])
          and not child_report["model_modules"] and child_fwd_ratio <= 1.0 and child_int8_equal,
          f"programs: fresh process {child_matched} {child_notes[:3]} {child_report}")
    check(counts["detect64"] == want1 and rows64_equal,
          f"programs: B=64 detect program launches {counts['detect64']}, rows {rows64_equal}")
    check(onnx.returncode == 0 and "ONNX_CONSUMED_OK" in onnx.stdout and onnx_err is not None
          and onnx_err <= 2e-4, f"programs: generic ONNX {onnx.stderr[-400:]} err {onnx_err}")
    return counts


def mlir_path(card, counted, mlir_dir, shlo) -> dict:
    """The mlir phase: the StableHLO text programs run by the unchanged
    native consumer ``cpp/runner/shlo_runner.cpp`` (``yf_shlo``, built from
    the checkout with the host compiler, ``shlo``: the thread building it)
    on the host CPU.  ``forward.mlir`` and ``detect.mlir`` of the programs
    phase's ``export --device cuda`` (B=1): forward.mlir on 4 golden frames
    at 256x320 within 2e-4 of the folded forward on the card (chain kernel,
    fp32 without TF32; JAX's rule for its own text), detect.mlir on the 20
    golden frames (34/34 by the strict rule); then a 512x640 detect program
    exported on the card at B=4, written as ``detect.pt2`` and as text: the
    text through yf_shlo against the loaded ``detect.pt2`` on the card on 4
    golden frames (counts and classes equal, boxes within 1 px, conf and
    cls_score within 1e-3).  yf_shlo's ``avg_time`` (host ms) beside the
    host CPU.  The card-side references launch 6 K2 and 1 NMS a call;
    yf_shlo launches nothing on the card.  One JSON line; returns the
    launch counts."""
    import tempfile

    import torch

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.eval.golden_suite import host_cpu
    from yolofastest_torch.export import (export_detect_pipeline, load_exported, save_exported,
                                          save_exported_mlir)
    from yolofastest_torch.inference import detections_to_lists
    from yolofastest_torch.models import (fold_batchnorm, folded_apply, load_variables,
                                          torch_params_from_folded)
    from yolofastest_torch.native import run_shlo
    from yolofastest_torch.ops import normalize
    from yolofastest_torch.utils.device import exact_fp32

    t0 = time.perf_counter()
    shlo.join()
    check(shlo.error is None, f"mlir: yf_shlo build failed: {shlo.error}")
    runner, build = shlo.result
    keys = ("boxes", "cls_idx", "cls_score", "conf", "count", "valid")  # JAX's flat order
    counts, avg_ms = {}, {}
    fx = {res: np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
          for res in ("256x320", "512x640")}
    pre = fx["256x320"]["pre_imgs"]

    # forward.mlir against the folded forward over the chain kernel
    zoo = load_variables(os.path.join(WEIGHTS, "yolofastest_256x320.npz"))
    params = torch_params_from_folded(fold_batchnorm(zoo), "cuda")
    x = normalize(torch.from_numpy(pre[:4]).cuda())[..., None]
    with torch.no_grad(), exact_fp32():
        ref, counts["folded_forward"] = counted(lambda: folded_apply(params, x))
    fwd_err, fwd_ms = 0.0, []
    for i in range(4):
        heads, ms = run_shlo(os.path.join(mlir_dir, "forward.mlir"), x[i:i + 1].cpu().numpy(),
                             runner=runner)
        fwd_ms.append(ms)
        fwd_err = max([fwd_err] + [float(np.abs(h - r[i:i + 1].cpu().numpy()).max())
                                   for h, r in zip(heads, ref)])
    avg_ms["forward_256x320_b1"] = float(np.median(fwd_ms))

    # detect.mlir on the 20 golden frames, one at a time (the program's B=1)
    rows, det_ms = [], []
    for i in range(pre.shape[0]):
        res, ms = run_shlo(os.path.join(mlir_dir, "detect.mlir"), pre[i:i + 1], runner=runner)
        det_ms.append(ms)
        rows += detections_to_lists(dict(zip(keys, res)))
    matched, notes = golden_match(rows, fx["256x320"]["boxes"], pre.shape[0])
    avg_ms["detect_256x320_b1"] = float(np.median(det_ms))

    # a 512x640 detect program at B=4: the text against the loaded .pt2 on the card
    pre512 = fx["512x640"]["pre_imgs"][:4]
    with tempfile.TemporaryDirectory(prefix="yf_mlir_") as tmp:
        c0 = time.perf_counter()
        program = export_detect_pipeline(
            load_variables(os.path.join(WEIGHTS, "yolofastest_512x640.npz")),
            get_config("512x640"), batch=4, device="cuda")
        save_exported(program, os.path.join(tmp, "detect.pt2"))
        save_exported_mlir(program, os.path.join(tmp, "detect.mlir"))
        lower_s = time.perf_counter() - c0
        want, counts["detect_pt2_512x640"] = counted(lambda: load_exported(
            os.path.join(tmp, "detect.pt2")).call(torch.from_numpy(pre512).cuda()))
        got, avg_ms["detect_512x640_b4"] = run_shlo(os.path.join(tmp, "detect.mlir"), pre512,
                                                    runner=runner)
    want = {k: v.cpu().numpy() for k, v in want.items()}
    got = dict(zip(keys, got))
    cmp512 = {"count_equal": bool(np.array_equal(got["count"], want["count"])),
              "count": want["count"].tolist(), "cls_idx_equal": True, "boxes_max_px": 0.0,
              "conf_max_abs": 0.0, "cls_score_max_abs": 0.0}
    for b in range(4):
        n = int(want["count"][b])
        cmp512["cls_idx_equal"] &= bool(np.array_equal(got["cls_idx"][b, :n],
                                                       want["cls_idx"][b, :n]))
        for key, field in (("boxes", "boxes_max_px"), ("conf", "conf_max_abs"),
                           ("cls_score", "cls_score_max_abs")):
            if n:
                cmp512[field] = max(cmp512[field],
                                    float(np.abs(got[key][b, :n] - want[key][b, :n]).max()))
    emit("mlir", card=card, host_cpu=host_cpu(), yf_shlo_build=build,
         forward_256x320={"frames": 4, "heads_max_abs_err": fwd_err, "tolerance": 2e-4,
                          "reference": "folded forward on the card (chain kernel), fp32 "
                                       "without TF32", "launches": counts["folded_forward"]},
         detect_256x320={"matched": matched, "reference": int(fx["256x320"]["boxes"].shape[0]),
                         "notes": notes[:5]},
         detect_512x640={**cmp512, "frames": 4, "export_and_lower_seconds": lower_s,
                         "launches_of_detect_pt2": counts["detect_pt2_512x640"]},
         yf_shlo_avg_ms=avg_ms,
         avg_ms_note="yf_shlo's avg_time: host ms a call on the host CPU (median over the "
                     "calls; the interpreter's own OpenMP threads), not the card's",
         seconds=time.perf_counter() - t0)
    want1 = {"res_chain_cf": 0, "res_chain_rows": 6, "nms": 1}
    check(fwd_err <= 2e-4 and counts["folded_forward"] == {**want1, "nms": 0},
          f"mlir: forward.mlir {fwd_err} from the folded forward, launches "
          f"{counts['folded_forward']}")
    check(matched == fx["256x320"]["boxes"].shape[0] and not notes,
          f"mlir: detect.mlir golden {matched} {notes[:3]}")
    check(cmp512["count_equal"] and cmp512["cls_idx_equal"] and cmp512["boxes_max_px"] <= 1.0
          and cmp512["conf_max_abs"] <= 1e-3 and cmp512["cls_score_max_abs"] <= 1e-3
          and counts["detect_pt2_512x640"] == want1, f"mlir: 512x640 detect.mlir {cmp512}")
    return counts


class _Thread:
    """A function run in a thread; ``result`` or ``error`` once joined."""

    def __init__(self, fn):
        import threading

        self.result = self.error = None
        self._thread = threading.Thread(target=self._run, args=(fn,), daemon=True)
        self._thread.start()

    def _run(self, fn):
        try:
            self.result = fn()
        except Exception as e:  # noqa: BLE001 (reported by the phase that joins)
            self.error = repr(e)

    def join(self):
        self._thread.join()


def int8_path(card, counted) -> dict:
    """The int8 phase on the card: the shipped int8 artifacts through
    ``Detector(backend="int8"|"int8-fused", int8_artifact=...)`` on the
    golden frames (recall by the golden suite's rule; rows and heads against
    the CPU port; launches), the integer accumulators of every int8 layer
    against exact int64 ones, calibration on the card against the CPU with a
    cache written and read back, and both backends timed beside fp32.  One
    JSON line; returns the launch counts of each run."""
    import tempfile

    import torch
    import torch.nn.functional as F

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector, detections_to_lists
    from yolofastest_torch.models import fold_batchnorm, load_variables
    from yolofastest_torch.quant import calibrate, ptq

    t0 = time.perf_counter()
    fixtures = {res: np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
                for res in ("256x320", "512x640")}
    artifacts = {"256x320": ("256x320", "yolofastest_int8_256x320.npz"),
                 "512x640": ("512x640", "yolofastest_int8_512x640.npz"),
                 "pruned040_256x320": ("256x320", "yolofastest_int8_pruned040_256x320.npz")}

    def net_input(res, n=None):
        pre = fixtures[res]["pre_imgs"][:n]
        return (pre.astype(np.float32)[..., None] - 128.0) / 255.0

    def int8_detector(name, backend, device):
        res, fname = artifacts[name]
        return Detector(get_config(res), None, backend=backend, device=device,
                        int8_artifact=os.path.join(WEIGHTS, fname))

    # -- golden recall, the card against the CPU port, launches per forward
    counts, golden = {}, {}
    for name, (res, _) in artifacts.items():
        fx = fixtures[res]
        frames, x = make_frames(fx["pre_imgs"]), net_input(res)
        for backend in ("int8", "int8-fused"):
            det, cpu = int8_detector(name, backend, "cuda"), int8_detector(name, backend, "cpu")
            key = f"{name}/{backend}"
            out, counts[key] = counted(lambda: det.run_raw(frames))
            rows, rows_cpu = detections_to_lists(out), detections_to_lists(cpu.run_raw(frames))
            ref = np.array([[b, *r] for b, img in enumerate(rows_cpu) for r in img],
                           np.float64).reshape(-1, 8)
            matched, notes = golden_match(rows, ref, len(rows_cpu))
            heads = [h.cpu().numpy() for h in det.forward_heads(torch.from_numpy(x).cuda())]
            heads_cpu = [h.numpy() for h in cpu.forward_heads(x)]
            diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(heads, heads_cpu)])
            golden[key] = {
                "recall_iou_0_5": f"{recall_iou(rows, fx['boxes'])}/{len(fx['boxes'])}",
                "keep_fp": list(det.keep_fp), "detections": sum(len(r) for r in rows),
                "rows_vs_cpu": {"matched": matched, "cpu_rows": len(ref), "notes": notes[:3]},
                "heads_vs_cpu": {"max_abs": float(diff.max()), "mean_abs": float(diff.mean()),
                                 "share_within_0_05": float(np.mean(diff <= 0.05))},
                "launches": counts[key]}

    # -- the integer accumulators of every int8 layer, against float64 CPU
    # convolutions of the same int8 values: every partial sum is an integer
    # below 2^53, so float64 holds the exact int64 sums
    records = []
    products = {"conv": ptq._int_products, "deconv": ptq._deconv_products}

    def recorder(kind):
        def run(p, xq, *geometry):
            acc = products[kind](p, xq, *geometry)
            records.append((kind, p["weight"], xq, acc, geometry))
            return acc
        return run

    def exact(kind, weight, xq, geometry):
        x64 = xq.cpu().double().permute(0, 3, 1, 2)
        if kind == "deconv":
            y = F.conv_transpose2d(x64, weight.cpu().double(), None, 2)
        else:
            stride, groups, pad = geometry
            y = F.conv2d(x64, weight.cpu().double(), None, stride, pad, 1, groups)
        return y.permute(0, 2, 3, 1).to(torch.int64)

    acc_runs, layers_checked, mismatched, not_integral = [], 0, 0, 0
    for name, backend, b in (("256x320", "int8", 1), ("256x320", "int8", 64),
                             ("256x320", "int8-fused", 64), ("512x640", "int8", 20),
                             ("pruned040_256x320", "int8-fused", 20)):
        det = int8_detector(name, backend, "cuda")
        res = artifacts[name][0]
        x = torch.from_numpy(net_input(res)[np.arange(b) % 20]).cuda()
        ptq._int_products, ptq._deconv_products = recorder("conv"), recorder("deconv")
        try:
            det.forward_heads(x)
        finally:
            ptq._int_products, ptq._deconv_products = products["conv"], products["deconv"]
        torch.cuda.synchronize()
        bad = 0
        for kind, weight, xq, acc, geometry in records:
            got = acc.cpu()
            not_integral += int((got != torch.round(got)).sum())
            bad += int((got.to(torch.int64) != exact(kind, weight, xq, geometry)).sum())
        acc_runs.append({"artifact": name, "backend": backend, "batch": b,
                         "layers": len(records), "mismatched_sums": bad})
        layers_checked += len(records)
        mismatched += bad
        records.clear()

    # -- calibration on the card against the CPU (the 256x320 zoo, 8 frames),
    # and a cache written and read back
    folded = fold_batchnorm(load_variables(os.path.join(WEIGHTS, "yolofastest_256x320.npz")))
    x8 = net_input("256x320", 8)
    calib = {}
    for method in ("amax", "mse"):
        c0 = time.perf_counter()
        card_scales = calibrate(folded, [x8], method=method, device="cuda")
        card_s = time.perf_counter() - c0
        cpu_scales = calibrate(folded, [x8], method=method, device="cpu")
        amax = calibrate(folded, [x8], device="cpu") if method != "amax" else cpu_scales
        worst = max(abs(card_scales[k] - v) / ((amax[k] / 2048 if method != "amax" else 0.0)
                                              + 1e-5 * v) for k, v in cpu_scales.items())
        calib[method] = {"keys": len(card_scales),
                         "same_keys_in_order": list(card_scales) == list(cpu_scales),
                         "max_rel_diff": max(abs(card_scales[k] - v) / v
                                             for k, v in cpu_scales.items()),
                         "ratio_to_tolerance": worst, "card_seconds": card_s}
    with tempfile.TemporaryDirectory(prefix="yf_int8_") as tmp:
        cache = os.path.join(tmp, "zoo.calib.json")
        zoo = load_variables(os.path.join(WEIGHTS, "yolofastest_256x320.npz"))
        wrote = Detector(get_config("256x320"), zoo, backend="int8", calibration=x8,
                         calibration_cache=cache, device="cuda")
        with open(cache) as f:
            on_disk = json.load(f)
        read = Detector(get_config("256x320"), zoo, backend="int8-fused",
                        calibration_cache=cache, device="cuda")
        fxg = fixtures["256x320"]
        out, counts["calibrated/int8"] = counted(lambda: wrote.run_raw(make_frames(
            fxg["pre_imgs"])))
        cache_check = {
            "written_equals_scales": on_disk == wrote.act_scales,
            "read_equals_written": list(read.act_scales.items()) == list(on_disk.items()),
            "calibrated_int8_recall_iou_0_5":
                f"{recall_iou(detections_to_lists(out), fxg['boxes'])}/{len(fxg['boxes'])}"}

    # -- timing: fp32 and both int8 backends, 256x320, B=1 and B=64
    frames_all = make_frames(fixtures["256x320"]["pre_imgs"])
    zoo = load_variables(os.path.join(WEIGHTS, "yolofastest_256x320.npz"))
    timing = []
    for backend in ("fp", "int8", "int8-fused"):
        det = (Detector(get_config("256x320"), zoo, device="cuda") if backend == "fp"
               else int8_detector("256x320", backend, "cuda"))
        for b in (1, 64):
            frames = torch.from_numpy(frames_all[np.arange(b) % 20]).cuda()
            _, per_forward = counted(lambda: det.run_raw(frames))
            timing.append({"backend": backend, "dtype": "float32", "batch": b,
                           **stage_times(det, frames), "launches": per_forward})

    emit("int8", card=card, res={"golden": list(artifacts)}, golden=golden,
         rows_rule="strict golden rule (tests/test_detect_parity.py:145-171) against the "
                   "CPU port's rows",
         heads_tolerance="bit for bit for the fully int8 artifacts; the pruned hybrid "
                         "artifact's kept fp layers are float32 convolutions in cuDNN's "
                         "order: every value within 0.5, the mean within 1e-3, 99% within "
                         "0.05",
         accumulators={"runs": acc_runs, "layers_checked": layers_checked,
                       "mismatched_sums": mismatched, "not_integral": not_integral,
                       "reference": "float64 convolutions on the CPU of the same int8 values "
                                    "(exact int64 sums), bit for bit"},
         calibration=calib, calibration_tolerance="amax 1e-5 relative; mse one bin of 2048 "
                                                  "plus 1e-5 relative",
         cache=cache_check, timing=timing, seconds=time.perf_counter() - t0)
    need = {"256x320": 34, "512x640": 33, "pruned040_256x320": 34}
    for key, g in golden.items():
        name = key.split("/")[0]
        check(g["recall_iou_0_5"] == f"{need[name]}/{need[name]}",
              f"int8 {key}: golden recall {g['recall_iou_0_5']}")
        check(not g["rows_vs_cpu"]["notes"] and g["rows_vs_cpu"]["matched"]
              == g["rows_vs_cpu"]["cpu_rows"], f"int8 {key}: rows differ from the CPU's {g}")
        h = g["heads_vs_cpu"]
        if g["keep_fp"]:
            check(h["max_abs"] <= 0.5 and h["mean_abs"] <= 1e-3
                  and h["share_within_0_05"] >= 0.99, f"int8 {key}: heads off the CPU's {h}")
        else:
            check(h["max_abs"] == 0.0, f"int8 {key}: heads not bit for bit the CPU's {h}")
        c = g["launches"]
        check(c["nms"] == 1 and c["res_chain_rows"] == 0 and c["res_chain_cf"] == 0,
              f"int8 {key}: launches {c}, want 1 NMS and no chain kernel a forward")
    check(mismatched == 0 and not_integral == 0 and layers_checked > 0,
          f"int8 accumulators: {mismatched} sums differ from int64, {not_integral} not "
          f"integral, in {layers_checked} layers")
    for method, c in calib.items():
        check(c["same_keys_in_order"] and c["ratio_to_tolerance"] <= 1.0,
              f"calibration {method} on the card off the CPU's: {c}")
    check(all(v is True for k, v in cache_check.items() if k != "calibrated_int8_recall_iou_0_5"),
          f"calibration cache: {cache_check}")
    for t in timing:
        c = t["launches"]
        want_chains = 6 if t["backend"] == "fp" else 0
        check(c["nms"] == 1 and c["res_chain_rows"] == want_chains,
              f"int8 timing launches {t['backend']} B={t['batch']}: {c}")
    return counts


def quant2_path(card, counted) -> dict:
    """The quant2 phase on the card (256x320 zoo, the golden frames): the
    sensitivity sweep over the 20 frames, and against the CPU port's on the
    first 8 with the same scales;
    QAT, its float64 steps each from the CPU's state (1e-9 a leaf), fp32
    runs card and CPU, the teacher's chain launches and the steps/s; and
    ``export --calib-data <golden frames> --qat-steps 4 --device cuda``.
    One JSON line; returns the launch counts of each run."""
    import contextlib
    import io
    import tempfile

    import cv2
    import torch

    from torch_timing import device_busy
    from yolofastest_torch.cli import main as cli_main
    from yolofastest_torch.cli._common import load_calibration
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.export import load_native_weights
    from yolofastest_torch.models import fold_batchnorm, load_variables
    from yolofastest_torch.quant import (calibrate, layer_sensitivity, qat_finetune,
                                         quantize_weights)
    from yolofastest_torch.quant.qat import QatRun

    t0 = time.perf_counter()
    cfg = get_config("256x320")
    zoo_file = os.path.join(WEIGHTS, "yolofastest_256x320.npz")
    folded = fold_batchnorm(load_variables(zoo_file))
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    x = (fx["pre_imgs"].astype(np.float32)[..., None] - 128.0) / 255.0
    counts = {}

    # -- the sweep: every layer int8 alone against the fp graph, over the 20
    # frames on the card (timed); card vs CPU on the first 8 with the same
    # scales (the CPU's sweep takes 25-90 s of a host for 20), to the
    # per-layer tolerance of the mixed int8 graph (tests/test_torch_quant.py)
    mean_tol, max_tol = 1e-3, 0.5
    scales = calibrate(folded, [x], device="cpu")
    c0 = time.perf_counter()
    table20, counts["sweep"] = counted(lambda: layer_sensitivity(folded, [x], act_scales=scales,
                                                                 device="cuda"))
    sweep_s = time.perf_counter() - c0
    sweep_busy_ms, sweep_busy_share = device_busy(
        lambda: layer_sensitivity(folded, [x], act_scales=scales, device="cuda"), 1)
    x8 = x[:8]
    rows = layer_sensitivity(folded, [x8], act_scales=scales, device="cuda")
    c0 = time.perf_counter()
    cpu_rows = layer_sensitivity(folded, [x8], act_scales=scales, device="cpu")
    cpu_sweep_s = time.perf_counter() - c0
    cpu_by = {r["layer"]: r for r in cpu_rows}
    worst_mean = max(abs(r["mean_abs"] - cpu_by[r["layer"]]["mean_abs"]) for r in rows)
    worst_max = max(abs(r["max_abs"] - cpu_by[r["layer"]]["max_abs"]) for r in rows)
    gaps = [cpu_rows[i]["mean_abs"] - cpu_rows[i + 1]["mean_abs"] for i in range(5)]
    keep, cpu_keep = ([r["layer"] for r in rr[:5]] for rr in (rows, cpu_rows))
    sweep = {"layers": len(table20), "cpu_layers": len(cpu_rows),
             "same_layers": sorted(cpu_by) == sorted(r["layer"] for r in rows) == sorted(
                 r["layer"] for r in table20) == sorted(quantize_weights(folded)),
             "frames": int(x.shape[0]), "seconds": sweep_s, "compared_frames": int(x8.shape[0]),
             "cpu_seconds_compared_frames": cpu_sweep_s,
             "device_busy_ms": sweep_busy_ms, "device_busy_share": sweep_busy_share,
             "worst_mean_abs_diff": worst_mean, "worst_max_abs_diff": worst_max,
             "keep_fp_top5": keep, "cpu_keep_fp_top5": cpu_keep,
             "top5_separated": min(gaps) > 2 * mean_tol, "launches": counts["sweep"],
             "worst5_20_frames": table20[:5]}

    # -- QAT, float64: each step on the card from the CPU's state
    xq = x[:2]
    runs = {dev: QatRun(folded, scales, [xq], arch="fastest", targets=None, anchors=None,
                        input_hw=None, num_cls=3, lr=1e-4, conf_weight=1.0, device=dev,
                        dtype=torch.float64) for dev in ("cpu", "cuda")}
    theta = runs["cpu"].theta0
    state = (theta, torch.zeros_like(theta), torch.zeros_like(theta),
             torch.zeros((), dtype=torch.int32))
    worst64, losses64 = 0.0, []
    for _ in range(3):
        cpu_next = runs["cpu"].step(*state, 0)
        card_next = runs["cuda"].step(*(t.cuda() for t in state), 0)
        for card_t, cpu_t in zip(card_next[:3], cpu_next[:3]):
            card_t = card_t.cpu()
            for a, b in runs["cpu"].layout.spans.values():
                worst64 = max(worst64, rel_l2(card_t[a:b], cpu_t[a:b]))
        losses64.append((float(card_next[4]), float(cpu_next[4])))
        state = cpu_next[:4]
    loss64_rel = max(abs(a - b) / abs(b) for a, b in losses64)

    # -- QAT, fp32: whole runs on the card and the CPU; the distillation
    # teacher (one batch) is the fp forward with its six chains the kernel
    (card_tuned, card_hist), counts["qat"] = counted(lambda: qat_finetune(
        folded, scales, [xq], steps=4, device="cuda"))
    cpu_tuned, cpu_hist = qat_finetune(folded, scales, [xq], steps=4, device="cpu")
    hist_rel = [abs(a - b) / abs(b) for a, b in zip(card_hist, cpu_hist)]
    batches = [x[:8], x[8:16]]
    qat_finetune(folded, scales, batches, steps=2, device="cuda")  # warm
    torch.cuda.synchronize()
    c0 = time.perf_counter()
    _, counts["qat_timed"] = counted(lambda: qat_finetune(folded, scales, batches, steps=20,
                                                          device="cuda"))
    qat_s = time.perf_counter() - c0
    run8 = QatRun(folded, scales, batches, arch="fastest", targets=None, anchors=None,
                  input_hw=None, num_cls=3, lr=1e-4, conf_weight=1.0, device="cuda",
                  dtype=torch.float32)
    zeros8 = torch.zeros_like(run8.theta0)
    step_busy_ms, step_busy_share = device_busy(
        lambda: run8.step(run8.theta0, zeros8, zeros8, torch.zeros((), dtype=torch.int32,
                                                                   device="cuda"), 0), 3)
    qat = {"float64_steps": 3, "float64_worst_leaf_rel_l2": worst64,
           "float64_loss_rel": loss64_rel, "float64_tolerance": "1e-9 relative L2 a leaf "
           "(params, Adam moments), each card step from the CPU's state",
           "fp32_history_card": card_hist, "fp32_history_cpu": cpu_hist,
           "fp32_history_rel": hist_rel, "launches": counts["qat"],
           "timed": {"batch": 8, "steps": 20, "seconds": qat_s, "steps_per_s": 20 / qat_s,
                     "launches": counts["qat_timed"], "step_device_busy_ms": step_busy_ms,
                     "step_device_busy_share": step_busy_share}}

    # -- export --calib-data <golden frames> --qat-steps 4 --device cuda
    expect = sorted(["model.yfb", "model_int8.yfb", "model.onnx", "detect.onnx", "model.param",
                     "model.bin", "model.prototxt", "model.caffemodel", "model_int8.onnx",
                     "model.table", "model.pt", "forward.pt2", "detect.pt2",
                     "forward_int8.pt2", "forward.mlir", "detect.mlir"])
    with tempfile.TemporaryDirectory(prefix="yf_quant2_") as tmp:
        calib, out = os.path.join(tmp, "calib"), os.path.join(tmp, "out")
        os.makedirs(calib)
        for i, frame in enumerate(make_frames(fx["pre_imgs"][:8])):
            cv2.imwrite(os.path.join(calib, f"g{i}.jpg"), frame)
        printed = io.StringIO()
        c0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc, counts["export"] = counted(lambda: cli_main(
                ["export", "--weights", zoo_file, "--out", out, "--calib-data", calib,
                 "--qat-steps", "4", "--device", "cuda"]))
        export_s = time.perf_counter() - c0
        files = sorted(os.listdir(out))
        own = calibrate(folded, [load_calibration(calib, cfg.io)], device="cuda")
        stored = load_native_weights(os.path.join(out, "model_int8.yfb"))
        scale_keys = sorted(k for k, v in stored.items() if "act_scale" in v)
        scales_equal = scale_keys == sorted(k for k in own if k in folded) and all(
            stored[k]["act_scale"][0] == np.float32(own[k]) for k in scale_keys)
        q = quantize_weights(folded)
        table_ok, table_layers = True, 0
        with open(os.path.join(out, "model.table")) as f:
            for line in f.read().splitlines():
                name, *vals = line.split()
                if name.endswith("_param_0"):
                    want = 1.0 / np.asarray(q[name[:-len("_param_0")]]["w_scale"], np.float64)
                    table_ok &= [float(v) for v in vals] == want.tolist()
                    table_layers += 1
                else:
                    table_ok &= [float(v) for v in vals] == [1.0 / float(own[name])]
        xn = np.ascontiguousarray(x[:2].transpose(0, 3, 1, 2))
        np.save(os.path.join(tmp, "x.npy"), xn)
        onnx = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "onnx_check.py"),
                               os.path.join(out, "model_int8.onnx"), os.path.join(tmp, "x.npy"),
                               os.path.join(tmp, "y.npz")], capture_output=True, text=True,
                              timeout=600)
        heads_ok = False
        if onnx.returncode == 0:
            with np.load(os.path.join(tmp, "y.npz")) as y:
                heads_ok = (sorted(y.files) == ["head_large", "head_small"]
                            and y["head_large"].shape == (2, 24, 16, 20)
                            and all(np.isfinite(y[k]).all() for k in y.files))
    lines = printed.getvalue().splitlines()
    export = {"rc": rc, "files": files, "expected": expect, "seconds": export_s,
              "qat_line": lines[0] if lines else "", "last_line": lines[-1] if lines
              else "", "scales_equal_own_calibration": scales_equal,
              "scaled_layers": len(scale_keys), "table_multipliers_equal": bool(table_ok),
              "table_layers": table_layers,
              "onnx_check": {"rc": onnx.returncode, "out": onnx.stdout.strip()[-200:],
                             "heads_ok": heads_ok},
              "launches": counts["export"]}
    emit("quant2", card=card, res="256x320", sweep=sweep,
         sweep_tolerance=f"per row: mean_abs within {mean_tol}, max_abs within {max_tol} "
                         "(the per-layer mixed graph's tolerance); the top-5 --keep-fp line equal "
                         f"where the CPU's first six rows are {2 * mean_tol} apart",
         qat=qat, qat_fp32_tolerance="the first loss within 1e-4 relative; each later one "
                                     "within 5e-2 (STE steps move weights by lr on the sign "
                                     "of fp32 noise)",
         export=export, seconds=time.perf_counter() - t0)
    check(sweep["same_layers"] and worst_mean <= mean_tol and worst_max <= max_tol,
          f"quant2 sweep off the CPU's: {sweep}")
    check(not sweep["top5_separated"] or keep == cpu_keep, f"quant2 keep-fp line: {sweep}")
    check(counts["sweep"]["res_chain_rows"] == 0 and counts["sweep"]["res_chain_cf"] == 0,
          f"quant2 sweep launched the chain kernel: {counts['sweep']}")
    check(worst64 <= 1e-9 and loss64_rel <= 1e-9, f"quant2 float64 QAT steps: {qat}")
    check(hist_rel[0] <= 1e-4 and max(hist_rel) <= 5e-2 and np.all(np.isfinite(card_hist)),
          f"quant2 fp32 QAT history: {qat}")
    for key, batches_n in (("qat", 1), ("qat_timed", 2)):
        c = counts[key]
        check(c["res_chain_rows"] == 6 * batches_n and c["res_chain_cf"] == 0 and c["nms"] == 0,
              f"quant2 {key} launches {c}: want 6 K2 a teacher batch, none in the student")
    check(rc == 0 and files == expect, f"quant2 export: rc {rc}, files {files}")
    check(export["last_line"] == f"wrote {os.path.join(out, 'forward_int8.pt2')}"
          and export["qat_line"].startswith("QAT distillation: loss"), f"quant2 export: {export}")
    check(scales_equal and table_ok and table_layers > 0, f"quant2 export scales: {export}")
    check(onnx.returncode == 0 and "ONNX_CONSUMED_OK" in onnx.stdout and heads_ok,
          f"quant2 model_int8.onnx: {export['onnx_check']} {onnx.stderr[-400:]}")
    check(counts["export"]["res_chain_rows"] == 6 and counts["export"]["nms"] == 0,
          f"quant2 export launches {counts['export']}: want the QAT teacher's 6")
    return counts


# The recipes phase: tools/run_golden_suite.py's deployment matrix and the
# int8 recipes, through yolofastest_torch.eval.golden_suite and
# yolofastest_torch.quant.recipes.  The QAT search runs make_int8_zoo.py's
# shipped 256x320 flags; the pruned search search_pruned_int8.py's default
# scale sets (4 s on the card: mse12's one-layer set ends it).
RECIPES_QAT = {"spec": "amax8", "steps": 800, "snap": 20, "conf_weight": 4.0}


def recipes_path(card, counted) -> dict:
    """The recipes phase on the card.  The deployment matrix
    (``run_resolution`` at both sizes: every row's recall against
    ``docs/golden_suite_summary.json``'s, ms per image, the kernel launches
    of each size); the 512x640 recipe (``build_shipped``: folded weights
    against the committed artifact bit for bit, its scales' distance from
    the committed ones and from a CPU calibration, the three int8 recalls,
    the two device recalls against the CPU's with the same scales); the
    pruned hybrid search (the set found beside the committed ``keep_fp``);
    the recall-selected QAT search (every candidate's recalls, the step
    shipped or the best joint recall and its step, the teacher's chain
    launches, steps/s; a shipped artifact loaded back through the int8,
    int8-fused and native-int8 backends).  One JSON line; returns the
    launch counts of each run."""
    import tempfile

    import torch

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.eval.golden import (fetch, golden_inputs, int8_recalls,
                                               native_int8_recall, recall_vs_golden, score_int8)
    from yolofastest_torch.eval.golden_suite import host_cpu, methodology, run_resolution
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.models import fold_batchnorm, load_variables, zoo_path
    from yolofastest_torch.quant import load_int8_zoo
    from yolofastest_torch.quant.recipes import (PRUNED_SCALE_SETS, build_shipped, make_scales,
                                                 search_hybrid_keep_fp, search_recall_qat)

    t0 = time.perf_counter()
    vnni = host_int8()
    counts = {}
    with open(os.path.join(ROOT, "docs", "golden_suite_summary.json")) as f:
        committed = json.load(f)

    # -- the matrix: JAX's rows under JAX's names (jax- read as torch-)
    matrix, want = {"methodology": methodology("cuda")}, {}
    with tempfile.TemporaryDirectory(prefix="yf_golden_suite_") as td:
        for res in ("256x320", "512x640"):
            c0 = time.perf_counter()
            matrix[res], counts[f"matrix_{res}"] = counted(
                lambda: run_resolution(res, td, "cuda", log=lambda _: None))
            matrix[res + "_seconds"] = time.perf_counter() - c0
            want[res] = {k.replace("jax-", "torch-"): v["recall"]
                         for k, v in committed[res].items()}
        with open(os.path.join(td, "summary.json"), "w") as f:
            json.dump(matrix, f, indent=2)
        summary_written = os.path.getsize(os.path.join(td, "summary.json")) > 0

    # -- the 512x640 recipe: plain PTQ, amax over the first 16 golden frames
    cfg512 = get_config("512x640")
    imgs512, golden512 = golden_inputs("512x640")
    art_folded, art_scales, _ = load_int8_zoo("512x640")
    rec512 = {}
    with tempfile.TemporaryDirectory(prefix="yf_recipe512_") as td:
        out = os.path.join(td, "yolofastest_int8_512x640.npz")
        c0 = time.perf_counter()
        _, counts["recipe_512x640"] = counted(
            lambda: build_shipped("512x640", out, "cuda", log=lambda _: None, record=rec512))
        built_s = time.perf_counter() - c0
        built_folded, built_scales, built_keep = load_int8_zoo(out)
    cpu_scales = make_scales(fold_batchnorm(load_variables(zoo_path("512x640"))), imgs512,
                             "amax16", "cpu")
    recalls512, counts["recipe_512x640_scores"] = counted(
        lambda: score_int8(built_folded, built_scales, (), cfg512, "cuda", imgs512, golden512))
    cpu_recalls512 = int8_recalls(built_folded, built_scales, (), cfg512, imgs512, golden512,
                                  "cpu")
    recipe512 = {
        "seconds": built_s, "folded_equal_committed": sorted(built_folded) == sorted(art_folded)
        and all(np.array_equal(built_folded[k][leaf], art_folded[k][leaf])
                for k in art_folded for leaf in art_folded[k]),
        "same_scale_keys": list(built_scales) == list(art_scales) == list(cpu_scales),
        "max_rel_scale_distance_committed": max(abs(built_scales[k] - s) / s
                                                for k, s in art_scales.items()),
        "max_rel_scale_distance_cpu": max(abs(built_scales[k] - s) / s
                                          for k, s in cpu_scales.items()),
        "recalls_per_layer_fused_native": recalls512, "golden": len(golden512),
        "cpu_recalls_per_layer_fused": cpu_recalls512, "keep_fp": list(built_keep),
        "committed_artifact_recalls": {k: matrix["512x640"][k]["recall"]
                                       for k in ("int8", "int8-fused", "native-cpp-int8")}}

    # -- the pruned hybrid keep-fp search at 256x320
    cfg = get_config("256x320")
    imgs, golden = golden_inputs("256x320")
    pruned = fold_batchnorm(load_variables(os.path.join(WEIGHTS,
                                                        "yolofastest_pruned040_256x320.npz")))
    pruned_art = load_int8_zoo(os.path.join(WEIGHTS, "yolofastest_int8_pruned040_256x320.npz"))
    sets = PRUNED_SCALE_SETS.split(",")
    pruned_log = []
    c0 = time.perf_counter()
    best, counts["pruned_search"] = counted(lambda: search_hybrid_keep_fp(
        pruned, cfg, imgs, golden, sets, device="cuda", log=pruned_log.append))
    search = {"scale_sets": sets, "seconds": time.perf_counter() - c0, "committed_keep_fp": list(pruned_art[2]),
              "committed_scales": "mse12", "log_lines": len(pruned_log),
              "log_first": pruned_log[:12], "log_last": pruned_log[-4:]}
    if best is not None:
        n_keep, spec, keep, recalls, _ = best
        search.update(found_keep_fp=list(keep), found_scales=spec, recalls=list(recalls),
                      equal_committed=spec == "mse12" and keep == pruned_art[2])
    else:
        search.update(found_keep_fp=None, equal_committed=False)

    # -- the recall-selected QAT search at 256x320 (make_int8_zoo.py's flags)
    folded = fold_batchnorm(load_variables(zoo_path("256x320")))
    scales = make_scales(folded, imgs, RECIPES_QAT["spec"], "cuda")
    qat_rec, qat_log = {}, []
    with tempfile.TemporaryDirectory(prefix="yf_recipe256_") as td:
        out = os.path.join(td, "yolofastest_int8_256x320.npz")
        c0 = time.perf_counter()
        found, counts["qat_search"] = counted(lambda: search_recall_qat(
            folded, cfg, scales, imgs=imgs, golden=golden, out=out, device="cuda",
            log=qat_log.append, record=qat_rec, **RECIPES_QAT))
        qat_s = time.perf_counter() - c0
        joint = [(label, min(r), list(r)) for label, r in qat_rec["scores"]]
        best_joint = max(joint, key=lambda t: t[1])  # the first of the highest
        qat = {"flags": RECIPES_QAT, "seconds": qat_s, "qat_seconds": qat_rec["qat_seconds"],
               "steps_per_s": RECIPES_QAT["steps"] / qat_rec["qat_seconds"],
               "loss_first_min": [qat_rec["history"][0], min(qat_rec["history"])],
               "shipped": found[0] if found else None,
               "best_joint": {"candidate": best_joint[0], "recall": best_joint[1],
                              "recalls": best_joint[2]},
               "candidates_scored": len(joint), "scores": joint, "golden": len(golden),
               "committed": "step460 of 800 (JAX, TPU)"}
        if found:
            s_folded, s_scales, s_keep = load_int8_zoo(out)
            back = {}
            for backend in ("int8", "int8-fused"):
                det = Detector(cfg, None, backend=backend, int8_artifact=out, device="cuda")
                back[backend] = recall_vs_golden(fetch(det.run(torch.from_numpy(imgs).cuda())),
                                                 golden)[0]
            back["native-int8"] = native_int8_recall(s_folded, s_scales, s_keep, cfg, imgs,
                                                     golden)[0]
            qat["shipped_recalls_loaded_back"] = back
    emit("recipes", card=card, host_cpu=host_cpu(), host_avx512_vnni=vnni,
         matrix=matrix, matrix_committed_recall=want,
         matrix_note="device rows: one batch of the golden frames, best of 3 calls after a warm "
                     "one, host clock around the call and the fetch of its detections; native "
                     "rows: best of 3 passes, host clock around each engine.detect, host CPU",
         summary_json_written=summary_written, recipe_512x640=recipe512,
         pruned_search=search, qat_search=qat, launches=counts,
         seconds=time.perf_counter() - t0)

    for res in ("256x320", "512x640"):
        got = {k: v["recall"] for k, v in matrix[res].items()}
        check(got == want[res], f"recipes matrix {res}: recalls {got}, committed {want[res]}")
        c = counts[f"matrix_{res}"]
        device_rows = sum("ms_per_img_batched" in v for v in matrix[res].values())
        k2 = 6 * 4 * ("pruned040-bf16" in matrix[res])  # a warm call and 3 timed
        check(c["res_chain_rows"] == k2 and c["res_chain_cf"] == 0
              and c["nms"] == 4 * device_rows,
              f"recipes matrix {res} launches {c}: want {k2} K2, {4 * device_rows} NMS")
    check(recipe512["folded_equal_committed"] and recipe512["same_scale_keys"]
          and recipe512["max_rel_scale_distance_cpu"] <= 1e-5
          and list(recalls512[:2]) == list(cpu_recalls512),
          f"recipes 512x640 recipe: {recipe512}")
    check(counts["recipe_512x640"]["nms"] == 0 and counts["recipe_512x640_scores"]["nms"] == 2
          and not counts["recipe_512x640_scores"]["res_chain_rows"],
          f"recipes 512x640 launches {counts}")
    check(best is None or (len(best[3]) == 3 and min(best[3]) == len(golden)),
          f"recipes pruned search: {search}")
    check(not counts["pruned_search"]["res_chain_rows"] and counts["pruned_search"]["nms"] > 0,
          f"recipes pruned search launches {counts['pruned_search']}")
    n_batches = -(-len(imgs) // 4)
    c = counts["qat_search"]
    check(c["res_chain_rows"] == 6 * n_batches and c["res_chain_cf"] == 0
          and c["nms"] == 2 * len(joint),
          f"recipes QAT search launches {c}: want {6 * n_batches} K2 (the teacher), "
          f"{2 * len(joint)} NMS (two a scored candidate)")
    check(all(np.isfinite(qat_rec["history"])), f"recipes QAT losses: {qat['loss_first_min']}")
    if found:
        check(all(v == len(golden) for v in qat["shipped_recalls_loaded_back"].values()),
              f"recipes QAT shipped artifact loaded back: {qat['shipped_recalls_loaded_back']}")
    return counts


def host_int8() -> bool:
    """Whether the host CPU has AVX-512 VNNI; without it the native library
    is told to run its int8 layers on its scalar int8 path (``YF_INT8=1``:
    the same values, slower) rather than in fp32."""
    with open("/proc/cpuinfo") as f:
        vnni = "avx512_vnni" in f.read()
    if not vnni:
        os.environ["YF_INT8"] = "1"
    return vnni


def native_path(card, counted) -> dict:
    """The native phase: the C++ engine of ``cpp/`` on the host CPU
    (``yolofastest_torch.native``), found or built from the checkout's
    sources.  The engine at 256x320 and 512x640 from the port's ``.yfb``
    against the port's fp Detector on the card (heads within rtol 1e-4, atol
    2e-3; golden 34/34 and 33/33), and timed per image beside the Detector's
    B=1 latency from the same net input; ``native-int8`` from the three
    shipped artifacts (recall, int8 layers, ms); ``native-int8`` calibrated
    on the card by ``detect`` on a cache miss, its scales against a CPU
    calibration; then ``detect``, ``serve``, ``video`` and ``eval`` with
    ``--backend native`` on the golden frames.  The engine launches no CUDA
    kernel: every native run's counts must stay 0.  One JSON line; returns
    the launch counts of each run."""
    import contextlib
    import io
    import tempfile
    import urllib.request

    import cv2
    import torch

    from yolofastest_torch.cli import build_parser
    from yolofastest_torch.cli import main as cli_main
    from yolofastest_torch.cli._common import load_calibration
    from yolofastest_torch.cli.serve import build_server
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.data import write_voc_xml
    from yolofastest_torch.eval.golden_suite import host_cpu
    from yolofastest_torch.export import save_native_weights
    from yolofastest_torch.inference import Detector, detections_to_lists
    from yolofastest_torch.models import fold_batchnorm, load_variables
    from yolofastest_torch.native import NativeEngine, find_library
    from yolofastest_torch.ops import unpack_detections
    from yolofastest_torch.quant import calibrate, load_int8_zoo, mixed_native_tree

    t0 = time.perf_counter()
    cpu = host_cpu()
    lib_path, build = find_library()
    vnni = host_int8()
    counts = {}

    def per_image_ms(fn, imgs, reps=3):
        times = []
        for _ in range(reps):
            for img in imgs:
                t = time.perf_counter()
                fn(img)
                times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    def net_input(pre):
        return (pre.astype(np.float32)[..., None] - 128.0) / 255.0

    def cli(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
        return rc, out.getvalue()

    fixtures = {res: np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
                for res in ("256x320", "512x640")}
    fp, int8 = {}, {}
    with tempfile.TemporaryDirectory(prefix="yf_native_") as tmp:
        for res in ("256x320", "512x640"):
            cfg, fx = get_config(res), fixtures[res]
            x = net_input(fx["pre_imgs"])
            variables = load_variables(os.path.join(WEIGHTS, f"yolofastest_{res}.npz"))
            yfb = os.path.join(tmp, f"{res}.yfb")
            save_native_weights(fold_batchnorm(variables), yfb, io_config=cfg.io)
            eng = NativeEngine(yfb, cfg, library_path=lib_path)
            det = Detector(cfg, variables=variables, device="cuda")
            ref, counts[f"detector_heads/{res}"] = counted(
                lambda: [h.cpu().numpy() for h in det.forward_heads(x)])
            (heads, rows), counts[f"native/{res}"] = counted(
                lambda: ([eng.forward(img) for img in x], [eng.detect(img) for img in x]))
            ratio = max(float(np.max(np.abs(h - r[i]) / (2e-3 + 1e-4 * np.abs(r[i]))))
                        for i, hs in enumerate(heads) for h, r in zip(hs, ref))
            det.warmup(1)
            fp[res] = {
                "recall_iou_0_5": [recall_iou(rows, fx["boxes"]), int(fx["boxes"].shape[0])],
                "heads_ratio_to_tolerance": ratio, "int8_layers": eng.int8_layers,
                "native_ms_per_image": per_image_ms(eng.detect, x),
                "detector_b1_ms": per_image_ms(lambda img: detections_to_lists(
                    unpack_detections(det.run_packed(img[None]))), x)}
        artifacts = {"256x320": ("256x320", "yolofastest_int8_256x320.npz", 57),
                     "512x640": ("512x640", "yolofastest_int8_512x640.npz", 57),
                     "pruned040_256x320": ("256x320", "yolofastest_int8_pruned040_256x320.npz",
                                           56)}
        for name, (res, fname, n_int8) in artifacts.items():
            cfg, fx = get_config(res), fixtures[res]
            x = net_input(fx["pre_imgs"])
            folded, scales, keep = load_int8_zoo(os.path.join(WEIGHTS, fname))
            tree, nscales = mixed_native_tree(folded, scales, keep)
            yfb = os.path.join(tmp, f"int8_{name}.yfb")
            save_native_weights(tree, yfb, act_scales=nscales, io_config=cfg.io)
            eng = NativeEngine(yfb, cfg, library_path=lib_path)
            rows, counts[f"native_int8/{name}"] = counted(lambda: [eng.detect(img) for img in x])
            int8[name] = {"recall_iou_0_5": [recall_iou(rows, fx["boxes"]),
                                             int(fx["boxes"].shape[0])],
                          "int8_layers": [eng.int8_layers, n_int8], "keep_fp": list(keep),
                          "ms_per_image": per_image_ms(eng.detect, x)}

        # the golden frames as 512x640 .jpg files, a VOC set with the
        # golden_map targets, and a video of them
        fx = fixtures["256x320"]
        x = net_input(fx["pre_imgs"])
        frames = make_frames(fx["pre_imgs"])
        voc, imgs = os.path.join(tmp, "voc"), os.path.join(tmp, "voc", "img")
        os.makedirs(imgs)
        os.makedirs(os.path.join(voc, "xml"))
        targets = np.load(os.path.join(FIXTURES, "golden_map.npz"))["targets"]
        names = get_config("256x320").io.class_names
        clip = os.path.join(tmp, "clip.avi")
        writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (640, 512))
        for i, frame in enumerate(frames):
            cv2.imwrite(os.path.join(imgs, f"g{i:02d}.jpg"), frame)
            writer.write(frame)
            rows = targets[i][targets[i][:, 5] > 1]
            write_voc_xml(os.path.join(voc, "xml", f"g{i:02d}.xml"), f"g{i:02d}.jpg",
                          (512, 640, 3),
                          [(names[int(c)], (xc - w / 2) * 640, (yc - h / 2) * 512,
                            (xc + w / 2) * 640, (yc + h / 2) * 512) for xc, yc, w, h, c, _ in rows])
        writer.release()
        zoo = os.path.join(WEIGHTS, "yolofastest_256x320.npz")

        # native-int8 calibrated on the card by `detect` on a cache miss
        cache = os.path.join(tmp, "card.calib.json")
        t = time.perf_counter()
        (rc, _), counts["detect_native_int8"] = counted(lambda: cli(
            ["detect", "--weights", zoo, "--data", imgs, "--out", os.path.join(tmp, "d8"),
             "--backend", "native-int8", "--calibration-cache", cache, "--device", "cuda"]))
        detect8_s = time.perf_counter() - t
        with open(cache) as f:
            card_scales = {k: float(v) for k, v in json.load(f).items()}
        folded = fold_batchnorm(load_variables(zoo))
        cpu_scales = calibrate(folded, [load_calibration(imgs, get_config("256x320").io)],
                               device="cpu")
        rel = max(abs(card_scales[k] - v) / v for k, v in cpu_scales.items())
        recalls = {}
        for side, sc in (("card", card_scales), ("cpu", cpu_scales)):
            tree, nscales = mixed_native_tree(folded, sc, ())
            yfb = os.path.join(tmp, f"calibrated_{side}.yfb")
            save_native_weights(tree, yfb, act_scales=nscales, io_config=get_config("256x320").io)
            eng = NativeEngine(yfb, get_config("256x320"), library_path=lib_path)
            recalls[side] = recall_iou([eng.detect(img) for img in x], fx["boxes"])
        calibrated = {"rc": rc, "seconds": detect8_s, "same_keys": card_scales.keys()
                      == cpu_scales.keys(), "max_rel_scale_distance_card_vs_cpu": rel,
                      "recall_iou_0_5_card_scales": recalls["card"],
                      "recall_iou_0_5_cpu_scales": recalls["cpu"],
                      "launches": counts["detect_native_int8"]}

        # the four commands with --backend native
        cmds = {}
        native = ["--weights", zoo, "--backend", "native"]
        t = time.perf_counter()
        (rc, _), counts["cmd_detect"] = counted(lambda: cli(
            ["detect", *native, "--data", imgs, "--out", os.path.join(tmp, "d")]))
        written = sorted(os.listdir(os.path.join(tmp, "d")))
        with open(os.path.join(tmp, "d", "model.yfb"), "rb") as a, \
                open(os.path.join(tmp, "256x320.yfb"), "rb") as b:
            same_yfb = a.read() == b.read()
        cmds["detect"] = {"rc": rc, "results": sum(f.startswith("result_") for f in written),
                          "model_yfb_equal_to_phase": same_yfb,
                          "seconds": time.perf_counter() - t}
        t = time.perf_counter()
        server = build_server(build_parser().parse_args(
            ["serve", *native, "--port", "0", "--max-batch", "4"]))
        server.start()
        try:
            body = cv2.imencode(".png", frames[0])[1].tobytes()
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}/detect", data=body,
                                         method="POST")
            reply, counts["cmd_serve"] = counted(
                lambda: json.load(urllib.request.urlopen(req, timeout=60)))
        finally:
            server.close()
        want = get_config("256x320")
        got_rows = [[*d["box_net"], d["conf"], d["cls_score"], float(d["cls"])]
                    for d in reply["detections"]]
        eng = NativeEngine(os.path.join(tmp, "256x320.yfb"), want, library_path=lib_path)
        cmds["serve"] = {"count": reply["count"], "rows_equal_engine": got_rows
                         == eng.detect(x[0]), "backend": server.backend,
                         "seconds": time.perf_counter() - t}
        t = time.perf_counter()
        (rc, out), counts["cmd_video"] = counted(lambda: cli(
            ["video", *native, "--video", clip, "--out", os.path.join(tmp, "v"), "--track"]))
        stats = json.loads(out.strip().splitlines()[-1])
        cmds["video"] = {"rc": rc, "frames": stats["frames"], "tracks": stats["tracks"],
                         "fps": stats["fps"], "seconds": time.perf_counter() - t}
        maps = {}
        for backend in ("native", "fp"):
            j = os.path.join(tmp, f"eval_{backend}.json")
            t = time.perf_counter()
            (rc, _), counts[f"cmd_eval_{backend}"] = counted(lambda: cli(
                ["eval", "--weights", zoo, "--backend", backend, "--val-dir", voc, "--json-out",
                 j, "--log-dir", os.path.join(tmp, "l")]))
            with open(j) as f:
                maps[backend] = {"rc": rc, "mAP": json.load(f)["mAP"],
                                 "seconds": time.perf_counter() - t}
        cmds["eval"] = maps
    emit("native", card=card, host_cpu=cpu, host_avx512_vnni=vnni,
         library={"path": os.path.relpath(lib_path, ROOT), "built_now": build is not None,
                  **(build or {})},
         fp32=fp, int8=int8, calibrated_on_card=calibrated, commands=cmds, launches=counts,
         note="native ms: host clock per engine.detect call (net input in, rows out), median "
              "of 3 passes over the 20 golden frames, on the host CPU named; detector_b1_ms: "
              "the port's fp Detector on the card, run_packed of one net input and its rows "
              "fetched, the same way",
         seconds=time.perf_counter() - t0)
    for res, r in fp.items():
        check(r["recall_iou_0_5"][0] == r["recall_iou_0_5"][1],
              f"native {res}: golden recall {r['recall_iou_0_5']}")
        check(r["heads_ratio_to_tolerance"] <= 1.0 and r["int8_layers"] == 0,
              f"native {res}: heads off the Detector's on the card: {r}")
    for name, r in int8.items():
        check(r["recall_iou_0_5"][0] == r["recall_iou_0_5"][1]
              and r["int8_layers"][0] == r["int8_layers"][1],
              f"native-int8 {name}: recall or int8 layers {r}")
    check(calibrated["rc"] == 0 and calibrated["same_keys"]
          and calibrated["max_rel_scale_distance_card_vs_cpu"] <= 1e-5
          and abs(recalls["card"] - recalls["cpu"]) <= 1,
          f"native-int8 calibrated on the card: {calibrated}")
    check(cmds["detect"]["rc"] == 0 and cmds["detect"]["results"] == 20
          and cmds["detect"]["model_yfb_equal_to_phase"], f"detect --backend native: {cmds}")
    check(cmds["serve"]["count"] >= 1 and cmds["serve"]["rows_equal_engine"]
          and cmds["serve"]["backend"] == "native", f"serve --backend native: {cmds['serve']}")
    check(cmds["video"]["rc"] == 0 and cmds["video"]["frames"] == 20
          and cmds["video"]["tracks"] > 0, f"video --backend native: {cmds['video']}")
    check(maps["native"]["rc"] == maps["fp"]["rc"] == 0
          and abs(maps["native"]["mAP"] - maps["fp"]["mAP"]) <= 1e-3,
          f"eval --backend native against fp on the card: {maps}")
    for key, c in counts.items():
        if key.startswith("detector_heads") or key == "cmd_eval_fp":
            check(c["res_chain_rows"] > 0, f"native phase reference {key}: launches {c}")
        else:
            check(not any(c.values()), f"native phase {key}: CUDA launches {c}, want none")
    return counts


PARALLEL_STEPS, PARALLEL_TIMED = 3, 5
# the train phase's fp32 rule: losses, params a leaf, step and mu a leaf
FP32_TRAIN_TOL = {"loss": 1e-4, "params": 1e-3, "step": 0.5, "mu": 0.5}


def train_distances(a, b, layout, kept) -> dict:
    """Relative distances of two ``parallel_run`` records: each loss of
    each step, and per leaf (relative L2) the weights, their change and
    Adam's first moment over the ``kept`` leaves."""
    out = {}
    for i, (p, q) in enumerate(zip(a["losses"], b["losses"])):
        for k in ("total", "x", "y", "w", "h", "conf", "cls", "distill"):
            if k in q:
                out[f"loss/{k}/step{i}"] = abs(p[k] - q[k]) / abs(q[k])
    for w in ("params", "step", "mu"):
        va, vb = layout.views(a[w]), layout.views(b[w])
        for n in kept:
            out[f"{w}/{n}"] = rel_l2(va[n], vb[n])
    return out


def worst_by_part(d) -> dict:
    """The largest distance of each part (``loss``, ``params``, ...) and its key."""
    parts = {}
    for key, v in d.items():
        part = key.split("/")[0]
        if part not in parts or v > parts[part][1]:
            parts[part] = [key, v]
    return parts


def parallel_inputs():
    """The parallel and profile phases' data: the 256x320 preset (a 2-step
    warm-up floor, EMA), its zoo weights, and a global batch of 16 golden
    frames (net input) with their golden_map targets."""
    import dataclasses

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.models import load_variables

    preset = get_config("256x320")
    cfg = dataclasses.replace(preset, train=dataclasses.replace(
        preset.train, warmup_min_iters=2, ema_decay=0.999, ema_ramp=20))
    zoo = load_variables(os.path.join(WEIGHTS, "yolofastest_256x320.npz"))
    pre = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))["pre_imgs"][:16]
    x = (pre.astype(np.float32)[..., None] - 128.0) / 255.0
    return cfg, zoo, x, np.load(os.path.join(FIXTURES, "golden_map.npz"))["targets"][:16]


def parallel_run(trainer, x, t) -> dict:
    """``PARALLEL_STEPS`` steps of ``trainer`` on one batch (tensors on its
    device): the losses of each, and on the host in float64 the weights,
    their change over the steps, Adam's first moment and the statistics."""
    import torch

    def host(v):
        return v.detach().to("cpu", torch.float64, copy=True)

    start = host(trainer.state.params)
    losses = [{k: float(v) for k, v in trainer.step(x, t).items()}
              for _ in range(PARALLEL_STEPS)]
    s = trainer.state
    return {"losses": losses, "params": host(s.params), "step": host(s.params) - start,
            "mu": host(s.mu), "batch_stats": host(s.batch_stats)}


def timed_steps(trainer, x, t, barrier=None, reps: int = PARALLEL_TIMED) -> float:
    """Steps per second over ``reps`` steps after one warm step, the card
    synchronised (and the ranks met) at both ends."""
    import torch

    trainer.step(x, t)
    torch.cuda.synchronize()
    if barrier:
        barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.step(x, t)
    torch.cuda.synchronize()
    if barrier:
        barrier()
    return reps / (time.perf_counter() - t0)


def parallel_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of the ``parallel`` phase, a spawned process on the one card
    (gloo): the float64 run and the fp32 distillation run on its shard of
    the global batch, the fp32 run's launches, save and resume, and its
    steps/s; all written to ``<out_dir>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from yolofastest_torch.kernels import LAUNCHES, reset_launch_counts
    from yolofastest_torch.parallel import init_distributed, make_mesh, shard_batch
    from yolofastest_torch.train import Trainer, make_teacher_fn

    torch.set_num_threads(1)  # the ranks share the host's cores with this process
    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(devices=["cuda:0"])
    cfg, zoo, x, t = parallel_inputs()
    xs, ts = shard_batch(mesh, x, t)
    out = {"backend": dist.get_backend(), "device": str(mesh.device), "ranks": mesh.size,
           "local_batch": int(xs.shape[0])}
    t64 = Trainer(cfg, mesh=mesh, batch_per_epoch=1, variables=zoo).to_float64()
    out["float64"] = parallel_run(t64, xs.double(), ts.double())
    teacher = make_teacher_fn(zoo, device=mesh.device)
    t32 = Trainer(cfg, mesh=mesh, batch_per_epoch=1, variables=zoo, distill_fn=teacher)
    reset_launch_counts()
    out["fp32"] = parallel_run(t32, xs, ts)
    torch.cuda.synchronize()
    out["launches"] = dict(LAUNCHES)

    path = t32.save_checkpoint(os.path.join(out_dir, "ckpt"), epoch=0)
    fresh = Trainer(cfg, mesh=mesh, batch_per_epoch=1, seed=1, distill_fn=teacher)
    fresh.restore_checkpoint(path)

    def same():
        return (fresh.state.step == t32.state.step
                and all(torch.equal(getattr(t32.state, f), getattr(fresh.state, f))
                        for f in ("params", "batch_stats", "mu", "nu", "count"))
                and all(torch.equal(a, b) for a, b in zip(t32.state.ema, fresh.state.ema)))

    out["restored_equal"] = same()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for tr in (t32, fresh):
            tr.step(xs, ts)
    out["resumed_step_equal"] = same()
    out["steps_per_s"] = timed_steps(t32, xs, ts, dist.barrier)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def parallel_path(card, counted) -> dict:
    """The ``parallel`` phase: data parallelism over a process group on the
    one card.  Two spawned ranks (gloo: NCCL refuses two ranks on one
    device), each with 8 of a global batch of 16 golden frames, at full
    width from the 256x320 zoo: 3 float64 steps equal to one process at
    B=16 to 1e-9 a leaf; 3 fp32 steps distilling from the folded teacher (6
    K2 launches a step on each rank), held to one process by the ``train``
    phase's fp32 rule, or past it by that process's own distance from one
    on the CPU (below); save from the live group and resume bit for bit (and
    one step after); the ranks' steps/s beside one process at the same
    global batch.  Then this process joins a one-rank NCCL group, steps
    once and reduces once.  Returns the launch counts of each run."""
    import multiprocessing
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    from yolofastest_torch.parallel import init_distributed, make_mesh
    from yolofastest_torch.train import Trainer, make_teacher_fn

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    cfg, zoo, x, t = parallel_inputs()
    xd, tgt = torch.from_numpy(x).cuda(), torch.from_numpy(t).cuda()
    one = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="yf_parallel_") as td:
        port = free_port()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=parallel_rank, args=(r, 2, port, td)) for r in range(2)]
        for p in procs:
            p.start()
        try:
            # one process at the global batch, while the ranks start
            t64 = Trainer(cfg, batch_per_epoch=1, variables=zoo, device="cuda").to_float64()
            one["float64"] = parallel_run(t64, xd.double(), tgt.double())
            t32 = Trainer(cfg, batch_per_epoch=1, variables=zoo, device="cuda",
                          distill_fn=make_teacher_fn(zoo, device="cuda"))
            one["fp32"], one["launches"] = counted(lambda: parallel_run(t32, xd, tgt))
            for p in procs:
                p.join(timeout=600)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0, 0], f"parallel: rank exit codes {codes}")
        ranks = [torch.load(os.path.join(td, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    ranks_s = time.perf_counter() - t0
    one["steps_per_s"] = timed_steps(t32, xd, tgt)

    # one process on the CPU, fp32: the reference pair of the train phase's rule
    cpu32 = Trainer(cfg, batch_per_epoch=1, variables=zoo, device="cpu",
                    distill_fn=make_teacher_fn(zoo, device="cpu"))
    one["fp32_cpu"] = parallel_run(cpu32, torch.from_numpy(x), torch.from_numpy(t))

    # Relative distances: each loss of each step, and per leaf (relative L2)
    # the weights, their change and Adam's first moment, over the leaves
    # whose float64 gradient is not zero.  float64: 1e-9.  fp32: the train
    # phase's rule (losses 1e-4, params 1e-3 a leaf, step and mu 0.5 a
    # leaf), which it set from one process on the card against one on the
    # CPU over two steps (one non-zero update).  Over three steps Adam's
    # sign-like early updates carry fp32 noise further, so a value over its
    # tolerance passes where it is at most FP32_NOISE_SLACK times as far
    # from one process on the card as that process is from the CPU's on the
    # same three steps.
    layout = t64.layouts[0]
    mu64 = layout.views(one["float64"]["mu"])
    total = float(np.sqrt(sum(float(v.norm()) ** 2 for v in mu64.values())))
    kept = [n for n, v in mu64.items() if float(v.norm()) >= 1e-9 * total]
    reference = {"one": one, "layout": layout, "kept": kept,
                 "noise": train_distances(one["fp32_cpu"], one["fp32"], layout, kept)}
    versus, f64_ok, f32_ok = versus_one_process(ranks, reference)

    # a one-rank NCCL group: the NCCL start, one step and one reduction
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh()
        solo = Trainer(cfg, mesh=mesh, batch_per_epoch=1, variables=zoo)
        loss = float(solo.step(xd[:8], tgt[:8])["total"])
        probe = torch.ones(1, device=mesh.device)
        dist.all_reduce(probe)
        nccl = {"backend": dist.get_backend(), "device": str(mesh.device), "ranks": mesh.size,
                "loss": loss, "all_reduce": float(probe)}
    finally:
        dist.destroy_process_group()

    per_rank = [{k: r[k] for k in ("backend", "device", "ranks", "local_batch", "launches",
                                   "restored_equal", "resumed_step_equal", "steps_per_s")}
                for r in ranks]
    emit("parallel", card=card, res="256x320", weights="yolofastest_256x320.npz",
         global_batch=16, steps=PARALLEL_STEPS, kept_leaves=len(kept), ranks=per_rank,
         one_process={"batch": 16, "launches": one["launches"],
                      "steps_per_s": one["steps_per_s"]},
         steps_per_s_note=f"fp32 with distillation, {PARALLEL_TIMED} steps after a warm one; "
                          "the ranks between two barriers",
         versus_one_process=versus,
         tolerance="float64: losses, statistics and every kept leaf (params, step, mu) "
                   "1e-9; fp32: losses 1e-4, params 1e-3 a leaf, step and mu 0.5 a leaf, "
                   f"or at most {FP32_NOISE_SLACK} x one process's distance card vs CPU "
                   "(over_tolerance: key, distance, card vs CPU); the ranks bit for bit",
         nccl=nccl, seconds=ranks_s)
    for r in per_rank:
        check(r["backend"] == "gloo" and r["device"] == "cuda:0" and r["local_batch"] == 8,
              f"parallel rank {r}")
        check(r["launches"]["res_chain_rows"] == 6 * PARALLEL_STEPS
              and r["launches"]["nms"] == 0 and r["launches"]["res_chain_cf"] == 0,
              f"parallel rank launches {r['launches']}: want 6 chains a step")
        check(r["restored_equal"] and r["resumed_step_equal"], f"parallel resume {r}")
    check(one["launches"]["res_chain_rows"] == 6 * PARALLEL_STEPS,
          f"one process launches {one['launches']}")
    check(versus["float64"]["ranks_bit_equal"] and versus["fp32"]["ranks_bit_equal"],
          f"parallel ranks differ: {versus}")
    check(f64_ok, f"two ranks vs one process in float64: {versus['float64']}")
    check(f32_ok, f"two ranks vs one process in fp32: {versus['fp32']}")
    check(nccl["backend"] == "nccl" and np.isfinite(nccl["loss"]) and nccl["all_reduce"] == 1.0,
          f"one-rank NCCL group: {nccl}")
    return {"parallel_rank0": ranks[0]["launches"], "parallel_rank1": ranks[1]["launches"],
            "parallel_one_process": one["launches"]}, reference


def versus_one_process(ranks, reference):
    """The ranks' float64 and fp32 ``parallel_run`` records against one
    process's (``reference``): float64 every distance within 1e-9; fp32 by
    the train phase's rule, or past it by at most ``FP32_NOISE_SLACK`` times
    one process's distance card vs CPU; the ranks bit for bit.  Returns
    (versus, float64 ok, fp32 ok)."""
    import torch

    one, layout, kept, noise = (reference[k] for k in ("one", "layout", "kept", "noise"))
    r0 = ranks[0]
    versus = {}
    for dt in ("float64", "fp32"):
        d = train_distances(r0[dt], one[dt], layout, kept)
        versus[dt] = {"worst": worst_by_part(d),
                      "batch_stats_rel": rel_l2(r0[dt]["batch_stats"], one[dt]["batch_stats"]),
                      "ranks_bit_equal": all(torch.equal(r0[dt][f], r[dt][f]) for r in ranks[1:]
                                             for f in ("params", "batch_stats", "mu"))}
    d32 = train_distances(r0["fp32"], one["fp32"], layout, kept)
    over = [[k, v, noise[k]] for k, v in d32.items() if v > FP32_TRAIN_TOL[k.split("/")[0]]]
    versus["fp32"].update(over_tolerance=over, card_vs_cpu_worst=worst_by_part(noise))
    f64_ok = (versus["float64"]["batch_stats_rel"] <= 1e-9
              and all(v <= 1e-9 for v in train_distances(r0["float64"], one["float64"], layout,
                                                          kept).values()))
    f32_ok = all(v <= FP32_NOISE_SLACK * n for _, v, n in over)
    return versus, f64_ok, f32_ok


SPATIAL_DETECT = {4: ((2, 2), "512x640"), 2: ((1, 2), "256x320")}  # world -> mesh, res
SPATIAL_DETECT_REPS = 5
SPATIAL_TIMED = 2  # timed fp32 steps on the ranks (~3 s each on one card)


def spatial_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of the ``spatial`` phase, a spawned process on the one card
    (gloo).  Four ranks make a (2, 2) mesh and two a (1, 2) mesh.  The rank
    runs the sharded detect pipeline (``Detector(mesh=...)``) on its shard of
    the 20 golden frames (512x640 on (2, 2), 256x320 on (1, 2)) with its
    kernel launches, halo exchanges and the planes the chain kernel saw,
    then its detect images/s; then the parallel phase's float64 and fp32
    distillation runs with ``shard_spatial=True`` on its shard of the global
    batch (the teacher on the spatial executor) and the fp32 run's launches
    and steps/s.  All written to ``<out_dir>/w<world>r<rank>.pt``."""
    import torch
    import torch.distributed as dist

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector, detections_to_lists
    from yolofastest_torch.kernels import LAUNCHES, reset_launch_counts
    from yolofastest_torch.models import FoldedExecutor, load_variables
    from yolofastest_torch.ops import normalize
    from yolofastest_torch.parallel import EXCHANGES, init_distributed, make_mesh, shard_batch
    from yolofastest_torch.train import Trainer, make_teacher_fn

    torch.set_num_threads(1)  # the ranks share the host's cores with this process
    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    shape, res = SPATIAL_DETECT[world]
    mesh = make_mesh(*shape, devices=["cuda:0"])
    out = {"backend": dist.get_backend(), "device": str(mesh.device), "mesh": list(shape),
           "place": [mesh.data_index, mesh.spatial_index]}

    planes = []
    saved = FoldedExecutor.__dict__["chain_fn"]  # the staticmethod itself

    def recording_chain(x, *weights):
        planes.append(list(x.shape))
        return saved.__func__(x, *weights)

    det = Detector(get_config(res), variables=load_variables(
        os.path.join(WEIGHTS, f"yolofastest_{res}.npz")), mesh=mesh)
    pre = np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))["pre_imgs"]
    x = normalize(shard_batch(mesh, torch.from_numpy(pre), spatial=True))[..., None]
    FoldedExecutor.chain_fn = staticmethod(recording_chain)
    reset_launch_counts()
    EXCHANGES.clear()
    try:
        dets = det.run(x)
        torch.cuda.synchronize()
    finally:
        FoldedExecutor.chain_fn = saved
    out["detect"] = {"res": res, "rows": list(x.shape), "launches": dict(LAUNCHES),
                     "exchanges": dict(EXCHANGES), "chain_planes": planes,
                     "lists": detections_to_lists(dets),
                     "count": dets["count"].cpu(), "boxes": dets["boxes"].cpu()}
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(SPATIAL_DETECT_REPS):
        det.run(x)
    torch.cuda.synchronize()
    dist.barrier()
    out["detect"]["images_per_s"] = SPATIAL_DETECT_REPS * len(pre) / (time.perf_counter() - t0)

    cfg, zoo, x, t = parallel_inputs()
    xs, ts = shard_batch(mesh, x, spatial=True), shard_batch(mesh, t)
    out["local_batch"] = list(xs.shape)
    t64 = Trainer(cfg, mesh=mesh, batch_per_epoch=1, variables=zoo,
                  shard_spatial=True).to_float64()
    out["float64"] = parallel_run(t64, xs.double(), ts.double())
    teacher = make_teacher_fn(zoo, device=mesh.device, rows=mesh.rows)
    t32 = Trainer(cfg, mesh=mesh, batch_per_epoch=1, variables=zoo, distill_fn=teacher,
                  shard_spatial=True)
    reset_launch_counts()
    out["fp32"] = parallel_run(t32, xs, ts)
    torch.cuda.synchronize()
    out["launches"] = dict(LAUNCHES)
    out["steps_per_s"] = timed_steps(t32, xs, ts, dist.barrier, SPATIAL_TIMED)
    torch.save(out, os.path.join(out_dir, f"w{world}r{rank}.pt"))
    dist.destroy_process_group()


def shard_plane_rows(h: int, n: int, i: int, k: int) -> int:
    """Rows of the plane a chain of K blocks sees on spatial rank ``i`` of
    ``n`` at a level of ``h`` rows: its own rows and up to K rows on each
    side, clipped at the image's edges."""
    own = h // n
    return own + min(k, i * own) + min(k, (n - 1 - i) * own)


def spatial_path(card, counted, reference, n_sm) -> dict:
    """The ``spatial`` phase: the mesh's spatial axis on the one card (gloo
    ranks, as the parallel phase).  Four ranks on (2, 2) and two on (1, 2)
    run at once (:func:`spatial_rank`), and the dry run's four processes
    beside them (JAX's rule: a (2, 2) mesh with ``shard_spatial=True``).
    Checks: the sharded detect pipeline's counts equal one process's
    Detector and its boxes within 1e-3, golden 33/33 (512x640, (2, 2)) and
    34/34 (256x320, (1, 2)), 6 chain launches, 1 NMS, 17 halo exchanges and
    1 gather a forward on each rank; the chain kernel on every row-shard
    plane of these meshes and of the dry run against its plain version;
    float64 steps equal to one process to 1e-9 and fp32 distillation steps
    by the parallel phase's rule, with 6 chain launches a step on each rank
    and the ranks bit for bit.  Times: the chain kernel on each shard plane
    beside the whole plane, and the ranks' detect images/s and steps/s
    beside one process's, as a correctness path's (gloo on one card)."""
    import multiprocessing
    import signal
    import socket
    import tempfile

    import torch

    from torch_timing import cuda_ms
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector, detections_to_lists
    from yolofastest_torch.kernels import res_block as rb
    from yolofastest_torch.models import RES_CHAINS, fold_batchnorm, load_variables
    from yolofastest_torch.ops import normalize

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    t0 = time.perf_counter()
    dryrun = subprocess.Popen([sys.executable, "-m", "yolofastest_torch.parallel.dryrun",
                               "--processes", "4", "--device", "cuda"], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
    try:
        with tempfile.TemporaryDirectory(prefix="yf_spatial_") as td:
            ctx = multiprocessing.get_context("spawn")
            procs = []
            for world in (4, 2):
                port = free_port()
                procs += [ctx.Process(target=spatial_rank, args=(r, world, port, td))
                          for r in range(world)]
            for p in procs:
                p.start()
            try:
                # one process: the Detector at both sizes, while the ranks start
                one = {}
                for res in ("512x640", "256x320"):
                    det = Detector(get_config(res), variables=load_variables(
                        os.path.join(WEIGHTS, f"yolofastest_{res}.npz")), device="cuda")
                    pre = np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))["pre_imgs"]
                    x = normalize(torch.from_numpy(pre).cuda())[..., None]
                    dets, launches = counted(lambda: det.run(x))
                    one[res] = {"dets": dets, "det": det, "x": x, "launches": launches}
                for p in procs:
                    p.join(timeout=600)
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                        p.join()
            codes = [p.exitcode for p in procs]
            check(codes == [0] * 6, f"spatial: rank exit codes {codes}")
            ranks = {world: [torch.load(os.path.join(td, f"w{world}r{r}.pt"), weights_only=False)
                             for r in range(world)] for world in (4, 2)}
        dry_out, _ = dryrun.communicate(timeout=600)
    finally:  # the launcher and its four workers, also when a check above failed
        if dryrun.poll() is None:
            os.killpg(dryrun.pid, signal.SIGKILL)
            dryrun.wait()
    ranks_s = time.perf_counter() - t0

    # the detect pipeline: each data place's result (its first spatial rank)
    # against one process, and the golden boxes
    detect = {}
    for world, rs in ranks.items():
        (n_data, n_spatial), res = SPATIAL_DETECT[world]
        lead = rs[::n_spatial]
        count = torch.cat([r["detect"]["count"] for r in lead])
        boxes = torch.cat([r["detect"]["boxes"] for r in lead])
        ref = {k: v.cpu() for k, v in one[res]["dets"].items()}
        box_err = max((float((boxes[i, :n] - ref["boxes"][i, :n]).abs().max())
                       for i, n in enumerate(count.tolist()) if n), default=0.0)
        rows = [row for r in lead for row in r["detect"]["lists"]]
        fx = np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
        matched, notes = golden_match(rows, fx["boxes"], fx["pre_imgs"].shape[0])
        same = all(torch.equal(r["detect"]["count"], lead[i // n_spatial]["detect"]["count"])
                   and torch.equal(r["detect"]["boxes"], lead[i // n_spatial]["detect"]["boxes"])
                   for i, r in enumerate(rs))
        det, x = one[res]["det"], one[res]["x"]
        det.run(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(SPATIAL_DETECT_REPS):
            det.run(x)
        torch.cuda.synchronize()
        one_ips = SPATIAL_DETECT_REPS * x.shape[0] / (time.perf_counter() - t1)
        detect[f"{n_data}x{n_spatial}"] = {
            "res": res, "frames": int(fx["pre_imgs"].shape[0]),
            "rank_rows": [r["detect"]["rows"] for r in rs],
            "counts_equal": bool(torch.equal(count, ref["count"])), "max_box_err": box_err,
            "matched": matched, "reference": int(fx["boxes"].shape[0]), "notes": notes[:5],
            "spatial_ranks_agree": same,
            "launches": [r["detect"]["launches"] for r in rs],
            "exchanges": [r["detect"]["exchanges"] for r in rs],
            "chain_planes": [r["detect"]["chain_planes"] for r in rs],
            "images_per_s": rs[0]["detect"]["images_per_s"], "one_process_images_per_s": one_ips,
            "one_process_launches": one[res]["launches"]}

    # the chain kernel on the row-shard planes of these meshes and of the dry
    # run (64x96, two spatial ranks), against its plain version, fp32 and
    # bf16; timed beside the whole plane at 512x640
    folded = {res: fold_batchnorm(load_variables(os.path.join(WEIGHTS, f"yolofastest_{res}.npz")))
              for res in ("512x640", "256x320")}
    rng = np.random.default_rng(7)
    shard_checks, shard_timing = [], []
    for res, hw, b in (("512x640", (512, 640), 10), ("256x320", (256, 320), 20),
                       ("256x320", (64, 96), 2)):
        for names, (h, w) in zip(RES_CHAINS, chain_planes(hw)):
            st = [torch.from_numpy(a).cuda()
                  for a in rb.chain_weights_from_folded(folded[res], names)]
            k, c, inner = st[0].shape
            for i in range(2):
                hs = shard_plane_rows(h, 2, i, k)
                tile = rb.pick_tile(hs, w, c, inner, k, b, n_sm, 4)
                smem = rb.smem_bytes(hs, w, c, k, tile[0], tile[1], tile[2], 4, tile[3])
                xin = torch.from_numpy(
                    (rng.standard_normal((b * hs * w, c)) * 0.5).astype(np.float32)).cuda()
                for dt in (torch.float32, torch.bfloat16):
                    xd = xin.to(dt)
                    got = rb.fused_res_chain_rows(xd, *st, (hs, w)).float()
                    ref = rb.res_chain_rows_plain(xd, *st, (hs, w)).float()
                    err = float((got - ref).abs().max())
                    if dt == torch.float32:
                        ok = fp32_ratio(got, ref) <= 1.0
                        if not ok:
                            exact = rb.res_chain_float64(xd.reshape(b, hs, w, c), *st)
                            r_plain = fp32_ratio(ref.cpu().double(), exact.reshape(-1, c))
                            ok = (r_plain > 1.0 and fp32_ratio(got.cpu().double(), exact.reshape(
                                -1, c)) <= FLOAT64_SLACK * r_plain)
                    else:
                        ok = err <= BF16_TOL * float(ref.abs().max())
                    shard_checks.append({"plane": [b, hs, w, c], "of": [h, w], "I": inner,
                                         "K": k, "rank": i, "dtype": str(dt).split(".")[-1],
                                         "tile_chunk_cluster": list(tile), "smem_bytes": smem,
                                         "max_abs_err": err, "ok": bool(ok)})
                if res == "512x640" and i == 0:
                    whole = torch.from_numpy(
                        (rng.standard_normal((b * h * w, c)) * 0.5).astype(np.float32)).cuda()
                    shard_ms = cuda_ms(lambda: rb.fused_res_chain_rows(xin, *st, (hs, w)), 20)
                    whole_ms = cuda_ms(lambda: rb.fused_res_chain_rows(whole, *st, (h, w)), 20)
                    bound, by = chain_bound(b, hs, w, c, inner, k, "float32")
                    shard_timing.append({"chain": names[0], "B": b, "shard_plane": [hs, w],
                                         "whole_plane": [h, w], "shard_ms": shard_ms,
                                         "whole_ms": whole_ms, "shard_bound_ms": bound,
                                         "bound_by": by})
    torch.cuda.synchronize()

    # training: every rank against the parallel phase's one process
    train = {}
    for world, rs in ranks.items():
        versus, f64_ok, f32_ok = versus_one_process([r for r in rs], reference)
        train["x".join(map(str, SPATIAL_DETECT[world][0]))] = {
            "local_batch": rs[0]["local_batch"], "versus_one_process": versus,
            "float64_ok": f64_ok, "fp32_ok": f32_ok,
            "launches": [r["launches"] for r in rs],
            "steps_per_s": rs[0]["steps_per_s"]}
    dry_lines = [ln for ln in dry_out.splitlines() if ln.startswith(("MP_OK", "MP_RESUME_OK"))]
    seconds = time.perf_counter() - t0
    emit("spatial", card=card, detect=detect, train=train,
         one_process_steps_per_s=reference["one"]["steps_per_s"],
         chain_shards={"checks": len(shard_checks),
                       "failed": [c for c in shard_checks if not c["ok"]][:10],
                       "max_abs_err": {d: max(c["max_abs_err"] for c in shard_checks
                                              if c["dtype"] == d)
                                       for d in ("float32", "bfloat16")},
                       "planes": [c for c in shard_checks if c["dtype"] == "float32"],
                       "timing": shard_timing,
                       "timing_note": "fp32, B=10 (a data place of the (2, 2) mesh at "
                                      "512x640), spatial rank 0's plane beside the whole plane, "
                                      "CUDA events over 20 launches"},
         dryrun={"processes": 4, "rc": dryrun.returncode, "lines": dry_lines},
         tolerance="detect: counts equal, boxes 1e-3, golden by golden_match; chain: as the "
                   "kernels phase; train: as the parallel phase",
         seconds_ranks=ranks_s, seconds=seconds)
    for key, d in detect.items():
        check(d["counts_equal"] and d["max_box_err"] <= 1e-3 and d["spatial_ranks_agree"],
              f"spatial detect {key} against one process: {d}")
        check(d["matched"] == d["reference"] and not d["notes"],
              f"spatial golden {key}: {d['matched']}/{d['reference']} {d['notes']}")
        for launches, exchanges in zip(d["launches"], d["exchanges"]):
            check(launches == {"res_chain_rows": 6, "nms": 1, "res_chain_cf": 0},
                  f"spatial detect {key} launches {launches}: want 6 chains and 1 NMS")
            check(exchanges == {"halo": 17, "gather": 1},
                  f"spatial detect {key} exchanges {exchanges}")
    check(all(c["ok"] for c in shard_checks),
          f"chain kernel on row shards: {[c for c in shard_checks if not c['ok']][:3]}")
    for key, tr in train.items():
        check(tr["float64_ok"], f"spatial {key} vs one process in float64: "
                                f"{tr['versus_one_process']['float64']}")
        check(tr["fp32_ok"], f"spatial {key} vs one process in fp32: "
                             f"{tr['versus_one_process']['fp32']}")
        check(all(v["ranks_bit_equal"] for v in tr["versus_one_process"].values()),
              f"spatial {key}: the ranks differ")
        for launches in tr["launches"]:
            check(launches == {"res_chain_rows": 6 * PARALLEL_STEPS, "nms": 0,
                               "res_chain_cf": 0},
                  f"spatial {key} train launches {launches}: want 6 chains a step")
    dry_ok = [any(ln.startswith(f"MP_OK rank={r} backend=gloo device=cuda")
                  and "mesh=2x2 rows=(32, 96)" in ln for ln in dry_lines)
              and f"MP_RESUME_OK rank={r}" in dry_out for r in range(4)]
    check(dryrun.returncode == 0 and all(dry_ok),
          f"spatial dry run (4 processes): {dry_out[-3000:]}")
    return {"spatial_rank0": ranks[4][0]["detect"]["launches"],
            "shard_timing": shard_timing,
            "shard_max_abs_err": max(c["max_abs_err"] for c in shard_checks
                                     if c["dtype"] == "float32")}


# The finetune phase's sizes: the determinism runs, and the full-scale
# recipe cut to the first steps of its first epoch (the recipe: 30 epochs of
# 500 steps; its whole run is docs/train_demo_fullscale_torch/).
FINETUNE_DET_STEPS = 20
FULLSCALE_STEPS = 200


class FirstBatches:
    """A loader's first ``n`` batches, as an epoch of ``n`` steps."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.n:
                return
            yield batch


def finetune_path(card, counted) -> dict:
    """The pseudo-GT fine-tune set (``tools/torch_make_finetune_set.py``)
    and the round-4 training recipes on the card: two fed runs of 20 steps
    from one state on the same augmented batches, fp32 and bf16, and two
    20-step QAT runs with the 256x320 int8 recipe's flags, each pair bit
    for bit; the prune040 recipe at full depth through the ``prune`` and
    ``train`` commands (60 epochs x 20 steps with EMA; the phase validates
    every epoch and caches the decoded images, which leaves the batches as
    they are), its EMA model's golden fp32 recall through the folded graph
    (6 chain launches a forward) and its pure int8 recall; the full-scale
    recipe from random init on the ``--copies 400`` set, cut to the first
    200 steps of its first epoch; the lite-512 zoo scored on the tool's
    512x640 val set through the fp Detector and the native engine.  One
    JSON line; returns the launch counts of each run."""
    import contextlib
    import dataclasses
    import io
    import re
    import tempfile

    import torch

    import torch_make_finetune_set
    from yolofastest_torch.cli import main as cli_main
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.data import DetectionLoader, VOCIndex
    from yolofastest_torch.eval import MAPEvaluator, make_backend_eval_fn
    from yolofastest_torch.eval.golden import fp_recall, golden_inputs, int8_recalls
    from yolofastest_torch.export import save_native_weights
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.models import fold_batchnorm, load_variables
    from yolofastest_torch.native import NativeEngine, find_library
    from yolofastest_torch.quant import calibrate
    from yolofastest_torch.quant.qat import qat_finetune
    from yolofastest_torch.quant.recipes import make_scales
    from yolofastest_torch.train import Trainer, checkpoint_variables
    from yolofastest_torch.utils.logging import LineLog

    t_phase = time.perf_counter()
    seconds, counts = {}, {}
    zoo_path = os.path.join(WEIGHTS, "yolofastest_256x320.npz")
    zoo = load_variables(zoo_path)
    preset = get_config("256x320")

    def recipe_config(**train):
        return dataclasses.replace(preset, train=dataclasses.replace(preset.train, **train))

    def same(a, b) -> bool:
        return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    def log_values(path, pattern):
        with open(path) as f:
            return [float(m.group(1)) for m in re.finditer(pattern, f.read())]

    def quiet(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return cli_main(argv)

    with tempfile.TemporaryDirectory(prefix="yf_finetune_") as td:
        # ------------------------------------------------- the sets
        t0 = time.perf_counter()
        sets = {name: torch_make_finetune_set.write_set(os.path.join(td, name), copies, res,
                                                        log=lambda _: None)
                for name, copies, res in (("ft040", 16, "256x320"), ("ft8000", 400, "256x320"),
                                          ("ft512", 1, "512x640"))}
        seconds["sets"] = time.perf_counter() - t0
        check(sets == {"ft040": {"train": 320, "val": 20}, "ft8000": {"train": 8000, "val": 20},
                       "ft512": {"train": 19, "val": 19}}, f"fine-tune sets {sets}")
        frame = os.path.join(td, "ft8000", "train", "img", "Cloud_2m_4089_c00.jpg")
        links = os.stat(frame).st_nlink

        # ----------------------------------------------- determinism
        # two runs from one state on the same batches (the loader's first
        # 20 over the --copies 16 set, augmentation on), compared bit for
        # bit: the weights, the statistics, both moments and the EMA
        t0 = time.perf_counter()
        det_cfg = recipe_config(batch_size=16, ema_decay=0.9995, warmup_min_iters=60,
                                total_epochs=60)
        index = VOCIndex(os.path.join(td, "ft040", "train"), preset.io.class_names)
        batches = []
        for b in DetectionLoader(index, det_cfg, seed=0):
            batches.append(b)
            if len(batches) == FINETUNE_DET_STEPS:
                break
        determinism = {}
        for dt in (torch.float32, torch.bfloat16):
            runs = []
            for _ in range(2):
                t = Trainer(det_cfg, batch_per_epoch=20, variables=zoo, compute_dtype=dt,
                            device="cuda")
                losses = torch.stack([t.step(*b)["total"] for b in batches])
                s = t.state
                runs.append([losses, s.params.detach(), s.batch_stats, s.mu, s.nu, *s.ema])
            equal = [same(a, b) for a, b in zip(*runs)]
            determinism[str(dt).split(".")[-1]] = {
                "steps": len(batches), "bit_equal": all(equal),
                "equal_by_part": dict(zip(("losses", "params", "batch_stats", "mu", "nu",
                                           "ema_params", "ema_batch_stats"), equal)),
                "last_loss": float(runs[0][0][-1])}
        imgs, golden = golden_inputs("256x320")
        folded = fold_batchnorm(zoo)
        scales = make_scales(folded, imgs, "amax8", "cuda")
        qat = []
        for _ in range(2):
            (best, hist, snaps), counts[f"qat_{len(qat)}"] = counted(lambda: qat_finetune(
                folded, scales, [imgs[i:i + 4] for i in range(0, len(imgs), 4)],
                steps=FINETUNE_DET_STEPS, lr=5e-5, conf_weight=4.0,
                snapshot_every=FINETUNE_DET_STEPS, device="cuda"))
            qat.append((hist, snaps[0]))
        qat_equal = qat[0][0] == qat[1][0] and all(
            np.array_equal(qat[0][1][n][k], qat[1][1][n][k]) for n in qat[0][1]
            for k in qat[0][1][n])
        determinism["qat"] = {"steps": FINETUNE_DET_STEPS, "batch": 4, "bit_equal": qat_equal,
                              "losses": [qat[0][0][0], qat[0][0][-1]],
                              "launches": counts["qat_0"]}
        seconds["determinism"] = time.perf_counter() - t0

        # --------------------------------------- the prune040 recipe
        # tools/torch_run_prune040_zoo.sh's commands at full depth, the
        # config validating every epoch (the recipe's preset from epoch 5)
        # and the decoded images cached (the same batches; uncached, the
        # loader's decoding set the pace: 6.7 steps/s on the H100's host)
        t0 = time.perf_counter()
        pruned = os.path.join(td, "pruned040.npz")
        check(quiet(["prune", "--config", "256x320", "--weights", zoo_path, "--ratio", "0.4",
                     "--out", pruned]) == 0, "prune failed")
        every_epoch = os.path.join(td, "256x320_every_epoch.json")
        with open(every_epoch, "w") as f:
            f.write(recipe_config(val_after_epoch=-1).to_json())
        ck, logs = os.path.join(td, "ck040"), os.path.join(td, "prune040_logs")
        rc, counts["prune040_train"] = counted(lambda: quiet([
            "train", "--config-json", every_epoch,
            "--train-dir", os.path.join(td, "ft040", "train"),
            "--val-dir", os.path.join(td, "ft040", "val"), "--pretrained", pruned,
            "--epochs", "60", "--batch-size", "16", "--warmup-min-iters", "60", "--ema",
            "--cache-images", "--checkpoint-dir", ck, "--log-dir", logs, "--max-to-keep", "3"]))
        check(rc == 0, "prune040 train failed")
        info = os.path.join(logs, "train_info.log")
        maps = log_values(info, r"mean AP: ([0-9.]+)")
        rates = log_values(info, r"detection rate: ([0-9.]+)")
        kept = sorted(os.listdir(ck), key=lambda d: int(d.split("_")[1]))
        variables = checkpoint_variables(os.path.join(ck, kept[-1]))  # EMA preferred
        (fp_hit, n_golden), counts["prune040_golden"] = counted(
            lambda: fp_recall(variables, preset, "cuda"))
        pfolded = fold_batchnorm(variables)
        int8_hit = int8_recalls(pfolded, calibrate(pfolded, [imgs], device="cuda"), (), preset,
                                imgs, golden, "cuda")[0]
        prune040 = {"epochs": 60, "steps": 1200, "mAP_lines": len(maps),
                    "mAP_first_last": [maps[0], maps[-1]] if maps else None,
                    "detection_rate_last": rates[-1] if rates else None,
                    "checkpoints": kept, "golden_fp32_recall": [fp_hit, n_golden],
                    "jax_golden_fp32_recall": [34, 34], "golden_int8_recall": [int8_hit, n_golden],
                    "launches_train": counts["prune040_train"],
                    "launches_golden": counts["prune040_golden"]}
        seconds["prune040"] = time.perf_counter() - t0

        # ---------------- the full-scale recipe, the start of its first epoch
        t0 = time.perf_counter()
        full_cfg = recipe_config(batch_size=16, total_epochs=30, val_after_epoch=-1,
                                 max_to_keep=2)
        log = LineLog()
        index = VOCIndex(os.path.join(td, "ft8000", "train"), preset.io.class_names)
        loader = DetectionLoader(index, full_cfg, seed=full_cfg.train.seed, cache=True)
        val = DetectionLoader(VOCIndex(os.path.join(td, "ft8000", "val"), preset.io.class_names),
                              full_cfg, augment=False, shuffle=False, drop_last=False)
        trainer = Trainer(full_cfg, batch_per_epoch=len(loader), logger=log, device="cuda")
        ck8000 = os.path.join(td, "ck8000")
        history, counts["fullscale"] = counted(lambda: trainer.fit(
            FirstBatches(loader, FULLSCALE_STEPS), total_epochs=1, checkpoint_dir=ck8000,
            validator=MAPEvaluator(full_cfg, val, logger=log, device="cuda")))
        losses = [float(ln.split("loss = ")[1].split(",")[0]) for ln in log.lines
                  if "loss = " in ln]
        fullscale = {"steps": FULLSCALE_STEPS, "recipe_steps_per_epoch": len(loader),
                     "recipe_epochs": 30, "losses_first_last": losses[:1] + losses[-1:],
                     "loss_logs": len(losses), "mAP": [h.get("mAP") for h in history],
                     "checkpoints": sorted(os.listdir(ck8000)),
                     "launches": counts["fullscale"]}
        seconds["fullscale"] = time.perf_counter() - t0

        # ------------------- the lite-512 zoo on the tool's 512x640 val set
        t0 = time.perf_counter()
        lite_cfg = get_config("lite-512x640")
        lite = load_variables(os.path.join(WEIGHTS, "yolofastest_lite_512x640.npz"))
        val512 = DetectionLoader(VOCIndex(os.path.join(td, "ft512", "val"),
                                          lite_cfg.io.class_names),
                                 lite_cfg, augment=False, shuffle=False, drop_last=False)
        yfb = os.path.join(td, "lite512.yfb")
        save_native_weights(fold_batchnorm(lite), yfb, io_config=lite_cfg.io)
        engines = {"fp": Detector(lite_cfg, variables=lite, arch="lite", device="cuda"),
                   "native": NativeEngine(yfb, lite_cfg, library_path=find_library()[0])}
        lite512 = {}
        for name, engine in engines.items():
            ev = MAPEvaluator(lite_cfg, val512, logger=LineLog(),
                              eval_fn=make_backend_eval_fn(engine, max_det=lite_cfg.io.max_det))
            m, counts[f"lite512_{name}"] = counted(lambda: ev(None))
            lite512[name] = {"mAP": m, "detection_rate": ev.last_metrics["detection_rate"],
                             "launches": counts[f"lite512_{name}"]}
        seconds["lite512"] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase

    emit("finetune", card=card, sets=sets, links_of_a_frame=links, determinism=determinism,
         prune040=prune040, fullscale=fullscale, lite512=lite512, seconds=seconds,
         tolerance="determinism: bit for bit; prune040 golden fp32 recall >= 32/34 (JAX 34/34); "
                   "lite512 mAP and detection rate >= 0.95 on each backend")
    for name, d in determinism.items():
        check(d["bit_equal"], f"two {name} runs from one state differ: {d}")
    n_val = -(-20 // 16)  # val batches of the recipe's loader
    check(len(maps) == 60 and len(rates) == 60, f"prune040: {len(maps)} mAP lines, want 60")
    check(kept == ["epoch_57", "epoch_58", "epoch_59"], f"prune040 checkpoints {kept}")
    check(counts["prune040_train"]["nms"] == 60 * n_val
          and counts["prune040_train"]["res_chain_rows"] == 0,
          f"prune040 launches {counts['prune040_train']}: want one NMS a val batch")
    check(fp_hit >= 32, f"prune040 golden fp32 recall {fp_hit}/{n_golden}, want >= 32")
    check(counts["prune040_golden"]["res_chain_rows"] == 6
          and counts["prune040_golden"]["nms"] == 1,
          f"prune040 golden launches {counts['prune040_golden']}: want 6 chains, 1 NMS")
    check(all(c["res_chain_rows"] == 30 for k, c in counts.items() if k.startswith("qat_")),
          f"QAT teacher launches {counts}: want 6 chains a batch of 4")
    check(len(losses) == FULLSCALE_STEPS // 10 and all(np.isfinite(losses))
          and np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"full-scale epoch losses {losses[:5]} ... {losses[-5:]}")
    check(len(history) == 1 and "mAP" in history[0] and fullscale["checkpoints"] == ["epoch_0"],
          f"full-scale epoch: {history}, {fullscale['checkpoints']}")
    check(counts["fullscale"]["nms"] == n_val, f"full-scale launches {counts['fullscale']}")
    for name, r in lite512.items():
        check(r["mAP"] >= 0.95 and r["detection_rate"] >= 0.95, f"lite512 {name}: {r}")
    n512 = -(-19 // lite_cfg.train.batch_size)
    check(counts["lite512_fp"]["res_chain_rows"] == 6 * n512
          and counts["lite512_fp"]["nms"] == n512, f"lite512 fp launches {counts['lite512_fp']}")
    check(not any(counts["lite512_native"].values()),
          f"the native engine launched {counts['lite512_native']}")
    return counts


def demos_path(card, counted) -> dict:
    """Short forms of ``tools/torch_run_train_demos.py``'s demos through the
    ``train`` command: ``freeze`` (one epoch of 20 steps; the 48 pinned
    modules bit-equal to the zoo, both heads moved), ``multiscale`` (two
    epochs of 20 steps at B=8 on the demo's 160-item set: every bucket ran,
    the bucket of each batch equals the loader's sequence drawn on the host;
    and at each bucket's shape two float64 steps from the zoo on the card
    and on the CPU: the losses, the statistics, and per leaf the weights'
    step and Adam's first moment within 1e-9 relative L2, as the train
    phase holds them),
    ``scratch`` (random init, 2 epochs of 2 steps on a ``--copies 2`` set,
    validating each epoch: ``--resume latest`` from epoch_0 equals the
    uninterrupted run bit for bit, its metrics and validation too),
    ``distill`` (one epoch of each arm from one init: 6 chain launches a step
    for the teacher, none in the control) and ``lite512`` (one epoch of the
    lite architecture at 512x640 from the lite seed, with its validation).
    One JSON line; returns the launch counts of each run."""
    import contextlib
    import dataclasses
    import io
    import re
    import shutil
    import tempfile

    import torch_run_train_demos as demos
    import torch

    from yolofastest_torch.cli import main as cli_main
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.data import DetectionLoader, VOCIndex
    from yolofastest_torch.models import load_variables
    from yolofastest_torch.train import Trainer

    t_phase = time.perf_counter()
    seconds, counts, out = {}, {}, {}
    zoo = os.path.join(WEIGHTS, "yolofastest_256x320.npz")

    def train(name, argv):
        rec = {}
        with demos.watch_trainer(rec), contextlib.redirect_stdout(io.StringIO()):
            rc, counts[name] = counted(lambda: cli_main(argv + ["--device", "cuda"]))
        check(rc == 0, f"demos {name}: train exited {rc}")
        return rec

    def preset_json(path, preset, **train_fields):
        cfg = get_config(preset)
        with open(path, "w") as f:
            f.write(dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, **train_fields)).to_json())
        return path

    with tempfile.TemporaryDirectory(prefix="yf_demos_") as td:
        sets = {}
        for res, copies in (("256x320", 16), ("256x320", 8), ("256x320", 2), ("512x640", 16)):
            d = demos.set_dir(td, res, copies)
            with contextlib.redirect_stdout(io.StringIO()):
                demos.run_tool(["tools/torch_make_finetune_set.py", "--out", d, "--copies",
                                str(copies), "--res", res])
            sets[(res, copies)] = (os.path.join(d, "train"), os.path.join(d, "val"))

        def data(res, copies):
            return ["--train-dir", sets[(res, copies)][0], "--val-dir", sets[(res, copies)][1]]

        def run_dirs(name):
            return ["--checkpoint-dir", os.path.join(td, name, "ck"), "--log-dir",
                    os.path.join(td, name, "logs")]

        # ------------------------------------------------ freeze, one epoch
        t0 = time.perf_counter()
        rec = train("freeze", ["train", "--config", "256x320", "--epochs", "1", "--batch-size",
                               "16", "--warmup-min-iters", "60", "--freeze", "backbone",
                               "--cache-images", "--pretrained", zoo, *data("256x320", 16),
                               *run_dirs("freeze")])
        f = demos.freeze_check(os.path.join(td, "freeze", "logs", "train_info.log"),
                               os.path.join(td, "freeze", "ck", "epoch_0"), zoo)
        out["freeze"] = {"steps": len(rec["hw"]), "pinned": len(f["pinned"]),
                         "pinned_bit_equal": f["pinned_bit_equal"], "moved": f["moved"],
                         "launches": counts["freeze"]}
        seconds["freeze"] = time.perf_counter() - t0

        # ------------------------------------- multiscale, two epochs at B=8
        t0 = time.perf_counter()
        rec = train("multiscale", ["train", "--config", "256x320", "--epochs", "2",
                                   "--batch-size", "8", "--warmup-min-iters", "100",
                                   "--multiscale", "1", "--cache-images", "--pretrained", zoo,
                                   *data("256x320", 8), *run_dirs("multiscale")])
        again = demos.loader_buckets(sets[("256x320", 8)][0], get_config("256x320"), 8, 2)
        hw = rec["hw"]
        with open(os.path.join(td, "multiscale", "logs", "train_info.log")) as f:
            line = re.search(r"multi-scale training: (buckets .*)", f.read()).group(1)
        # the step at each bucket's shape, card against CPU in float64: two
        # steps from the zoo on the first two batches of that shape in the
        # loader's sequence (chained over many steps, float64 runs part too:
        # an ill-conditioned trajectory grows a 1e-16 difference each step).
        # As the train phase: per leaf, leaving out the leaves whose float64
        # gradient is zero (their Adam step is rounding noise)
        ms_cfg = get_config("256x320")
        ms_cfg = dataclasses.replace(ms_cfg, train=dataclasses.replace(
            ms_cfg.train, batch_size=8, multiscale_steps=1, warmup_min_iters=100,
            total_epochs=8))
        zv = load_variables(zoo)
        loader = DetectionLoader(VOCIndex(sets[("256x320", 8)][0], ms_cfg.io.class_names),
                                 ms_cfg, seed=ms_cfg.train.seed, cache=True)
        seq = [b for _ in range(2) for b in loader]
        f64 = {}
        for h, w in dict.fromkeys(hw):
            first = next(i for i, (x, _) in enumerate(seq) if x.shape[1:3] == (h, w))
            runs64 = {}
            for dev in ("cuda", "cpu"):
                t = Trainer(ms_cfg, batch_per_epoch=len(loader), variables=zv,
                            device=dev).to_float64()
                p0 = t.state.params.detach().to("cpu", copy=True)
                losses = torch.stack([t.step(*b)["total"] for b in seq[first:first + 2]])
                runs64[dev] = {"losses": losses.cpu(), "step": t.state.params.detach().cpu() - p0,
                               "batch_stats": t.state.batch_stats.cpu(), "mu": t.state.mu.cpu()}
            views = {dev: {k: t.layouts[0].views(r[k]) for k in ("step", "mu")}
                     for dev, r in runs64.items()}
            total = float(runs64["cpu"]["mu"].norm())
            kept = [n for n, v in views["cpu"]["mu"].items() if float(v.norm()) >= 1e-9 * total]
            f64[f"{h}x{w}"] = {
                "losses": rel_l2(runs64["cuda"]["losses"], runs64["cpu"]["losses"]),
                "batch_stats": rel_l2(runs64["cuda"]["batch_stats"],
                                      runs64["cpu"]["batch_stats"]),
                **{f"{k}_worst_leaf": max(rel_l2(views["cuda"][k][n], views["cpu"][k][n])
                                          for n in kept) for k in ("step", "mu")},
                "zero_gradient_leaves": len(views["cpu"]["mu"]) - len(kept)}
        out["multiscale"] = {"steps": len(hw), "log_line": line,
                             "first_use": {f"{h}x{w}": hw.index((h, w))
                                           for h, w in dict.fromkeys(hw)},
                             "sequence_equal_to_loader": hw == again,
                             "float64_card_vs_cpu_2_steps": f64,
                             "launches": counts["multiscale"]}
        seconds["multiscale"] = time.perf_counter() - t0

        # ----------------------- scratch: --resume latest after 1 of 2 epochs
        t0 = time.perf_counter()
        every = preset_json(os.path.join(td, "scratch.json"), "256x320", val_after_epoch=-1,
                            log_every=1)
        base = ["train", "--config-json", every, "--epochs", "2", "--batch-size", "16",
                "--warmup-min-iters", "60", "--cache-images", "--max-to-keep", "0",
                *data("256x320", 2)]
        train("scratch_full", base + run_dirs("scratch_full"))
        os.makedirs(os.path.join(td, "scratch_resumed", "ck"))
        shutil.copytree(os.path.join(td, "scratch_full", "ck", "epoch_0"),
                        os.path.join(td, "scratch_resumed", "ck", "epoch_0"))
        train("scratch_resumed", base + run_dirs("scratch_resumed") + ["--resume", "latest"])
        out["scratch"] = {
            **demos.resume_check(os.path.join(td, "scratch_full"),
                                 os.path.join(td, "scratch_resumed"), bpe=2, start_epoch=1),
            "validations": demos.read_validations(os.path.join(td, "scratch_full", "logs",
                                                               "train_info.log")),
            "launches": {k: counts[k] for k in ("scratch_full", "scratch_resumed")}}
        seconds["scratch"] = time.perf_counter() - t0

        # ----------------------------------- distill: one epoch of each arm
        t0 = time.perf_counter()
        base = ["train", "--config", "lite-256x320", "--arch", "lite", "--epochs", "1",
                "--batch-size", "16", "--warmup-min-iters", "60", "--cache-images",
                *data("256x320", 16)]
        arms = {}
        for arm, extra in (("control", []), ("distill", ["--distill-teacher", zoo,
                                                         "--distill-arch", "fastest",
                                                         "--distill-weight", "1"])):
            rec = train(f"distill_{arm}", base + extra + run_dirs(f"distill_{arm}"))
            arms[arm] = {"steps": len(rec["hw"]), "fit_start": rec["fit_start"][0][:16],
                         "launches": counts[f"distill_{arm}"]}
        out["distill"] = arms
        seconds["distill"] = time.perf_counter() - t0

        # ------------------------- lite512: one epoch from the lite seed
        t0 = time.perf_counter()
        seed = os.path.join(td, "lite512_seed.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            demos.run_tool(["tools/torch_make_lite_seed.py", "--out", seed, "--res", "512x640"])
        every = preset_json(os.path.join(td, "lite512.json"), "lite-512x640",
                            val_after_epoch=-1)
        rec = train("lite512", ["train", "--config-json", every, "--arch", "lite", "--epochs",
                                "1", "--batch-size", "32", "--warmup-min-iters", "60",
                                "--cache-images", "--pretrained", seed, *data("512x640", 16),
                                *run_dirs("lite512")])
        out["lite512"] = {"steps": len(rec["hw"]), "validations": demos.read_validations(
            os.path.join(td, "lite512", "logs", "train_info.log")),
            "launches": counts["lite512"]}
        seconds["lite512"] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase

    emit("demos", card=card, **out, seconds=seconds,
         tolerance="freeze, scratch: bit for bit; multiscale: the loader's sequence exactly; "
                   "distill: equal init digests, 6 chain launches a teacher step")
    f = out["freeze"]
    check(f["steps"] == 20 and f["pinned"] == 48 and f["pinned_bit_equal"] == 48
          and f["moved"] == ["head_4", "head_5"], f"demos freeze: {f}")
    m = out["multiscale"]
    f64 = m["float64_card_vs_cpu_2_steps"]
    check(len(f64) == 3 and all(v <= 1e-9 for d in f64.values() for k, v in d.items()
                                if k != "zero_gradient_leaves"),
          f"demos multiscale, float64 steps card vs CPU: {f64}")
    check(m["steps"] == 40 and len(m["first_use"]) == 3 and m["sequence_equal_to_loader"]
          and m["log_line"] == "buckets [(224, 288), (256, 320), (288, 352)], redrawn every "
                               "10 batches", f"demos multiscale: {m}")
    sc = out["scratch"]
    check(sc["final_state"]["equal"] and sc["metric_lines_after_resume"] == 2
          and not sc["metric_lines_differ"] and sc["validations_after_resume"] == 1
          and not sc["validations_differ"] and len(sc["validations"]) == 2,
          f"demos scratch resume: {sc}")
    c, d = arms["control"], arms["distill"]
    check(c["fit_start"] == d["fit_start"] and c["steps"] == d["steps"] == 20
          and c["launches"]["res_chain_rows"] == 0
          and d["launches"]["res_chain_rows"] == 6 * d["steps"], f"demos distill: {arms}")
    lv = out["lite512"]
    check(lv["steps"] == 9 and len(lv["validations"]) == 1
          and lv["validations"][0]["mAP"] is not None
          and lv["launches"]["nms"] == 1 and lv["launches"]["res_chain_rows"] == 0,
          f"demos lite512: {lv}")
    for name in ("freeze", "multiscale", "distill_control", "distill_distill"):
        check(counts[name]["nms"] == 0, f"demos {name}: no validation, launches {counts[name]}")
    check(counts["scratch_full"]["nms"] == 2 * 2 and counts["scratch_resumed"]["nms"] == 2,
          f"demos scratch launches {counts}: one NMS a val batch")
    return counts


def profile_path(card, counted) -> dict:
    """The ``profile`` phase: ``utils.profiling.trace`` around one B=8
    ``run_raw`` of the fp Detector and one fp32 train step at B=8 (256x320
    zoo, golden frames); the written Chrome trace's kernel events must
    equal the launch counters (the chain kernel 6 times, ``nms_packed``
    once) and hold the step's ``train_step/*`` spans; its size and
    seconds.  Then a ``SectionTimer`` report over the Detector's
    preprocess, forward and decode+NMS (20 calls, synchronised)."""
    import glob
    import tempfile

    import torch

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.train import Trainer
    from yolofastest_torch.utils.profiling import SectionTimer, trace

    cfg, zoo, x, t = parallel_inputs()
    det = Detector(get_config("256x320"), variables=zoo, device="cuda")
    frames = make_frames(np.load(os.path.join(FIXTURES, "golden_256x320.npz"))["pre_imgs"][:8])
    trainer = Trainer(cfg, batch_per_epoch=1, variables=zoo, device="cuda")
    det.run_raw(frames)
    trainer.step(x[:8], t[:8])
    with tempfile.TemporaryDirectory(prefix="yf_trace_") as td:
        def traced():
            with trace(td):
                det.run_raw(frames)
                trainer.step(x[:8], t[:8])

        t0 = time.perf_counter()
        _, launches = counted(traced)
        seconds = time.perf_counter() - t0
        files = glob.glob(os.path.join(td, "*.pt.trace.json"))
        check(len(files) == 1, f"trace wrote {os.listdir(td)}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    in_trace = {"res_chain_rows": sum("res_chain_kernel" in n for n in kernels),
                "nms": sum("nms_packed" in n for n in kernels)}
    spans = sorted({e["name"] for e in events if str(e.get("name", "")).startswith("train_step/")})

    timer = SectionTimer()
    for _ in range(20):
        with timer.section("preprocess"):
            xin = det.preprocess(frames)
            torch.cuda.synchronize()
        with timer.section("forward"):
            heads = det.forward_heads(xin)
            torch.cuda.synchronize()
        with timer.section("decode_nms"):
            det.postprocess(heads, packed=True)
            torch.cuda.synchronize()
    report = timer.report()
    emit("profile", card=card, res="256x320", batch=8, trace_bytes=size, trace_seconds=seconds,
         trace_events=len(events), kernel_events=len(kernels), kernels_in_trace=in_trace,
         launches=launches, spans=spans, section_timer=report,
         section_note="host clock around each stage with a synchronise, 20 calls at B=8")
    check(in_trace == {"res_chain_rows": 6, "nms": 1}
          and launches == {"res_chain_rows": 6, "nms": 1, "res_chain_cf": 0},
          f"trace kernels {in_trace} vs launch counters {launches}")
    want = {f"train_step/{s}" for s in ("upload", "forward", "loss", "backward", "optimizer")}
    check(want <= set(spans), f"trace spans {spans}")
    check(set(report) == {"preprocess", "forward", "decode_nms"}
          and all(r["count"] == 20 for r in report.values()), f"section timer {report}")
    return {"profile": launches}


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
    # yf_shlo (the StableHLO text consumer, host compiler) builds beside the kernels
    from yolofastest_torch.native import find_shlo_runner

    shlo = _Thread(find_shlo_runner)
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
            run = stage_times(det, frames)
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
            timing.append({"dtype": str(dt).split(".")[-1], "batch": b, **run,
                           "forward_layers_ms": layers})
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

    # ------------------------------------------------------- export path
    export_path(card, counted)

    # ---------------------------------- the serialised programs (.pt2, ONNX)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="yf_mlir_") as mlir_dir:
        programs_path(card, counted, mlir_dir)

        # ------------------- the StableHLO text programs through yf_shlo (host)
        mlir_path(card, counted, mlir_dir, shlo)

    # ------------------------------------------------------- int8 path
    int8_path(card, counted)

    # --------------------------------------- quantisation tools (sweep, QAT)
    quant2_path(card, counted)

    # ------------------- the deployment matrix and the int8 artifact recipes
    recipes = recipes_path(card, counted)

    # ------------------------------------------- the C++ engine (host CPU)
    native_path(card, counted)

    # ------------------- the fine-tune set and the round-4 training recipes
    finetune = finetune_path(card, counted)

    # ------------- the training demos of docs/train_demo_*, in short forms
    demo_counts = demos_path(card, counted)

    # ------------------------------ data parallelism over a process group
    _, train_reference = parallel_path(card, counted)

    # ------------------------- the spatial axis: image rows split over ranks
    spatial = spatial_path(card, counted, train_reference, n_sm)

    # ------------------------------------------------ the trace and timer
    profile_path(card, counted)

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
    summary[-1].update(
        spatial_launches_per_rank=spatial["spatial_rank0"]["res_chain_rows"],
        spatial_max_abs_err=spatial["shard_max_abs_err"],
        spatial_shard_ms=sum(t["shard_ms"] for t in spatial["shard_timing"]),
        spatial_whole_ms=sum(t["whole_ms"] for t in spatial["shard_timing"]),
        spatial_at="one forward of the (2, 2) mesh's spatial rank 0 at 512x640; ms: the six "
                   "chains at B=10 on that rank's planes (own rows + K halo rows) beside the "
                   "whole planes, fp32")
    summary[-1]["recipes_launches"] = {k: c["res_chain_rows"] for k, c in recipes.items()}
    summary[-1]["finetune_launches"] = {k: c["res_chain_rows"] for k, c in finetune.items()}
    summary[-1]["demos_launches"] = {k: c["res_chain_rows"] for k, c in demo_counts.items()}
    nms64 = next(t for t in nms_timing if t["candidates"] == "golden_256x320" and t["B"] == 64)
    summary.append({
        "name": "nms_packed", "route": "cuda", "source": NMS_SOURCE,
        "replaces": "yolofastest_tpu/ops/nms.py:49 (batched_nms: an XLA fori_loop, a stable "
                    "argsort and a gather; no Pallas kernel)",
        "launches": main_path_launches["nms"], "max_abs_err": 0.0 if mismatched == 0 else 1.0,
        "mismatches": mismatched, "ms": nms64["device_ms"],
        "events_ms_host_pace": nms64["events_ms_host_pace"], "plain_ms": nms64["plain_ms"],
        "bound_ms": nms64["bound_ms"], "bound_by": nms64["bound_by"], "library_ms": None,
        "recipes_launches": {k: c["nms"] for k, c in recipes.items()},
        "finetune_launches": {k: c["nms"] for k, c in finetune.items()},
        "demos_launches": {k: c["nms"] for k, c in demo_counts.items()},
        "at": "golden 256x320 candidates tiled to B=64, K=128, max_det 64; ms from the profiler"})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
