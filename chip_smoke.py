#!/usr/bin/env python3
"""Drive the PyTorch port (``yolofastest_torch``) end to end on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``yolofastest_torch/kernels/csrc``, holds
each kernel against its plain PyTorch version, runs the deployed detector
(``Detector.run_raw``: uint8 frames in, detections out) on the golden
fixtures at both resolutions and checks the golden boxes, then times the
main path and the kernels.  Phases print one JSON line each, in order:
device (after the raw ``nvidia-smi`` line), build, kernels, golden (the main
path, whose kernel launches are counted), k1_path (the folded forward with
its chains through the channels-first kernel), bf16, pruned, timing,
kernel_timing; then the ``{"kernels": [...]}`` summary, and last
``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no ok line;
without a CUDA card it exits 2 at once.  It imports nothing of JAX and needs
no cv2: the frames are built with numpy from ``tests/fixtures``.
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

# Published dense peaks of one H100 SXM at its 700 W limit.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 FMA outside the tensor cores
PEAK_BYTES = 3.35e12
FP32_TOL = 1e-4  # rel and abs, as tests/test_kernels.py:49
BF16_TOL = 4 * 2.0 ** -7  # of max|y|: 4 ulp of bf16 (8 significant bits)
K1_SOURCE = "yolofastest_torch/kernels/csrc/res_chain.cu"


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


def cuda_ms(fn, reps: int, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain_bound(b, h, w, c, i, k, dtype_name):
    """Least time (ms) and what bounds it for one chain call: fp32 FMA or
    bf16 peak for K*(4CI+18I) flops per pixel, HBM rate for reading x and
    writing y once plus the weights."""
    px = b * h * w
    itemsize = 4 if dtype_name == "float32" else 2
    flops = px * k * (4 * c * i + 18 * i)
    nbytes = 2 * c * px * itemsize + k * (c * i + 9 * i + i * c) * itemsize + k * (2 * i + c) * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector, detections_to_lists
    from yolofastest_torch.kernels import _build
    from yolofastest_torch.kernels import res_block as rb
    from yolofastest_torch.models import (RES_CHAINS, FoldedExecutor, fold_batchnorm,
                                          load_variables, torch_params_from_folded,
                                          walk_topology)
    from yolofastest_torch.utils.device import exact_fp32

    # The script's own fp32 references run without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

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

    def random_weights(k, c, i, scale=0.3):
        return tuple((rng.standard_normal(s) * sc).astype(np.float32) for s, sc in (
            ((k, c, i), scale), ((k, i), 0.1), ((k, 3, 3, i), scale), ((k, i), 0.1),
            ((k, i, c), scale), ((k, c), 0.1)))

    # ragged planes, then tests/test_kernels.py's shapes (B, K, H, W, C, I)
    for b, k, h, w, c, i in [(3, 1, 13, 17, 8, 20), (3, 5, 13, 17, 48, 136),
                             (2, 1, 16, 20, 8, 32), (3, 2, 8, 10, 4, 8), (2, 3, 8, 12, 16, 48),
                             (2, 2, 8, 10, 48, 224), (4, 1, 16, 20, 24, 136)]:
        cases.append((f"random/B{b}K{k}H{h}W{w}C{c}I{i}", b, h, w, random_weights(k, c, i)))

    checks, failures = [], []
    worst = {("cf", "float32"): 0.0, ("cf", "bfloat16"): 0.0,
             ("rows", "float32"): 0.0, ("rows", "bfloat16"): 0.0}
    rb.reset_launch_counts()
    for label, b, h, w, st in cases:
        c = st[0].shape[1]
        x = torch.from_numpy((rng.standard_normal((b, h, w, c)) * 0.5).astype(np.float32)).to(dev)
        wt = [torch.from_numpy(a).to(dev) for a in st]
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
                    ok = bool((err <= FP32_TOL + FP32_TOL * ref.abs()).all())
                    tol = f"{FP32_TOL} rel+abs"
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
         tolerance={"float32": f"{FP32_TOL} rel+abs, TF32 off",
                    "bfloat16": "4 bf16 ulp of max|y|"},
         launches=launched)
    check(not failures, f"{len(failures)} kernel checks out of tolerance: {failures[:3]}")
    check(launched["res_chain_rows"] == launched["res_chain_cf"] == 2 * len(cases),
          f"kernel launch counts {launched}")

    # ---------------------------------------------- 4 golden, the main path
    def detector(res, dtype=torch.float32, weights=None):
        path = os.path.join(WEIGHTS, f"yolofastest_{weights or res}.npz")
        return Detector(get_config(res), variables=load_variables(path),
                        compute_dtype=dtype, device="cuda")

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
        check(counts["res_chain_rows"] == 6 * n_fwd and counts["res_chain_cf"] == 0,
              f"{res}: chain kernel launches {counts}, want 6 per forward")
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
    check(rb.LAUNCHES["res_chain_rows"] == 6, f"bf16 launches {rb.LAUNCHES}")

    # -------------------------------------------------------------- 6 pruned
    # The JAX package records 34/34 for this checkpoint by the golden suite's
    # rule (tools/run_golden_suite.py:37-47: same class, IoU > 0.5); by the
    # +-3 px rule of tests/test_detect_parity.py:195-202 it scores 27/34 on
    # the CPU, as the port does.  The gate is the suite's rule; both print.
    det = detector("256x320", weights="pruned040_256x320")
    rows = detections_to_lists(det.run_raw(make_frames(fx["pre_imgs"])))
    n_ref = len(fx["boxes"])
    by_iou = sum(any(int(r[6]) == int(g[7]) and box_iou(r[:4], g[1:5]) > 0.5
                     for r in rows[int(g[0])]) for g in fx["boxes"])
    by_px = sum(any(int(r[6]) == int(g[7]) and max(abs(np.array(r[:4]) - g[1:5])) <= 3.0
                    for r in rows[int(g[0])]) for g in fx["boxes"])
    emit("pruned", weights="yolofastest_pruned040_256x320.npz", dtype="float32",
         recall_iou_0_5=f"{by_iou}/{n_ref}", need=">= 90% by IoU > 0.5 and class",
         recall_within_3px=f"{by_px}/{n_ref}", jax_cpu_within_3px=f"27/{n_ref}",
         detections=sum(len(r) for r in rows))
    check(by_iou >= 0.9 * n_ref, f"pruned recall {by_iou}/{n_ref} (IoU > 0.5)")

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
            timing.append({
                "dtype": str(dt).split(".")[-1], "batch": b,
                "preprocess_ms": split[0], "forward_ms": split[1],
                "decode_nms_ms": split[2], "total_ms": sum(split),
                "wall_ms": wall, "images_per_s": b / (sum(split) / 1e3),
                "forward_layers_ms": layers})
    emit("timing", res="256x320", card=card, reps=20, runs=timing)

    # ------------------------------------------------------- 8 kernel timing
    b = 64
    kt = []
    sums = {}
    folded = zoo["256x320"]
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        tot = {"rows_ms": 0.0, "cf_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "ops_bound_ms": 0.0, "bytes_bound_ms": 0.0}
        for names, (h, w) in zip(RES_CHAINS, chain_planes((256, 320))):
            st = [torch.from_numpy(a).to(dev) for a in rb.chain_weights_from_folded(folded, names)]
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
                       "I": i, "K": k, "tile": list(rb.pick_tile(h, w, c, k)),
                       "rows_ms": rows_ms, "cf_ms": cf_ms, "plain_ms": plain_ms,
                       "bound_ms": bound, "bound_by": by})
            tot["rows_ms"] += rows_ms
            tot["cf_ms"] += cf_ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bound
            tot["ops_bound_ms" if by == "operations" else "bytes_bound_ms"] += bound
        sums[dname] = tot
    emit("kernel_timing", card=card, res="256x320", batch=b, library_ms=None,
         library_note="no single PyTorch call computes a res chain", chains=kt, sums=sums)

    # ------------------------------------------------------- kernels summary
    f32 = sums["float32"]
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
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
