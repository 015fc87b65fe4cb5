#!/usr/bin/env python3
"""Run-to-run determinism of the port's train and QAT steps, and their speed.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/torch_determinism_check.py [--root DIR] [--label NAME]
        [--steps 20] [--qat-steps 40] [--find-op] [--timing] [--device cuda]

It imports ``yolofastest_torch`` from ``--root`` (default: this checkout),
so that two commits can be compared in one call on one card: unpack the
other one with ``git archive`` into a git-ignored directory and run the two
in turns (A, B, B, A).  It prints one JSON line per part:

* ``trainer``: for fp32 and bf16, two runs of ``--steps`` ``Trainer.step``
  calls at B=16 from the 256x320 zoo weights (EMA 0.9995, a 60-step warmup,
  as the prune040 recipe trains), each on the same batches: the loader's
  first batches (augmentation on, seed 0) over the ``--copies 16``
  fine-tune set of ``tools/torch_make_finetune_set.py``.  After every step
  each leaf of the parameters, BatchNorm statistics, both Adam moments and
  the EMA is compared bit for bit; the line names the first step and the
  leaves that differ there.
* ``qat``: two runs of ``--qat-steps`` QAT steps with
  ``tools/torch_search_int8_recipe2.py``'s 256x320 flags (amax8 scales,
  distillation with conf weight 4, lr 5e-5, batches of 4 golden frames),
  parameters and both moments compared after every step.
* ``--find-op``: the first step that differs is run once more under a
  dispatch mode that runs every ATen operation three times on copies of its
  inputs and compares the results bit for bit; the operations whose results
  differ are listed with their shapes and where they differ.
* ``--timing``: fed steps/s (the loader with its cache, the upload and the
  step, as ``fit`` runs) at B=16 and B=64, fp32 and bf16, over 64
  synthetic 512x640 images as ``chip_smoke.py``'s ``train`` phase times
  them; QAT steps/s at B=4.

The first line is the card's name and power limit.  ``--device cpu`` runs
the same parts on the CPU (a rehearsal: its times are not the card's).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "weights", "yolofastest_256x320.npz")


def emit(part: str, **fields) -> None:
    print(json.dumps({"part": part, **fields}), flush=True)


def _same(a, b) -> bool:
    """Bit for bit (NaNs by their bits)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
        return bool(torch.equal(a.view(bits), b.view(bits)))
    return bool(torch.equal(a, b))


def first_difference(run_a, run_b, layouts):
    """The first step at which two runs' recorded vectors differ: ``None``,
    or its index, the differing leaves by vector and the largest
    difference.  ``run_*``: per step ``{vector: flat tensor}``;
    ``layouts``: ``{vector: FlatLayout}``."""
    for step, (a, b) in enumerate(zip(run_a, run_b)):
        leaves, worst = {}, 0.0
        for key in a:
            if _same(a[key], b[key]):
                continue
            names = [n for n, (lo, hi) in layouts[key].spans.items()
                     if not _same(a[key][lo:hi], b[key][lo:hi])]
            leaves[key] = names
            worst = max(worst, float((a[key].double() - b[key].double()).abs().max()))
        if leaves:
            return {"step": step, "leaves": {k: {"count": len(v), "first": v[:8]}
                                             for k, v in leaves.items()},
                    "max_abs_diff": worst}
    return None


def replay_mode(reps: int = 3):
    """A dispatch mode that runs every ATen operation ``reps`` times on
    copies of its inputs and records those whose results (outputs and
    mutated inputs) differ bit for bit: ``calls``, ``backward_calls`` and
    ``differ`` (one dict an operation result that differed)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map

    def copy(t):
        return t.clone() if isinstance(t, torch.Tensor) else t

    def tensors(tree):
        return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]

    class Replay(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls, self.backward_calls, self.differ = 0, 0, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func)
            # uninitialised memory and host reads are not results
            if func.namespace == "aten" and "empty" not in name and "_local_scalar" not in name:
                self.calls += 1
                self.backward_calls += "backward" in name
                runs = []
                for _ in range(reps):
                    a, k = tree_map(copy, (args, kwargs))
                    runs.append(tensors((func(*a, **k), a, k)))
                for i, ref in enumerate(runs[0]):
                    other = next((r[i] for r in runs[1:] if not _same(ref, r[i])), None)
                    if other is None:
                        continue
                    bad = ref != other
                    if ref.is_floating_point():
                        bad &= ~(ref.isnan() & other.isnan())
                    where = bad.reshape(-1).nonzero().reshape(-1)
                    self.differ.append({
                        "op": name, "inputs": [list(t.shape) for t in tensors(args)],
                        "result": i, "shape": list(ref.shape),
                        "dtype": str(ref.dtype).split(".")[-1],
                        "elements_differing": int(where.numel()), "numel": ref.numel(),
                        "first_flat_positions": where[:4].tolist(),
                        "max_abs_diff": float((ref.double() - other.double()).abs().max())
                        if ref.is_floating_point() else None})
            return func(*args, **kwargs)

    return Replay()


def finetune_batches(td, n, batch, seed=0):
    """The first ``n`` batches (augmentation on) of the loader over the
    ``--copies 16`` fine-tune set, as host arrays."""
    import torch_make_finetune_set
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.data import DetectionLoader, VOCIndex

    cfg = get_config("256x320")
    root = os.path.join(td, "ft")
    torch_make_finetune_set.write_set(root, copies=16, res="256x320", log=lambda _: None)
    index = VOCIndex(os.path.join(root, "train"), cfg.io.class_names)
    out = []
    while len(out) < n:
        for b in DetectionLoader(index, cfg, batch_size=batch, seed=seed):
            out.append(b)
            if len(out) == n:
                break
    return out


def trainer_config(batch: int):
    import dataclasses

    from yolofastest_torch.configs import get_config

    cfg = get_config("256x320")
    tr = dataclasses.replace(cfg.train, batch_size=batch, ema_decay=0.9995,
                             warmup_min_iters=60, total_epochs=60)
    return dataclasses.replace(cfg, train=tr)


def trainer_runs(batches, dtype, device, find_op: bool):
    import torch

    from yolofastest_torch.models import load_variables
    from yolofastest_torch.train import Trainer

    zoo = load_variables(ZOO)
    cfg = trainer_config(16)

    def trainer():
        return Trainer(cfg, batch_per_epoch=20, variables=zoo, compute_dtype=dtype,
                       device=device)

    def record(t):
        s = t.state
        return {"params": s.params.detach().clone(), "batch_stats": s.batch_stats.clone(),
                "mu": s.mu.clone(), "nu": s.nu.clone(), "ema_params": s.ema[0].clone(),
                "ema_batch_stats": s.ema[1].clone()}

    runs, seconds = [], []
    for _ in range(2):
        t = trainer()
        t0 = time.perf_counter()
        steps = []
        for imgs, tgts in batches:
            t.step(imgs, tgts)
            steps.append(record(t))
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        runs.append(steps)
    p, s = t.layouts
    layouts = {"params": p, "batch_stats": s, "mu": p, "nu": p, "ema_params": p,
               "ema_batch_stats": s}
    diff = first_difference(*runs, layouts)
    out = {"dtype": str(dtype).split(".")[-1], "batch": 16, "steps": len(batches),
           "bit_equal": diff is None, "first_difference": diff, "seconds": seconds}
    if find_op:
        # a third run up to that step, then the step once more under replay
        at = diff["step"] if diff else 0
        t = trainer()
        for imgs, tgts in batches[:at]:
            t.step(imgs, tgts)
        mode = replay_mode()
        with mode:
            t.step(*batches[at])
        out["replay"] = {"step": at, "ops": mode.calls, "backward_ops": mode.backward_calls,
                         "differ": mode.differ}
    return out


def qat_run(device):
    import torch

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.eval.golden import golden_inputs
    from yolofastest_torch.models import fold_batchnorm, load_variables
    from yolofastest_torch.quant.qat import QatRun
    from yolofastest_torch.quant.recipes import make_scales

    imgs, _ = golden_inputs("256x320")
    folded = fold_batchnorm(load_variables(ZOO))
    scales = make_scales(folded, imgs, "amax8", device)
    io = get_config("256x320").io
    return QatRun(folded, scales, [imgs[i:i + 4] for i in range(0, len(imgs), 4)],
                  arch="fastest", targets=None, anchors=io.anchors, input_hw=io.input_hw,
                  num_cls=io.num_cls, lr=5e-5, conf_weight=4.0, device=device,
                  dtype=torch.float32)


def qat_runs(device, steps: int, find_op: bool):
    import torch

    run = qat_run(device)

    def trajectory(n):
        theta, mu, nu = run.theta0, torch.zeros_like(run.theta0), torch.zeros_like(run.theta0)
        count = torch.zeros((), dtype=torch.int32, device=device)
        out = []
        for i in range(n):
            theta, mu, nu, count, _, _ = run.step(theta, mu, nu, count, i % len(run.xs))
            out.append({"theta": theta.clone(), "mu": mu.clone(), "nu": nu.clone()})
        return out

    a, b = trajectory(steps), trajectory(steps)
    diff = first_difference(a, b, {k: run.layout for k in ("theta", "mu", "nu")})
    out = {"batch": 4, "steps": steps, "bit_equal": diff is None, "first_difference": diff}
    if find_op:
        at = diff["step"] if diff else 0
        theta = a[at - 1]["theta"] if at else run.theta0
        mode = replay_mode()
        with mode:
            run.loss_and_grad(theta, at % len(run.xs))
        out["replay"] = {"step": at, "ops": mode.calls, "backward_ops": mode.backward_calls,
                         "differ": mode.differ}
    return out


def timing(device, td):
    """Fed steps/s at B=16 and 64, fp32 and bf16, and QAT steps/s at B=4."""
    import dataclasses

    import torch

    from yolofastest_torch.data import DetectionLoader, VOCIndex, write_synthetic_voc
    from yolofastest_torch.models import load_variables
    from yolofastest_torch.train import Trainer

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    zoo = load_variables(ZOO)
    cfg = trainer_config(16)
    voc = os.path.join(td, "voc")
    write_synthetic_voc(voc, 64, cfg.io.origin_img_shape[:2], cfg.io.class_names, seed=0)
    index = VOCIndex(voc, cfg.io.class_names)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for b in (16, 64):
            cb = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=b))
            loader = DetectionLoader(index, cb, seed=0, cache=True)
            t = Trainer(cb, batch_per_epoch=len(loader), variables=zoo, compute_dtype=dt,
                        device=device)

            def feed():
                while True:
                    yield from loader

            batches = feed()
            for _ in range(max(len(loader), 3)):  # fills the cache
                t.step(*next(batches))
            sync()
            n = 30
            t0 = time.perf_counter()
            for _ in range(n):
                t.step(*next(batches))
            sync()
            s = time.perf_counter() - t0
            rows.append({"dtype": str(dt).split(".")[-1], "batch": b, "steps": n,
                         "steps_per_s": n / s, "images_per_s": n * b / s})
    run = qat_run(device)
    theta, mu, nu = run.theta0, torch.zeros_like(run.theta0), torch.zeros_like(run.theta0)
    count = torch.zeros((), dtype=torch.int32, device=device)
    for i in range(5):
        theta, mu, nu, count, _, _ = run.step(theta, mu, nu, count, i % len(run.xs))
    sync()
    n = 40
    t0 = time.perf_counter()
    for i in range(n):
        theta, mu, nu, count, _, _ = run.step(theta, mu, nu, count, i % len(run.xs))
    sync()
    qat = {"batch": 4, "steps": n, "steps_per_s": n / (time.perf_counter() - t0)}
    return rows, qat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO,
                    help="checkout whose yolofastest_torch is measured")
    ap.add_argument("--label", default="this")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--qat-steps", type=int, default=40)
    ap.add_argument("--find-op", action="store_true")
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import yolofastest_torch

    if not os.path.abspath(yolofastest_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {yolofastest_torch.__file__}, not the one under {root}")
    sys.path.insert(1, os.path.join(REPO, "tools"))
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu for a rehearsal")
        from yolofastest_torch.kernels import _build

        _build.build()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
    flags = {"cudnn_deterministic": torch.backends.cudnn.deterministic,
             "cudnn_benchmark": torch.backends.cudnn.benchmark,
             "deterministic_algorithms": torch.are_deterministic_algorithms_enabled()}
    with tempfile.TemporaryDirectory(prefix="yf_det_") as td:
        if args.steps:
            batches = finetune_batches(td, args.steps, 16)
            for dt in (torch.float32, torch.bfloat16):
                emit("trainer", label=args.label, root=root,
                     **trainer_runs(batches, dt, device, args.find_op))
        if args.qat_steps:
            emit("qat", label=args.label, root=root,
                 **qat_runs(device, args.qat_steps, args.find_op))
        if args.timing:
            rows, qat = timing(device, td)
            emit("timing", label=args.label, root=root, device=str(device), train=rows,
                 qat=qat)
    emit("flags", label=args.label, before=flags,
         after={"cudnn_deterministic": torch.backends.cudnn.deterministic,
                "cudnn_benchmark": torch.backends.cudnn.benchmark,
                "deterministic_algorithms": torch.are_deterministic_algorithms_enabled()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
