"""Run the JAX package's committed training demos with the port on the card.

Each demo under ``docs/train_demo*`` proves one feature of the ``train``
command at full resolution; this driver runs its recipe with the port
(``python3 -m yolofastest_torch train``, called in this process so that the
kernels' launches are counted) and scores the result beside JAX's record:

1. the set: ``tools/torch_make_finetune_set.py`` (the 20 golden frames, 19
   at 512x640, with the reference's golden detections as labels);
2. the start: a zoo ``.npz``, ``tools/torch_make_lite_seed.py``, the
   ``prune`` command, or random initialisation;
3. the ``train`` command, with JAX's flags (the table :data:`DEMOS`);
4. the score: every validation of the run's ``train_info.log``, the logged
   ``lr`` against JAX's ``metrics.jsonl`` at each step JAX logged, the final
   checkpoint's golden recall through the fp Detector (on the card: six
   chain-kernel launches and one NMS launch a forward), and for the lite
   demos through the native engine too, beside the committed lite zoo's
   recall measured the same way.  Each demo adds its own check: ``freeze``
   the pinned modules bit for bit, ``multiscale`` the bucket of every batch,
   ``scratch`` a run stopped after ``epoch_26`` and resumed with ``--resume
   latest`` against the uninterrupted run bit for bit, ``distill`` the A/B
   on three seeds with the teacher's chain launches.

Where JAX's record does not write a flag down, the recipe derives it from
the record's ``train_info.log`` and ``metrics.jsonl`` and says how: the items
an epoch from ``dataset contains N items``, the batch from ``current_batch =
i/n``, the epochs from the last ``total_iter`` and the validations, the
warmup from the ``lr`` column (``lr0 * lf(e) * min(step / num_warm, 1)``,
logged for the step's update, i.e. at ``step - 1`` accepted updates).
``--cache-images`` is in every recipe, as in the two demos whose commands
are written down (``docs/train_demo_{distill,scratch}/NOTES.md``); the
cache leaves the batches as they are.

Usage:
  python3 tools/torch_run_train_demos.py [--demo NAME ...|all] [--out DIR]
      [--print] [--docs DIR] [--device cuda|cpu] [--float64]

``--out`` (default ``train_runs/demos``, git-ignored) holds the sets, seeds,
checkpoints, logs and ``summary.json``; nothing is written to ``weights/``.
``--print`` prints every command and runs nothing.  ``--docs DIR`` also
copies each demo's ``train_info.log`` and ``metrics.jsonl`` and writes a
``README.md`` into ``DIR/train_demo_<name>_torch/``.  ``--float64`` adds
``train``'s ``--float64`` to every run: the same recipe and batches with
rounding far below fp32's, the arbiter of a missed outcome.
Exit 1 when a demo missed its outcome (after every selected demo has run).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

DOCS = os.path.join(REPO, "docs")
WEIGHTS = os.path.join(REPO, "weights")
SEEDS = (0, 1, 2)  # the distillation A/B's seeds: 0 is JAX's
SCRATCH_STOP = 26  # the scratch run is stopped once epoch_26 is written, as JAX's was
CHECKED_FIELDS = ("total", "x", "y", "w", "h", "conf", "cls", "lr", "distill",
                  "skipped_nonfinite", "nonfinite_streak")


@dataclasses.dataclass(frozen=True)
class Recipe:
    """One demo: JAX's record, the set, the start and the train flags.
    ``jax``: JAX's command as documented, or as derived from its record
    (the comment on the table entry says how), with JAX's own paths."""
    record: str  # JAX's record under docs/ (distill: the folder of both arms)
    res: str  # the set's resolution
    copies: int  # train copies of each frame
    start: str  # "zoo", "lite_seed", "prune" or "random"
    flags: Tuple[str, ...]  # train flags besides the paths and --device
    jax: str
    outcome: str  # JAX's outcome, as its record shows it
    finetune: bool = True  # gated: val mAP >= 0.99 and full detection at the end

    def flag(self, name: str, default=None):
        return self.flags[self.flags.index(name) + 1] if name in self.flags else default

    @property
    def config(self) -> str:
        return self.flag("--config")

    @property
    def epochs(self) -> int:
        return int(self.flag("--epochs"))

    @property
    def batch(self) -> int:
        return int(self.flag("--batch-size"))


DEMOS: Dict[str, Recipe] = {
    # the lite zoo's 512x640 recipe (docs/train_demo_lite512/).  304
    # items (19 frames x 16), 9 batches an epoch -> batch 32; total_iter 180 ->
    # 20 epochs; lr 1.49e-4 at step 10 = 1e-3 * lf(1) * 9/60 -> warmup 60.
    "lite512": Recipe(
        "train_demo_lite512", "512x640", 16, "lite_seed",
        ("--config", "lite-512x640", "--arch", "lite", "--epochs", "20", "--batch-size", "32",
         "--warmup-min-iters", "60", "--cache-images"),
        "python -m yolofastest_tpu train --config lite-512x640 --arch lite "
        "--train-dir <set>/train --val-dir <set>/val --pretrained /tmp/lite512_seed.npz "
        "--epochs 20 --batch-size 32 --warmup-min-iters 60 --cache-images",
        "first val (epoch 5) mAP 0.867, 31/33; 1.000 and 33/33 from epoch 6 to 19"),
    # the lite zoo's 256x320 recipe: 320 items, 10 batches -> batch 32;
    # total_iter 400 -> 40 epochs; lr 1.5e-4 at step 10 -> warmup 60.
    "lite": Recipe(
        "train_demo_lite", "256x320", 16, "lite_seed",
        ("--config", "lite-256x320", "--arch", "lite", "--epochs", "40", "--batch-size", "32",
         "--warmup-min-iters", "60", "--cache-images"),
        "python -m yolofastest_tpu train --config lite-256x320 --arch lite "
        "--train-dir <set>/train --val-dir <set>/val --pretrained /tmp/lite_seed.npz "
        "--epochs 40 --batch-size 32 --warmup-min-iters 60 --cache-images",
        "mAP 1.000 and 34/34 at all 35 validations"),
    # docs/train_demo_distill/NOTES.md writes both arms' commands down; the
    # extra seeds are --config-json of the preset with train.seed changed.
    "distill": Recipe(
        "train_demo_distill", "256x320", 16, "random",
        ("--config", "lite-256x320", "--arch", "lite", "--epochs", "12", "--batch-size", "16",
         "--warmup-min-iters", "60", "--cache-images"),
        "python -m yolofastest_tpu train --config lite-256x320 --arch lite "
        "--train-dir <set>/train --val-dir <set>/val "
        "--epochs 12 --batch-size 16 --warmup-min-iters 60 --cache-images",
        "control best 0.022, final 0.000 (0/34); distill best 0.200, final 0.120 (3/34)",
        finetune=False),
    # the heads-only fine-tune (docs/API.md:126-131): 320 items, 20 batches ->
    # batch 16; total_iter 240 -> 12 epochs; lr 1.5e-4 at step 10 -> warmup 60.
    "freeze": Recipe(
        "train_demo_freeze", "256x320", 16, "zoo",
        ("--config", "256x320", "--epochs", "12", "--batch-size", "16",
         "--warmup-min-iters", "60", "--freeze", "backbone", "--cache-images"),
        "python -m yolofastest_tpu train --config 256x320 "
        "--train-dir <set>/train --val-dir <set>/val "
        "--pretrained weights/yolofastest_256x320.npz --epochs 12 --batch-size 16 "
        "--warmup-min-iters 60 --freeze backbone --cache-images",
        "mAP 1.000 and 34/34 at every validation; 48 frozen modules bitwise equal to the zoo"),
    # multi-scale: 160 items (x8), 20 batches -> batch 8;
    # total_iter 160 -> 8 epochs; lr 9e-5 at step 10 = 1e-3 * 9/100 -> warmup
    # 100; three buckets input_hw +/- 32 -> --multiscale 1.
    "multiscale": Recipe(
        "train_demo_multiscale", "256x320", 8, "zoo",
        ("--config", "256x320", "--epochs", "8", "--batch-size", "8",
         "--warmup-min-iters", "100", "--multiscale", "1", "--cache-images"),
        "python -m yolofastest_tpu train --config 256x320 "
        "--train-dir <set>/train --val-dir <set>/val "
        "--pretrained weights/yolofastest_256x320.npz --epochs 8 --batch-size 8 "
        "--warmup-min-iters 100 --multiscale 1 --cache-images",
        "mAP 1.000 and 34/34; buckets (224, 288), (256, 320), (288, 352) logged"),
    # prune 0.4, then fine-tune without EMA (prune040's recipe has --ema, so
    # both are kept): 320 items, 20 batches -> batch 16; total_iter 1200 -> 60
    # epochs; lr 1.5e-4 at step 10 -> warmup 60; eval before and after.
    "prune": Recipe(
        "train_demo_prune", "256x320", 16, "prune",
        ("--config", "256x320", "--epochs", "60", "--batch-size", "16",
         "--warmup-min-iters", "60", "--cache-images"),
        "python -m yolofastest_tpu train --config 256x320 "
        "--train-dir <set>/train --val-dir <set>/val --pretrained /tmp/pruned_04.npz "
        "--epochs 60 --batch-size 16 --warmup-min-iters 60 --cache-images",
        "eval before 0.133 (6/34); first val 0.974 (33/34); 1.000 and 34/34 from epoch 14"),
    # docs/train_demo_scratch/NOTES.md writes the command down; JAX's run was
    # killed in epoch 27 and resumed from epoch_26 with --resume latest.
    "scratch": Recipe(
        "train_demo_scratch", "256x320", 16, "random",
        ("--config", "256x320", "--epochs", "60", "--batch-size", "16",
         "--warmup-min-iters", "60", "--cache-images"),
        "python -m yolofastest_tpu train --config 256x320 "
        "--train-dir <set>/train --val-dir <set>/val "
        "--epochs 60 --batch-size 16 --warmup-min-iters 60 --cache-images",
        "first logged val (epoch 27) 0.153; best 0.648 at epoch 55; final 0.584, 12/34",
        finetune=False),
    # the first fine-tune: 320 items, 20 batches -> batch 16; total_iter 240
    # -> 12 epochs; lr 9e-6 at step 10 = 1e-3 * 9/1000 -> the preset's warmup.
    "finetune256": Recipe(
        "train_demo", "256x320", 16, "zoo",
        ("--config", "256x320", "--epochs", "12", "--batch-size", "16", "--cache-images"),
        "python -m yolofastest_tpu train --config 256x320 "
        "--train-dir <set>/train --val-dir <set>/val "
        "--pretrained weights/yolofastest_256x320.npz --epochs 12 --batch-size 16 "
        "--cache-images",
        "mAP 1.000 at every validation, 34/34"),
    # 152 items (19 x 8), 9 batches -> batch 16; validations at epochs 5-7 and
    # lr 8.73e-6 at step 10 = 1e-3 * lf(1) * 9/1000 with lf(1) for 8 epochs ->
    # 8 epochs (72 steps, logged to 70), the preset's warmup.
    "finetune512": Recipe(
        "train_demo_512", "512x640", 8, "zoo",
        ("--config", "512x640", "--epochs", "8", "--batch-size", "16", "--cache-images"),
        "python -m yolofastest_tpu train --config 512x640 "
        "--train-dir <set>/train --val-dir <set>/val "
        "--pretrained weights/yolofastest_512x640.npz --epochs 8 --batch-size 16 "
        "--cache-images",
        "mAP 1.000 at the last validation, 33/33 at every one"),
}


# ---------------------------------------------------------------- commands
def set_dir(out: str, res: str, copies: int) -> str:
    return os.path.join(out, "sets", f"{res}_x{copies}")


def seed_path(out: str, name: str) -> Optional[str]:
    r = DEMOS[name]
    if r.start == "zoo":
        return os.path.join(WEIGHTS, f"yolofastest_{r.res}.npz")
    if r.start in ("lite_seed", "prune"):
        return os.path.join(out, name, "seed.npz")
    return None


def config_json(out: str, seed: int) -> str:
    return os.path.join(out, "distill", f"lite-256x320_seed{seed}.json")


def write_seed_config(out: str, seed: int) -> str:
    """The distillation preset with ``train.seed`` changed, as a
    ``--config-json`` file."""
    from yolofastest_torch.configs import get_config

    c = get_config(DEMOS["distill"].config)
    c = dataclasses.replace(c, train=dataclasses.replace(c.train, seed=seed))
    path = config_json(out, seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(c.to_json())
    return path


def runs(name: str, out: str, device: str = "cuda",
         float64: bool = False) -> List[Tuple[str, List[str]]]:
    """``[(label, train argv)]`` of a demo: one run, or the distillation
    arms of each seed, or scratch's uninterrupted, stopped and resumed runs;
    with ``float64``, each trains with ``--float64``."""
    r = DEMOS[name]
    root, data = os.path.join(out, name), set_dir(out, r.res, r.copies)

    def argv(label, flags, extra=()):
        a = ["train", *flags, "--train-dir", os.path.join(data, "train"),
             "--val-dir", os.path.join(data, "val")]
        if seed_path(out, name):
            a += ["--pretrained", seed_path(out, name)]
        return a + [*extra, "--checkpoint-dir", os.path.join(root, label, "ck"),
                    "--log-dir", os.path.join(root, label, "logs"), "--device", device,
                    *(["--float64"] if float64 else [])]

    if name == "distill":
        teacher = ("--distill-teacher", os.path.join(WEIGHTS, "yolofastest_256x320.npz"),
                   "--distill-arch", "fastest", "--distill-weight", "1")
        out_runs = []
        for seed in SEEDS:
            flags = list(r.flags)
            if seed:
                i = flags.index("--config")
                flags[i:i + 2] = ["--config-json", config_json(out, seed)]
            for arm, extra in (("control", ()), ("distill", teacher)):
                out_runs.append((f"seed{seed}/{arm}", argv(f"seed{seed}/{arm}", flags, extra)))
        return out_runs
    if name == "scratch":
        stopped = argv("resumed", r.flags)
        return [("uninterrupted", argv("uninterrupted", r.flags)), ("stopped", stopped),
                ("resumed", stopped + ["--resume", "latest"])]
    return [("run", argv("run", r.flags))]


def prepare_commands(name: str, out: str) -> List[List[str]]:
    """The set and start commands of a demo, as argv lists of a Python
    script or module."""
    r = DEMOS[name]
    cmds = [["tools/torch_make_finetune_set.py", "--out", set_dir(out, r.res, r.copies),
             "--copies", str(r.copies), "--res", r.res]]
    if r.start == "lite_seed":
        cmds.append(["tools/torch_make_lite_seed.py", "--out", seed_path(out, name),
                     "--res", r.res])
    elif r.start == "prune":
        cmds.append(["-m", "yolofastest_torch", "prune", "--config", r.config, "--weights",
                     os.path.join(WEIGHTS, f"yolofastest_{r.res}.npz"), "--ratio", "0.4",
                     "--out", seed_path(out, name)])  # on the host
    return cmds


def _shell(argv: List[str]) -> str:
    return " ".join(shlex.quote(a) for a in argv)


def print_demo(name: str, out: str, device: str, float64: bool = False) -> None:
    print(f"# {name}: docs/{DEMOS[name].record}")
    for c in prepare_commands(name, out):
        print("python3 " + _shell(c))
    for label, a in runs(name, out, device, float64):
        prefix = "# stopped after epoch_%d, then:\n" % SCRATCH_STOP if label == "resumed" else ""
        print(prefix + "python3 -m yolofastest_torch " + _shell(a))


# --------------------------------------------------------- the JAX records
def read_validations(log_path: str) -> List[Dict]:
    """Every validation block of a ``train_info.log``: epoch, mAP and, where
    logged, the detection rate with its hits and targets."""
    with open(log_path) as f:
        text = f.read()
    out = []
    for block in re.split(r"—+ epoch: ", text)[1:]:
        epoch = int(block.split(" ", 1)[0])
        m = re.search(r"mean AP: ([0-9.]+)", block)
        d = re.search(r"detection rate: ([0-9.]+) \((\d+)/(\d+) targets\)", block)
        out.append({"epoch": epoch, "mAP": float(m.group(1)) if m else None,
                    "hits": int(d.group(2)) if d else None,
                    "targets": int(d.group(3)) if d else None})
    return out


def read_metrics(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def global_steps(metrics: List[Dict], bpe: int, resumed_epochs=()) -> List[Tuple[int, Dict]]:
    """``(global step, line)`` of a ``metrics.jsonl`` whose step count starts
    again after a resume: the n-th restart continues at ``resumed_epochs[n] *
    bpe``."""
    out, offset, last, n = [], 0, 0, 0
    for m in metrics:
        if m["step"] <= last:
            offset, n = resumed_epochs[n] * bpe, n + 1
        last = m["step"]
        out.append((offset + m["step"], m))
    return out


def jax_record(name: str) -> Dict:
    """JAX's record of a demo: validations, ``(global step, lr)`` and the set
    sizes its log names."""
    r = DEMOS[name]
    folders = ([f"{r.record}/control", f"{r.record}/distill"] if name == "distill"
               else [r.record])
    out = {}
    for folder in folders:
        log = os.path.join(DOCS, folder, "train_info.log")
        with open(log) as f:
            text = f.read()
        resumed = [int(e) for e in re.findall(r"Resumed full state from .* \(epoch (\d+)\)", text)]
        bpe = int(re.search(r"current_batch = \d+/(\d+)", text).group(1))
        steps = global_steps(read_metrics(os.path.join(DOCS, folder, "metrics.jsonl")), bpe,
                             resumed)
        out[folder] = {"validations": read_validations(log), "bpe": bpe,
                       "lr": [(s, m["lr"]) for s, m in steps],
                       "items": [int(n) for n in re.findall(r"dataset contains (\d+) items",
                                                            text)]}
    return out


def summarize_validations(vals: List[Dict]) -> Dict:
    if not vals:
        return {"count": 0}
    best = max(vals, key=lambda v: v["mAP"])
    return {"count": len(vals), "first": vals[0], "last": vals[-1],
            "best": {"epoch": best["epoch"], "mAP": best["mAP"]},
            "min_mAP": min(v["mAP"] for v in vals)}


# ------------------------------------------------------------- running
@contextlib.contextmanager
def watch_trainer(record: Dict):
    """Record, for every ``Trainer`` of the block, the input size of each
    step and a digest of the weights when ``fit`` starts."""
    import hashlib

    from yolofastest_torch.train import Trainer

    step, fit = Trainer.step, Trainer.fit

    def watched_step(self, imgs, targets):
        record.setdefault("hw", []).append(tuple(int(v) for v in imgs.shape[1:3]))
        return step(self, imgs, targets)

    def watched_fit(self, *args, **kwargs):
        s = self.state
        h = hashlib.sha256()
        for t in (s.params, s.batch_stats):
            h.update(t.detach().cpu().numpy().tobytes())
        record.setdefault("fit_start", []).append(h.hexdigest())
        return fit(self, *args, **kwargs)

    Trainer.step, Trainer.fit = watched_step, watched_fit
    try:
        yield record
    finally:
        Trainer.step, Trainer.fit = step, fit


def counted(fn, device: str):
    """``fn()`` with every kernel launch count set to 0 just before it;
    returns its result and the counts read just after."""
    import torch

    from yolofastest_torch.kernels import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def cli(argv: List[str]) -> int:
    from yolofastest_torch.cli import main

    print("+ python3 -m yolofastest_torch " + _shell(argv), flush=True)
    return main(argv)


def run_tool(argv: List[str]) -> None:
    """A set or seed command, in this process (the tools' ``main``)."""
    print("+ python3 " + _shell(argv), flush=True)
    if argv[0] == "-m":
        rc = cli(argv[2:])
    else:
        module = os.path.splitext(os.path.basename(argv[0]))[0]
        rc = __import__(module).main(argv[1:])
    if rc not in (None, 0):
        raise SystemExit(f"{_shell(argv)} exited {rc}")


def latest_epoch_dir(ck: str) -> str:
    epochs = sorted(int(m.group(1)) for d in os.listdir(ck)
                    if (m := re.fullmatch(r"epoch_(\d+)", d)))
    return os.path.join(ck, f"epoch_{epochs[-1]}")


def golden_scores(variables, cfg, arch: str, device: str, yfb: Optional[str] = None) -> Dict:
    """Golden recall through the fp Detector (launches counted) and, given a
    ``yfb`` path to write the folded weights to, through the C++ engine on
    the host CPU; the weights in fp32."""
    import numpy as np

    def fp32(tree):
        return {k: fp32(v) if isinstance(v, dict) else np.asarray(v, np.float32)
                for k, v in tree.items()}

    variables = fp32(variables)
    from yolofastest_torch.eval.golden import (fp_recall, golden_inputs, native_rows,
                                               recall_rows)

    (m, n), launches = counted(lambda: fp_recall(variables, cfg, device, arch=arch), device)
    out = {"fp": [m, n], "fp_launches": launches}
    if yfb:
        from yolofastest_torch.export import save_native_weights
        from yolofastest_torch.models import fold_batchnorm
        from yolofastest_torch.native import NativeEngine, find_library

        imgs, golden = golden_inputs(f"{cfg.io.input_hw[0]}x{cfg.io.input_hw[1]}")
        save_native_weights(fold_batchnorm(variables), yfb, io_config=cfg.io)
        engine = NativeEngine(yfb, cfg, library_path=find_library()[0])
        (m, n), launches = counted(lambda: recall_rows(native_rows(engine, imgs), golden),
                                   device)
        out["native"], out["native_launches"] = [m, n], launches
    return out


def lr_against_jax(port_steps: List[Tuple[int, Dict]], jax_lr: List[Tuple[int, float]]) -> Dict:
    """The port's logged lr at every step JAX logged (global steps)."""
    ours = {s: m["lr"] for s, m in port_steps}
    missing = [s for s, _ in jax_lr if s not in ours]
    worst = max((abs(ours[s] - lr) / lr for s, lr in jax_lr if s in ours), default=None)
    return {"jax_steps": len(jax_lr), "missing": missing[:5], "max_rel_diff": worst,
            "equal": not missing and worst is not None and worst <= 1e-6}


def bit_equal_checkpoints(a: str, b: str) -> Dict:
    """Every tensor of two ``state.pt`` files, bit for bit, by part."""
    import torch

    from yolofastest_torch.train.trainer import CHECKPOINT_FILE

    sa = torch.load(os.path.join(a, CHECKPOINT_FILE), weights_only=True)
    sb = torch.load(os.path.join(b, CHECKPOINT_FILE), weights_only=True)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}/")
        elif tree is not None:
            yield prefix.rstrip("/"), tree

    def bits(t):
        return t.reshape(-1).view(torch.uint8)

    la, lb = dict(leaves(sa)), dict(leaves(sb))
    parts = {}
    for k in la.keys() | lb.keys():
        x, y = la.get(k), lb.get(k)
        same = (x is not None and y is not None and x.shape == y.shape and x.dtype == y.dtype
                and bool(torch.equal(bits(x), bits(y))))
        part = k.split("/")[0] if not k.startswith("opt_state") else k.split("/")[1]
        parts[part] = parts.get(part, True) and same
    return {"by_part": parts, "equal": all(parts.values()), "ema": sa.get("ema") is not None}


def run_demo(name: str, out: str, device: str, float64: bool = False) -> Dict:
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.models import load_variables
    from yolofastest_torch.train import checkpoint_variables

    r = DEMOS[name]
    arch = "lite" if r.config.startswith("lite") else "fastest"
    cfg = get_config(r.config)
    t0 = time.perf_counter()
    for c in prepare_commands(name, out):
        run_tool(c)
    if name == "distill":
        for seed in SEEDS[1:]:
            write_seed_config(out, seed)
    jax = jax_record(name)
    row = {"demo": name, "jax_record": f"docs/{r.record}", "jax_outcome": r.outcome,
           "device": device, "float64": float64, "commands": [], "runs": {}, "checks": {}}
    for label, argv in runs(name, out, device, float64):
        root = os.path.dirname(argv[argv.index("--checkpoint-dir") + 1])
        if label != "resumed":  # it continues the stopped run's directories
            shutil.rmtree(root, ignore_errors=True)
        row["commands"].append("python3 -m yolofastest_torch " + _shell(argv))
        rec = {}
        t1 = time.perf_counter()
        if label == "stopped":
            rec["stopped_after"] = stop_after(argv, SCRATCH_STOP)
            launches = None
        else:
            with watch_trainer(rec):
                rc, launches = counted(lambda: cli(argv), device)
            if rc != 0:
                raise SystemExit(f"{name} {label}: train exited {rc}")
        logs = os.path.join(root, "logs")
        vals = read_validations(os.path.join(logs, "train_info.log"))
        res = {"seconds": time.perf_counter() - t1, "launches": launches,
               "validations": summarize_validations(vals),
               "mAP_by_epoch": {v["epoch"]: v["mAP"] for v in vals}}
        if "stopped_after" in rec:
            res["stopped_after"] = rec["stopped_after"]
        if "hw" in rec:
            res["steps"] = len(rec["hw"])
            res["fit_start_sha256"] = rec["fit_start"][0][:16]
            res["hw_first_seen"] = {f"{h}x{w}": rec["hw"].index((h, w))
                                    for h, w in dict.fromkeys(rec["hw"])}
        res["_hw"] = rec.get("hw")
        row["runs"][label] = res
    row["seconds"] = time.perf_counter() - t0

    # ---------------------------------------------- the score beside JAX's
    folder = next(iter(jax))
    bpe = jax[folder]["bpe"]
    main_label = {"distill": "seed0/control", "scratch": "uninterrupted"}.get(name, "run")
    logs = os.path.join(out, name, main_label, "logs")
    port_steps = global_steps(read_metrics(os.path.join(logs, "metrics.jsonl")), bpe)
    row["lr"] = lr_against_jax(port_steps, jax[folder]["lr"])
    if name == "distill":
        row["lr"]["distill_arm"] = lr_against_jax(
            global_steps(read_metrics(os.path.join(out, name, "seed0/distill/logs",
                                                   "metrics.jsonl")), bpe),
            jax[f"{r.record}/distill"]["lr"])["equal"]
    row["jax"] = {f: summarize_validations(j["validations"]) for f, j in jax.items()}
    row["jax_items"] = jax[folder]["items"]
    ck = os.path.join(out, name, main_label, "ck")
    final = latest_epoch_dir(ck)
    variables = checkpoint_variables(final)
    native = arch == "lite"  # JAX deployed the lite recipes' results natively
    row["golden"] = golden_scores(variables, cfg, arch, device,
                                  os.path.join(out, name, "trained.yfb") if native else None)
    if native:
        committed = load_variables(os.path.join(WEIGHTS, f"yolofastest_lite_{r.res}.npz"))
        row["committed_golden"] = golden_scores(committed, cfg, arch, device,
                                                os.path.join(out, name, "committed.yfb"))
    else:
        row["committed_golden"] = {"fp": [34, 34] if r.res == "256x320" else [33, 33]}
    extra = globals().get(f"_check_{name}")
    if extra:
        extra(row, out, cfg, final)
    last = row["runs"][main_label]["validations"].get("last")
    if r.finetune:
        cg, g = row["committed_golden"], row["golden"]
        row["checks"]["last_val_mAP_ge_0.99"] = last is not None and last["mAP"] >= 0.99
        row["checks"]["last_val_full_detection"] = (last is not None
                                                    and last["hits"] == last["targets"])
        row["checks"]["golden_fp_ge_committed"] = g["fp"][0] >= cg["fp"][0]
        if native:
            row["checks"]["golden_native_ge_committed"] = g["native"][0] >= cg["native"][0]
    row["checks"]["lr_equal_to_jax"] = row["lr"]["equal"]
    row["ok"] = all(row["checks"].values())
    for res in row["runs"].values():
        res.pop("_hw", None)
    return row


def stop_after(argv: List[str], epoch: int) -> Dict:
    """Run ``train`` in a child process and kill it once ``epoch_<epoch>``
    is on disk (the newest checkpoint then), as a preempted run ends."""
    ck = argv[argv.index("--checkpoint-dir") + 1]
    target = os.path.join(ck, f"epoch_{epoch}", "state.pt")
    print("+ python3 -m yolofastest_torch " + _shell(argv) + f"  (killed after epoch_{epoch})",
          flush=True)
    import torch

    # the host's thread count as here: on the CPU it sets the rounding
    env = {**os.environ, "OMP_NUM_THREADS": str(torch.get_num_threads())}
    proc = subprocess.Popen([sys.executable, "-m", "yolofastest_torch", *argv], cwd=REPO,
                            env=env)
    try:
        while not os.path.exists(target):
            if proc.poll() is not None:
                raise SystemExit(f"the stopped run ended (rc {proc.returncode}) before "
                                 f"epoch_{epoch}")
            time.sleep(0.05)
        proc.kill()
    finally:
        proc.wait()
    return {"epoch": epoch, "newest": os.path.basename(latest_epoch_dir(ck))}




# ------------------------------------------------------ per-demo checks
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def module_equal(a, b, name) -> bool:
    """Module ``name``'s weights and statistics bit for bit in two trees."""
    import numpy as np

    for part in ("params", "batch_stats"):
        if name not in a[part]:
            continue
        fa, fb = _flat(a[part][name]), _flat(b[part][name])
        if fa.keys() != fb.keys():
            return False
        for k, v in fa.items():
            x, y = np.asarray(v), np.asarray(fb[k])
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                return False
    return True


def pinned_modules(log_path: str) -> List[str]:
    """The modules that a ``train --freeze`` log names as pinned."""
    with open(log_path) as f:
        return re.search(r"freeze: \d+ modules pinned \(([^)]*)\)", f.read()).group(1).split(", ")


def freeze_check(log_path: str, checkpoint: str, start: str) -> Dict:
    """The modules that the run's log names as pinned, against the start
    weights ``start`` in ``checkpoint`` (weights and statistics, bit for
    bit), and the other modules that moved."""
    from yolofastest_torch.models import load_variables
    from yolofastest_torch.train import checkpoint_variables

    pinned = pinned_modules(log_path)
    zoo = load_variables(start)
    trained = checkpoint_variables(checkpoint, prefer_ema=False)
    others = [n for n in zoo["params"] if n not in pinned]
    return {"pinned": pinned,
            "pinned_bit_equal": sum(module_equal(zoo, trained, n) for n in pinned),
            "others": others, "moved": [n for n in others if not module_equal(zoo, trained, n)]}


def _check_freeze(row, out, cfg, final) -> None:
    """The modules the log names as pinned are bit-equal to the zoo in the
    final checkpoint (weights and statistics); every other module moved."""
    f = freeze_check(os.path.join(out, "freeze", "run", "logs", "train_info.log"), final,
                     os.path.join(WEIGHTS, "yolofastest_256x320.npz"))
    pinned, others = f["pinned"], f["others"]
    row["freeze"] = {"pinned": len(pinned), "same_names_as_jax": pinned == pinned_modules(
                         os.path.join(DOCS, DEMOS["freeze"].record, "train_info.log")),
                     "pinned_bit_equal": f["pinned_bit_equal"], "others": others,
                     "others_moved": len(f["moved"])}
    row["checks"]["pinned_as_jax"] = row["freeze"]["same_names_as_jax"]
    row["checks"]["pinned_bit_equal_to_zoo"] = row["freeze"]["pinned_bit_equal"] == len(pinned)
    row["checks"]["others_moved"] = row["freeze"]["others_moved"] == len(others) > 0


def _check_multiscale(row, out, cfg, final) -> None:
    """The buckets logged as JAX's, every bucket ran (JAX's order of first
    use), and the bucket of every batch equals the loader's own sequence
    for the seed, drawn again here without the Trainer."""
    r = DEMOS["multiscale"]

    def buckets(path):
        with open(path) as f:
            text = f.read()
        line = re.search(r"multi-scale training: (buckets .*)", text).group(1)
        first = re.findall(r"multi-scale: (?:compiling train step for|first train step at) "
                           r"input (\d+x\d+)", text)
        return line, first

    ours, our_first = buckets(os.path.join(out, "multiscale", "run", "logs", "train_info.log"))
    theirs, their_first = buckets(os.path.join(DOCS, r.record, "train_info.log"))
    hw = row["runs"]["run"]["_hw"]
    again = loader_buckets(os.path.join(set_dir(out, r.res, r.copies), "train"), cfg, r.batch,
                           r.epochs)
    bpe = len(hw) // r.epochs
    row["multiscale"] = {
        "log_line": ours, "jax_log_line": theirs, "first_use_order": our_first,
        "jax_first_use_order": their_first,
        "first_use_epoch": {f"{h}x{w}": hw.index((h, w)) // bpe for h, w in dict.fromkeys(hw)},
        "first_epoch_buckets": sorted({f"{h}x{w}" for h, w in hw[:bpe]}),
        "steps": len(hw), "sequence_equal_to_loader": hw == again}
    row["checks"]["buckets_logged_as_jax"] = ours == theirs
    row["checks"]["every_bucket_ran"] = len(set(hw)) == 3
    row["checks"]["first_use_order_as_jax"] = our_first == their_first
    row["checks"]["sequence_equal_to_loader"] = hw == again


def loader_buckets(train_dir: str, cfg, batch: int, epochs: int, steps: int = 1):
    """The input size of every batch that the train command's loader gives
    over ``epochs`` with ``--multiscale steps`` and the preset's seed, drawn
    on the host without a Trainer."""
    from yolofastest_torch.data import DetectionLoader, VOCIndex

    tr = dataclasses.replace(cfg.train, batch_size=batch, multiscale_steps=steps)
    loader = DetectionLoader(VOCIndex(train_dir, cfg.io.class_names),
                             dataclasses.replace(cfg, train=tr), seed=tr.seed, cache=True)
    return [tuple(imgs.shape[1:3]) for _ in range(epochs) for imgs, _ in loader]


def resume_check(full: str, resumed: str, bpe: int, start_epoch: int) -> Dict:
    """A run resumed with ``--resume latest`` at ``start_epoch`` against the
    uninterrupted run, each directory holding its run's ``logs/`` and
    ``ck/``: every metric line that the resumed process logged (its steps
    count again from the resume; a log continued from the stopped run's
    holds that run's lines first), its validations and the newest
    checkpoints, bit for bit."""
    full_m = dict(global_steps(read_metrics(os.path.join(full, "logs", "metrics.jsonl")), bpe))
    lines = read_metrics(os.path.join(resumed, "logs", "metrics.jsonl"))
    restarts = [i for i in range(1, len(lines)) if lines[i]["step"] <= lines[i - 1]["step"]]
    own = lines[restarts[-1] if restarts else 0:]
    differ = [s for s, m in ((start_epoch * bpe + m["step"], m) for m in own)
              if s not in full_m or any(m.get(k) != full_m[s].get(k) for k in CHECKED_FIELDS)]
    vals = {v["epoch"]: v for v in read_validations(os.path.join(full, "logs",
                                                                 "train_info.log"))}
    resumed_vals = read_validations(os.path.join(resumed, "logs", "train_info.log"))
    return {"metric_lines_after_resume": len(own), "metric_lines_differ": differ,
            "validations_after_resume": len(resumed_vals),
            "validations_differ": [v["epoch"] for v in resumed_vals
                                   if v != vals.get(v["epoch"])],
            "final_state": bit_equal_checkpoints(latest_epoch_dir(os.path.join(full, "ck")),
                                                 latest_epoch_dir(os.path.join(resumed, "ck")))}


def _check_scratch(row, out, cfg, final) -> None:
    """The run stopped after epoch_26 and resumed with --resume latest
    against the uninterrupted run: every logged metric after the resume,
    the validations, and the final state, bit for bit."""
    root = os.path.join(out, "scratch")
    res = resume_check(os.path.join(root, "uninterrupted"), os.path.join(root, "resumed"),
                       320 // DEMOS["scratch"].batch, SCRATCH_STOP + 1)
    row["scratch"] = {"stopped": row["runs"]["stopped"]["stopped_after"], **res}
    row["checks"]["stopped_after_epoch_26"] = (
        row["scratch"]["stopped"]["newest"] == f"epoch_{SCRATCH_STOP}")
    row["checks"]["resumed_metrics_equal"] = (res["metric_lines_after_resume"] > 0
                                              and not res["metric_lines_differ"])
    row["checks"]["resumed_validations_equal"] = (res["validations_after_resume"] > 0
                                                  and not res["validations_differ"])
    row["checks"]["resumed_state_bit_equal"] = res["final_state"]["equal"]
    # the resumed run's log holds its own validations (epochs 27-59), as JAX's
    row["runs"]["resumed"]["validations"] = summarize_validations(read_validations(
        os.path.join(root, "resumed", "logs", "train_info.log")))


def _check_distill(row, out, cfg, final) -> None:
    """Per seed: both arms from one init, the teacher's chain launches (six a
    step, none in the control), best and final mAP of each arm."""
    per_seed = {}
    for seed in SEEDS:
        c, d = row["runs"][f"seed{seed}/control"], row["runs"][f"seed{seed}/distill"]
        per_seed[seed] = {
            "same_init": c["fit_start_sha256"] == d["fit_start_sha256"],
            "chain_launches": [c["launches"]["res_chain_rows"], d["launches"]["res_chain_rows"]],
            "steps": [c["steps"], d["steps"]],
            "control": {"best": c["validations"]["best"], "final": c["validations"]["last"]},
            "distill": {"best": d["validations"]["best"], "final": d["validations"]["last"]}}
        per_seed[seed]["distill_beats_control"] = (
            d["validations"]["best"]["mAP"] > c["validations"]["best"]["mAP"]
            and d["validations"]["last"]["mAP"] > c["validations"]["last"]["mAP"])
        row["checks"][f"seed{seed}_same_init"] = per_seed[seed]["same_init"]
        row["checks"][f"seed{seed}_teacher_launches"] = (
            per_seed[seed]["chain_launches"] == [0, 6 * d["steps"]])
    row["distill"] = per_seed


def _check_prune(row, out, cfg, final) -> None:
    """``eval`` of the pruned start and of the fine-tuned checkpoint, as
    JAX's eval_before.log and eval_after.log."""
    import io

    r = DEMOS["prune"]
    val = os.path.join(set_dir(out, r.res, r.copies), "val")
    evals = {}
    for when, weights in (("before", seed_path(out, "prune")), ("after", final)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(["eval", "--config", r.config, "--weights", weights, "--val-dir", val,
                      "--log-dir", os.path.join(out, "prune", f"eval_{when}"),
                      "--device", row["device"]])
        m = re.search(r"^mAP: ([0-9.]+)$", buf.getvalue(), re.M)
        with open(os.path.join(DOCS, r.record, f"eval_{when}.log")) as f:
            jm = re.search(r"^mAP: ([0-9.]+)$", f.read(), re.M)
        evals[when] = {"rc": rc, "mAP": float(m.group(1)) if m else None,
                       "jax_mAP": float(jm.group(1))}
    row["prune"] = {"eval": evals, "prune040_covers": False,
                    "why_kept": "prune040's recipe adds --ema (docs/train_demo_prune040/"
                                "train_info.log validates EMA weights; this one does not)"}


# ------------------------------------------------------------------ docs
def write_docs(row: Dict, out: str, docs: str, card: str) -> str:
    """``docs/train_demo_<name>_torch/``: the logs of the run and a README
    with the commands, the card and the outcome beside JAX's."""
    name = row["demo"]
    dst = os.path.join(docs, f"train_demo_{name}_torch")
    shutil.rmtree(dst, ignore_errors=True)
    labels = {"distill": [f"seed{s}/{a}" for s in SEEDS for a in ("control", "distill")],
              "scratch": ["resumed", "uninterrupted"]}.get(name, ["run"])
    for label in labels:
        sub = dst if label in ("run", "resumed") else os.path.join(dst, label)
        os.makedirs(sub, exist_ok=True)
        for f in ("train_info.log", "metrics.jsonl"):
            shutil.copyfile(os.path.join(out, name, label, "logs", f), os.path.join(sub, f))
    lines = [f"# `{name}` on the card: the port of `docs/{row['jax_record'][5:]}/`", "",
             f"Card: {card}.  Run by `python3 tools/torch_run_train_demos.py --demo {name}` "
             f"({row['seconds']:.1f} s on the card, sets and scoring included).", "",
             "Commands (paths under the driver's `--out`):", "", "```"]
    lines += [c.replace(REPO + "/", "") for c in row["commands"]]
    lines += ["```", "", "| | port (this card) | JAX record |", "|---|---|---|"]
    main = {"distill": "seed0/control", "scratch": "uninterrupted"}.get(name, "run")
    v = row["runs"][main]["validations"]
    jv = next(iter(row["jax"].values()))

    def fmt(x):
        if not x or x.get("first") is None:
            return "none"
        f, last, b = x["first"], x["last"], x["best"]
        return (f"{x['count']} validations; first (epoch {f['epoch']}) {f['mAP']:.3f}"
                f"{_hits(f)}; best {b['mAP']:.3f} (epoch {b['epoch']}); last (epoch "
                f"{last['epoch']}) {last['mAP']:.3f}{_hits(last)}; lowest {x['min_mAP']:.3f}")

    lines.append(f"| validation ({main}) | {fmt(v)} | {fmt(jv)} |")
    lines.append(f"| logged lr at JAX's {row['lr']['jax_steps']} logged steps | "
                 f"{'equal' if row['lr']['equal'] else 'DIFFERENT'} (largest relative "
                 f"difference {row['lr']['max_rel_diff']}) | - |")
    g, cg = row["golden"], row["committed_golden"]
    lines.append(f"| golden recall, fp Detector | {g['fp'][0]}/{g['fp'][1]} (launches "
                 f"{g['fp_launches']}) | committed model {cg['fp'][0]}/{cg['fp'][1]} |")
    if "native" in g:
        lines.append(f"| golden recall, native engine | {g['native'][0]}/{g['native'][1]} | "
                     f"committed model {cg['native'][0]}/{cg['native'][1]} |")
    lines += ["", f"JAX's outcome: {row['jax_outcome']}.", ""]
    for key in ("freeze", "multiscale", "scratch", "distill", "prune"):
        if key in row:
            lines += [f"`{key}` checks:", "", "```", json.dumps(row[key], indent=1), "```", ""]
    lines += ["Checks: " + ", ".join(f"{k} {'yes' if ok else 'NO'}"
                                     for k, ok in row["checks"].items()) + ".", ""]
    with open(os.path.join(dst, "README.md"), "w") as f:
        f.write("\n".join(lines))
    return dst


def _hits(v) -> str:
    return f", {v['hits']}/{v['targets']}" if v.get("hits") is not None else ""


# ------------------------------------------------------------------ main
def card_probe() -> Dict:
    """The card's names, a sum on it, and its name and power limit."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the demos train on the card (--device cpu to rehearse)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    probe = {"devices": [torch.cuda.get_device_name(i) for i in
                         range(torch.cuda.device_count())],
             "probe_sum": float(torch.ones(8, device="cuda").sum()), "nvidia_smi": smi}
    for k, v in probe.items():
        print(f"{k}: {v}", flush=True)
    return probe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demo", action="append", default=None,
                    help=f"one of {', '.join(DEMOS)}, or all (repeatable; default all)")
    ap.add_argument("--out", default=os.path.join(REPO, "train_runs", "demos"))
    ap.add_argument("--print", action="store_true", help="print the commands, run nothing")
    ap.add_argument("--docs", default=None,
                    help="also write docs/train_demo_<name>_torch/ folders under this root")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--float64", action="store_true",
                    help="add train's --float64 to every run (the arbiter of a missed "
                         "outcome: the same recipe with rounding far below fp32's)")
    args = ap.parse_args(argv)
    names = list(DEMOS) if not args.demo or "all" in args.demo else args.demo
    unknown = [n for n in names if n not in DEMOS]
    if unknown:
        ap.error(f"unknown demo {unknown}; choose from {', '.join(DEMOS)} or all")
    out = os.path.abspath(args.out)
    if args.print:
        for name in names:
            print_demo(name, out, args.device, args.float64)
        return 0
    if args.device == "cuda":
        probe = card_probe()
        card = probe["nvidia_smi"]
    else:
        probe, card = {"device": "cpu"}, "the host CPU (a rehearsal, not a card run)"
    os.makedirs(out, exist_ok=True)
    summary = {"probe": probe, "demos": {}}
    path = os.path.join(out, "summary.json")
    for name in names:
        t0 = time.perf_counter()
        try:
            row = run_demo(name, out, args.device, args.float64)
        except Exception as e:  # noqa: BLE001 (the other demos still run)
            import traceback

            traceback.print_exc()
            row = {"demo": name, "ok": False, "error": repr(e)}
        row["wall_s"] = time.perf_counter() - t0
        summary["demos"][name] = row
        with open(path, "w") as f:
            json.dump(summary, f, indent=1, default=str)
        if args.docs and "runs" in row:
            write_docs(row, out, args.docs, card)
        print(json.dumps({"demo": name, "ok": row["ok"], "checks": row.get("checks"),
                          "error": row.get("error"), "wall_s": round(row["wall_s"], 1)}),
              flush=True)
    print(f"wrote {path}")
    return 0 if all(r["ok"] for r in summary["demos"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
