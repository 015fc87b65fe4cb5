"""Training loop: the train step as a plain function over a TrainState.

The port of ``yolofastest_tpu/train/trainer.py``.  One step is the forward
in train mode (BatchNorm on batch statistics, running statistics moved),
:func:`total_loss` with the on-device target assignment (plus the teacher
MSE when distilling), the backward, and the update of optax's
``apply_if_finite(chain([clip_by_global_norm], adam(schedule)))``, written
out so that it matches optax and not torch's defaults:

* Adam with b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction at the count of accepted updates, and the learning rate
  ``schedule(count)`` taken before that count moves;
* the global-norm clip scales by ``max_norm / norm`` when ``norm >=
  max_norm`` (no epsilon);
* a step whose gradient is not finite changes no parameter, no Adam moment
  and no count of accepted updates; a step whose loss or gradient is not
  finite keeps the BatchNorm statistics.  ``skipped_nonfinite`` and
  ``nonfinite_streak`` count them, as optax's state does;
* the EMA of {params, batch_stats} takes the ramped decay ``ema_decay * (1 -
  exp(-(step + 1) / ema_ramp))`` at the step before it moves;
* frozen modules (``--freeze``) get no backward (their weights are not
  autograd leaves), keep their weights bit for bit and their running
  statistics (put back after the forward, which still normalises them with
  batch statistics); their Adam moments stay zero and are saved, so a
  checkpoint has one layout with and without freezing.

The parameters, BatchNorm statistics and Adam moments live in flat fp32
vectors (one entry per ``state_dict`` element), so the update is a handful
of launches whatever the number of layers.  The model's parameters and
statistics are views of the state's two vectors (bound once per state; the
trainable ones are autograd leaves), and the step updates the state in
place; it reads nothing back to the host.  :class:`Trainer` reads the
metrics at the log cadence and the non-finite streak every
``min(log_every, abort_nonfinite_streak)`` steps and at the end of each
epoch, as the JAX trainer does.  :meth:`Trainer.to_float64` turns the
vectors and the model to float64, for a reference run.

Checkpoints are ``<dir>/epoch_<n>/state.pt`` (``torch.save``, loaded with
``weights_only=True``): params, BatchNorm statistics, optimizer state, step
and EMA by ``state_dict`` name.  The JAX package's orbax checkpoints are not
read; the bridge between the packages is the flax-layout ``.npz``
(:func:`yolofastest_torch.models.convert.variables_from_module`).  The mesh
and sharding arguments of the JAX trainer are not ported.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from yolofastest_torch.configs import Config
from yolofastest_torch.losses import total_loss
from yolofastest_torch.models.convert import variables_from_module
from yolofastest_torch.models.yolo_fastest import build_model
from yolofastest_torch.train.schedule import make_lr_schedule
from yolofastest_torch.utils.device import exact_fp32, resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
CHECKPOINT_FILE = "state.pt"


class FlatLayout:
    """Named tensors as views of one flat fp32 vector, in ``state_dict``
    order."""

    def __init__(self, shapes: Sequence[Tuple[str, torch.Size]]):
        self.names = [n for n, _ in shapes]
        self.shapes = {n: tuple(s) for n, s in shapes}
        self.spans: Dict[str, Tuple[int, int]] = {}  # name -> (start, stop)
        off = 0
        for n, s in shapes:
            self.spans[n] = (off, off + math.prod(s))
            off += math.prod(s)
        self.size = off

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: flat[a:b].view(self.shapes[n]) for n, (a, b) in self.spans.items()}

    def flatten(self, tensors: Dict[str, torch.Tensor], device) -> torch.Tensor:
        missing = set(self.names) - set(tensors)
        if missing:
            raise KeyError(f"missing tensors: {sorted(missing)[:5]}")
        for n in self.names:
            if tuple(tensors[n].shape) != self.shapes[n]:
                raise ValueError(f"{n}: shape {tuple(tensors[n].shape)}, the model's "
                                 f"{self.shapes[n]}")
        return torch.cat([tensors[n].detach().reshape(-1).to(device, torch.float32)
                          for n in self.names])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Host copies by name."""
        host = flat.detach().cpu()
        return {n: v.clone() for n, v in self.views(host).items()}

    def mask(self, pred: Callable[[str], bool], device) -> torch.Tensor:
        """(size,) bool: True over the tensors whose name satisfies ``pred``."""
        m = torch.zeros(self.size, dtype=torch.bool)
        for n, (a, b) in self.spans.items():
            m[a:b] = pred(n)
        return m.to(device)


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and writes, in place.  Flat fp32 vectors (see
    :class:`FlatLayout`); the counts are 0-d int32 tensors on the device,
    ``step`` a host int (steps taken, accepted or not)."""

    params: torch.Tensor
    batch_stats: torch.Tensor
    mu: torch.Tensor  # Adam's first moment
    nu: torch.Tensor  # Adam's second moment
    count: torch.Tensor  # accepted updates (optax's Adam and schedule count)
    notfinite_count: torch.Tensor  # current streak of non-finite gradients
    total_notfinite: torch.Tensor  # non-finite gradients in all
    step: int = 0
    # (params, batch_stats) EMA when ``train.ema_decay > 0``, else None
    ema: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def freeze_masks(params: Dict[str, Any], batch_stats: Dict[str, Any], spec: str):
    """Resolve a freeze spec into boolean mask trees (``True`` = frozen).

    ``spec`` is ``"backbone"`` (every top-level module not named ``head*``)
    or comma-separated module-name prefixes; every prefix must match a
    module and one module at least must stay trainable.  ``params`` and
    ``batch_stats`` are the flax-layout trees.  Returns ``(param_mask,
    bs_mask, frozen_names)``, as the JAX package's ``freeze_masks``.
    """
    names = sorted(params.keys())
    spec = spec.strip()
    if spec == "backbone":
        frozen = {n for n in names if not n.startswith("head")}
    else:
        prefixes = [p.strip() for p in spec.split(",") if p.strip()]
        if not prefixes:
            raise ValueError("empty --freeze spec")
        for p in prefixes:
            if not any(n.startswith(p) for n in names):
                raise ValueError(
                    f"--freeze prefix {p!r} matches no module; modules: "
                    f"{', '.join(names)}")
        frozen = {n for n in names if any(n.startswith(p) for p in prefixes)}
    if frozen == set(names):
        raise ValueError("--freeze spec freezes every module; nothing left to train")

    def mask_like(tree, top=None):
        return {k: (mask_like(v, top or k) if isinstance(v, dict) else (top or k) in frozen)
                for k, v in tree.items()}

    return mask_like(params), mask_like(batch_stats), sorted(frozen)


def clip_by_global_norm(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on a flat gradient: unchanged when its
    norm is below ``max_norm``, else ``(g / norm) * max_norm``."""
    norm = torch.linalg.vector_norm(g)
    return torch.where(norm < max_norm, g, (g / norm) * max_norm)


def ema_decay_at(step: int, decay: float, ramp: int) -> np.float32:
    """The ramped EMA decay at ``step`` (the count before it moves), in
    float32 as the JAX step computes it."""
    f32 = np.float32
    return f32(decay) * (f32(1.0) - np.exp(-(f32(step) + f32(1.0)) / f32(ramp)))


def _bind_model(model: torch.nn.Module, layouts: Tuple[FlatLayout, FlatLayout],
               state: TrainState, frozen: frozenset = frozenset()) -> Dict[str, torch.Tensor]:
    """Point the model's parameters and buffers at views of ``state.params``
    and ``state.batch_stats`` (no copy).  The parameters outside ``frozen``
    become autograd leaves, returned by name."""
    leaves = {}
    for flat, layout, slot in ((state.params.detach(), layouts[0], "_parameters"),
                               (state.batch_stats, layouts[1], "_buffers")):
        for name, view in layout.views(flat).items():
            path, _, attr = name.rpartition(".")
            getattr(model.get_submodule(path), slot)[attr] = view
            if slot == "_parameters" and name not in frozen:
                leaves[name] = view.requires_grad_(True)
    return leaves


def make_train_step(model: torch.nn.Module, config: Config, lr_schedule: Callable,
                    layouts: Tuple[FlatLayout, FlatLayout],
                    distill_fn: Optional[Callable] = None, distill_weight: float = 1.0,
                    frozen_modules: Sequence[str] = ()) -> Callable:
    """The train step ``(state, imgs, targets) -> (state, metrics)``,
    which updates ``state`` in place (the model is bound to it, see
    :func:`_bind_model`, at its first step).

    ``imgs`` (B, H, W, 1) and ``targets`` (B, T, 6) are tensors on the
    state's device; the input size is the batch's own (multi-scale buckets
    scale the anchors).  ``metrics`` holds 0-d tensors: the loss components,
    ``lr`` (``schedule(step)``), ``skipped_nonfinite`` and
    ``nonfinite_streak``.  Its phases are ``torch.profiler`` spans
    (``train_step/forward``, ``/loss``, ``/backward``, ``/optimizer``; the
    upload is ``train_step/upload``), which cost nothing when no profiler
    runs.
    """
    from yolofastest_torch.train.distill import distill_loss

    io = config.io
    tr = config.train
    p_layout, s_layout = layouts
    frozen_modules = set(frozen_modules)

    def is_frozen(name: str) -> bool:
        return name.split(".")[0] in frozen_modules

    frozen_names = frozenset(filter(is_frozen, p_layout.names))
    stats_masks: Dict[torch.device, torch.Tensor] = {}
    bound: Dict[str, Any] = {"tensors": None, "leaves": {}}

    def train_step(state: TrainState, imgs: torch.Tensor, targets: torch.Tensor):
        dev = state.params.device
        tensors = bound["tensors"]
        if tensors is None or tensors[0] is not state.params or tensors[1] is not state.batch_stats:
            # each trainable tensor a leaf of its own, so the backward writes
            # each gradient once; frozen ones get no backward
            bound["leaves"] = _bind_model(model, layouts, state, frozen_names)
            bound["tensors"] = (state.params, state.batch_stats)
            model.train()
        leaves = bound["leaves"]
        with exact_fp32():
            with record_function("train_step/forward"):
                old_stats = state.batch_stats.clone()
                heads = model(imgs)
                if not isinstance(heads, (tuple, list)):  # lite: single head
                    heads = (heads,)
            with record_function("train_step/loss"):
                loss, comps = total_loss(heads, targets, io.anchors, tuple(imgs.shape[1:3]),
                                         ignore_thre=tr.iou_loss_thre, num_cls=io.num_cls,
                                         branch_weight=tr.branch_weight)
                if distill_fn is not None:
                    d = distill_loss(tuple(heads), distill_fn(imgs))
                    loss = loss + distill_weight * d
                    comps = dict(comps, distill=d, total=loss)
            with record_function("train_step/backward"):
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with record_function("train_step/optimizer"):
            return _update(state, grads, loss, comps, old_stats, dev)

    def _update(state, grads, loss, comps, old_stats, dev):
        """Adam, clip, apply_if_finite, the statistics' gate and EMA."""
        grad = torch.cat([grads[n].reshape(-1) if n in grads
                          else state.params.new_zeros(b - a)
                          for n, (a, b) in p_layout.spans.items()])

        grads_finite = torch.isfinite(grad).all()
        finite = grads_finite & torch.isfinite(loss.detach())
        # the statistics move only on a finite step, and never for a frozen module
        if frozen_modules:
            if dev not in stats_masks:
                stats_masks[dev] = s_layout.mask(is_frozen, dev)
            keep_new = finite & ~stats_masks[dev]
        else:
            keep_new = finite
        state.batch_stats.copy_(torch.where(keep_new, state.batch_stats, old_stats))

        g = grad
        if tr.grad_clip_norm and tr.grad_clip_norm > 0:
            g = clip_by_global_norm(g, tr.grad_clip_norm)
        count_inc = state.count + 1
        mu = (1.0 - ADAM_B1) * g + ADAM_B1 * state.mu
        nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu
        c = count_inc.to(state.mu.dtype)
        mu_hat = mu / (1.0 - torch.pow(ADAM_B1, c))
        nu_hat = nu / (1.0 - torch.pow(ADAM_B2, c))
        update = -lr_schedule(state.count) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        state.params.copy_(torch.where(grads_finite, state.params + update, state.params))
        if tr.ema_decay > 0:
            one_minus_d = float(np.float32(1.0) - ema_decay_at(state.step, tr.ema_decay,
                                                               tr.ema_ramp))
            state.ema = tuple(e - one_minus_d * (e - n)
                              for e, n in zip(state.ema, (state.params, state.batch_stats)))
        metrics = {k: v.detach() for k, v in comps.items()}
        metrics["lr"] = lr_schedule(state.step)
        state.mu = torch.where(grads_finite, mu, state.mu)
        state.nu = torch.where(grads_finite, nu, state.nu)
        state.count = torch.where(grads_finite, count_inc, state.count)
        state.notfinite_count = torch.where(grads_finite, torch.zeros_like(state.notfinite_count),
                                            state.notfinite_count + 1)
        state.total_notfinite = state.total_notfinite + (~grads_finite).to(torch.int32)
        state.step += 1
        metrics["skipped_nonfinite"] = state.total_notfinite
        metrics["nonfinite_streak"] = state.notfinite_count
        return state, metrics

    return train_step


class Trainer:
    """Epochs of train steps, the reference's log format (``train.py:147-
    150``), per-epoch mAP validation and full-state checkpoints.

    Args:
      config: full framework config.
      batch_per_epoch: steps per epoch (sets the schedule).
      variables: flax-layout numpy tree to start from; else a fresh init
        from ``seed`` (default ``train.seed``).
      compute_dtype: torch.float32, or torch.bfloat16 (autocast over the
        forward; weights, loss and statistics stay fp32).
      arch: ``"fastest"`` or ``"lite"``.
      distill_fn, distill_weight: teacher heads (:func:`make_teacher_fn`)
        and the weight of their MSE in the loss.
      freeze: a :func:`freeze_masks` spec.
      device: "cuda" (the default, which needs a card) or "cpu".
    """

    def __init__(self, config: Config, batch_per_epoch: int = 500,
                 variables: Optional[Dict[str, Any]] = None, seed: Optional[int] = None,
                 logger=None, compute_dtype: torch.dtype = torch.float32,
                 arch: str = "fastest", distill_fn: Optional[Callable] = None,
                 distill_weight: float = 1.0, freeze: Optional[str] = None, device=None):
        self.config = config
        self.logger = logger
        self.arch = arch
        self.batch_per_epoch = batch_per_epoch
        self.device = resolve_device(device)
        io, tr = config.io, config.train
        model = build_model(io.num_cls, io.num_anchors, compute_dtype, arch, variables,
                            seed=tr.seed if seed is None else seed)
        self.frozen_modules: List[str] = []
        if freeze:
            tree = variables_from_module(model)
            _, _, self.frozen_modules = freeze_masks(tree["params"], tree["batch_stats"], freeze)
            if logger:
                logger.info("freeze: %d modules pinned (%s)"
                            % (len(self.frozen_modules), ", ".join(self.frozen_modules)))
        self.model = model.to(self.device)
        sd = self.model.state_dict()
        stat_names = {n for n, _ in self.model.named_buffers()}
        self.layouts = (FlatLayout([(n, t.shape) for n, t in sd.items() if n not in stat_names]),
                        FlatLayout([(n, t.shape) for n, t in sd.items() if n in stat_names]))
        self.lr_schedule = make_lr_schedule(tr.lr0, tr.total_epochs, batch_per_epoch,
                                            tr.warmup_min_iters)
        params = self.layouts[0].flatten(sd, self.device)
        stats = self.layouts[1].flatten(sd, self.device)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        self.state = TrainState(
            params=params, batch_stats=stats, mu=torch.zeros_like(params),
            nu=torch.zeros_like(params), count=zero, notfinite_count=zero.clone(),
            total_notfinite=zero.clone(), step=0,
            ema=(params.clone(), stats.clone()) if tr.ema_decay > 0 else None)
        self._seen_hw: set = set()
        self._train_step = make_train_step(self.model, config, self.lr_schedule, self.layouts,
                                           distill_fn, distill_weight, self.frozen_modules)

    # ------------------------------------------------------------------ steps
    def upload(self, a) -> torch.Tensor:
        """A host batch on the trainer's device; on the card through pinned
        memory with ``non_blocking``, so the host does not wait for it."""
        dtype = self.state.params.dtype
        with record_function("train_step/upload"):
            t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
            if self.device.type != "cuda":
                return t.to(self.device, dtype)
            return t.pin_memory().to(self.device, dtype, non_blocking=True)

    def to_float64(self) -> "Trainer":
        """Run the model and the state in float64 from here on: a reference
        run whose rounding is far below fp32's (the learning rate and the
        EMA decay stay float32, as the JAX trainer computes them).  Host
        batches are uploaded in float64.  Returns ``self``."""
        s = self.state
        self.model.double()
        self.state = dataclasses.replace(
            s, params=s.params.double(), batch_stats=s.batch_stats.double(),
            mu=s.mu.double(), nu=s.nu.double(),
            ema=None if s.ema is None else tuple(e.double() for e in s.ema))
        return self

    def step(self, imgs, targets) -> Dict[str, torch.Tensor]:
        """One step on a host batch (numpy) or device tensors."""
        hw = tuple(imgs.shape[1:3])
        if hw not in self._seen_hw:
            self._seen_hw.add(hw)
            if self.logger and (self.config.train.multiscale_steps > 0 or len(self._seen_hw) > 1):
                self.logger.info("multi-scale: first train step at input %dx%d" % hw)
        if not isinstance(imgs, torch.Tensor):
            imgs = self.upload(imgs)
        if not isinstance(targets, torch.Tensor):
            targets = self.upload(targets)
        self.state, metrics = self._train_step(self.state, imgs, targets)
        return metrics

    def _tree(self, params: torch.Tensor, stats: torch.Tensor) -> Dict[str, Any]:
        return variables_from_module({**self.layouts[0].unflatten(params),
                                      **self.layouts[1].unflatten(stats)})

    @property
    def variables(self) -> Dict[str, Any]:
        """The model as a flax-layout numpy tree (a host copy)."""
        return self._tree(self.state.params, self.state.batch_stats)

    @property
    def ema_variables(self) -> Optional[Dict[str, Any]]:
        """The EMA model as a flax-layout numpy tree, or None without EMA."""
        if self.state.ema is None:
            return None
        return self._tree(*self.state.ema)

    @property
    def eval_variables(self) -> Dict[str, Any]:
        """What validation and deployment score: the EMA model when enabled,
        else the raw weights."""
        return self.ema_variables or self.variables

    # ------------------------------------------------------------------- fit
    def fit(self, loader, total_epochs: Optional[int] = None, validator=None,
            checkpoint_dir: Optional[str] = None, log_every: Optional[int] = None,
            metrics_writer=None, start_epoch: int = 0):
        """Run the training schedule (reference ``train.py:98-160``)."""
        tr = self.config.train
        total_epochs = total_epochs or tr.total_epochs
        log_every = log_every or tr.log_every
        log = self.logger.info if self.logger else print
        bpe = len(loader)
        total_steps = (total_epochs - start_epoch) * bpe
        step_count = 0
        steps_at_mark = 0
        t_mark = time.time()
        history = []

        for epoch in range(start_epoch, total_epochs):
            for batch_id, (imgs, targets) in enumerate(loader):
                metrics = self.step(imgs, targets)
                step_count += 1
                # the abort check does not hang on the log cadence, and costs
                # one host read: every min(log_every, streak) steps
                abort_n = tr.abort_nonfinite_streak
                last_of_epoch = batch_id + 1 == bpe
                if abort_n and (step_count % min(log_every, abort_n) == 0 or last_of_epoch):
                    streak = int(metrics["nonfinite_streak"])
                    if streak >= abort_n:
                        msg = ("aborting: %d consecutive steps with non-finite gradients "
                               "(params untouched since the streak began; check "
                               "data/loss/lr)" % streak)
                        log(msg)
                        raise RuntimeError(msg)
                if step_count % log_every == 0:
                    # one host read of every metric; it waits for the card, so
                    # the time since the last one covers whole steps
                    names = list(metrics)
                    values = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32)
                                          .to(self.device) for k in names]).tolist()
                    metrics = dict(zip(names, values))
                    now = time.time()
                    duration = (now - t_mark) / max(step_count - steps_at_mark, 1)
                    t_mark, steps_at_mark = now, step_count
                    eps = imgs.shape[0] / duration
                    remain = (total_steps - step_count) * duration
                    m, s = divmod(remain, 60)
                    h, m = divmod(m, 60)
                    log("epoch [%d]: current_batch = %d/%d, total_iter = %d, "
                        "loss = %.5f, example/sec = %.3f, lr = %.5f, remain = %d:%02d:%02d"
                        % (epoch, batch_id + 1, bpe, step_count, metrics["total"], eps,
                           metrics["lr"], h, m, s))
                    if metrics_writer is not None:
                        metrics_writer(step_count, {**metrics, "example/sec": eps})

            epoch_info = {"epoch": epoch}
            if validator is not None and epoch > tr.val_after_epoch:
                if self.state.ema is not None:
                    log("validating EMA weights (decay %g, ramp %d)" % (tr.ema_decay, tr.ema_ramp))
                epoch_info["mAP"] = validator(self.eval_variables, epoch)
                lm = getattr(validator, "last_metrics", {})
                if "mAP_grid" in lm:
                    epoch_info["mAP_grid"] = lm["mAP_grid"]
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, epoch, max_to_keep=tr.max_to_keep or None)
            history.append(epoch_info)
            # validation and checkpoints are not training time
            t_mark, steps_at_mark = time.time(), step_count
        return history

    # ----------------------------------------------------------- checkpoints
    def checkpoint_state(self) -> Dict[str, Any]:
        """The full state by ``state_dict`` name, as host tensors."""
        s = self.state
        p_layout, s_layout = self.layouts
        return {
            "params": p_layout.unflatten(s.params),
            "batch_stats": s_layout.unflatten(s.batch_stats),
            "opt_state": {"mu": p_layout.unflatten(s.mu), "nu": p_layout.unflatten(s.nu),
                          "count": s.count.cpu(), "notfinite_count": s.notfinite_count.cpu(),
                          "total_notfinite": s.total_notfinite.cpu()},
            "step": torch.tensor(s.step, dtype=torch.int64),
            "ema": None if s.ema is None else {"params": p_layout.unflatten(s.ema[0]),
                                               "batch_stats": s_layout.unflatten(s.ema[1])},
        }

    def save_checkpoint(self, directory: str, epoch: int,
                        max_to_keep: Optional[int] = None) -> str:
        """Write ``<directory>/epoch_<epoch>/state.pt`` (the full state); with
        ``max_to_keep``, older ``epoch_*`` directories are removed."""
        path = os.path.abspath(os.path.join(directory, f"epoch_{epoch}"))
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
        torch.save(self.checkpoint_state(), tmp)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
        if max_to_keep:
            kept = sorted((int(m.group(1)), d) for d in os.listdir(directory)
                          if (m := re.fullmatch(r"epoch_(\d+)", d)))
            for _, d in kept[:-max_to_keep]:
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
        return path

    def restore_checkpoint(self, path: str) -> None:
        """Restore the full state.  EMA-elastic both ways: a checkpoint
        without EMA resumed into an EMA run seeds the average from the
        restored weights; one with EMA resumed into a run without drops it."""
        ck = load_checkpoint(path)
        p_layout, s_layout = self.layouts
        dev = self.device
        params = p_layout.flatten(ck["params"], dev)
        stats = s_layout.flatten(ck["batch_stats"], dev)
        opt = ck["opt_state"]
        ema = None
        if self.state.ema is not None:
            ema = ((p_layout.flatten(ck["ema"]["params"], dev),
                    s_layout.flatten(ck["ema"]["batch_stats"], dev)) if ck.get("ema")
                   else (params.clone(), stats.clone()))
        self.state = TrainState(
            params=params, batch_stats=stats,
            mu=p_layout.flatten(opt["mu"], dev), nu=p_layout.flatten(opt["nu"], dev),
            count=opt["count"].to(dev, torch.int32),
            notfinite_count=opt["notfinite_count"].to(dev, torch.int32),
            total_notfinite=opt["total_notfinite"].to(dev, torch.int32),
            step=int(ck["step"]), ema=ema)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The saved state of an ``epoch_*`` directory (or its ``state.pt``)."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_variables(path: str, prefer_ema: bool = True) -> Dict[str, Any]:
    """Deployable model variables (flax-layout numpy tree) from an
    ``epoch_*`` checkpoint directory: the EMA model when the checkpoint
    carries one and ``prefer_ema``, else the raw weights."""
    ck = load_checkpoint(path)
    src = ck.get("ema") if prefer_ema else None
    if not src:
        src = ck
    return variables_from_module({**src["params"], **src["batch_stats"]})
