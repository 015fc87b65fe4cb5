"""Quantisation-aware fine-tuning of the folded deployment graph.

The port of ``yolofastest_tpu/quant/qat.py``: fine-tune the folded weights
through a fake-quantised forward, so that the model learns to sit on the
int8 grid it is deployed on.

* :class:`FakeQuantExecutor` drives the shared topology walk: each layer's
  input is fake-quantised at its fixed calibrated scale, its weights per
  output channel at the dynamic ``amax / 127`` scale, and the convolution is
  a float one.  It subclasses the base :class:`Executor`, so the res chains
  run block by block and every one of their layers is fake-quantised (the
  fp executor's ``res_chain`` would run the fp chain kernel instead).
* Rounding has the straight-through gradient (:func:`ste_round`); clipping
  keeps its natural gradient, zero outside the range.  The activation
  scales stay frozen.
* :func:`qat_finetune` runs optax's ``adam(lr)`` (the Trainer's update,
  :func:`yolofastest_torch.train.trainer.adam_update`) under one of two
  losses: distillation against the fp folded teacher's heads (computed once
  per batch; on the card the teacher's six chains are the chain kernel), or
  the YOLOv3 loss on labels.  It returns the lowest-loss iterate.  The
  step's loss and gradient run under
  :func:`~yolofastest_torch.utils.device.deterministic_fp32`, so a run
  repeats bit for bit on the card.

**The arithmetic follows JAX's jitted step** (measured on the CPU with
``tools/torch_qat_parity.py``):

* ``jnp.clip`` is a ``maximum`` then a ``minimum``, whose gradient splits a
  tie in half: at a bound the gradient is 0.5, where ``torch.clamp`` gives
  1.  A layer's largest weight lands on +-127 exactly in most output
  channels, so the port clips with ``torch.maximum``/``torch.minimum``,
  which split ties as JAX does.
* The activation scales are constants of the jitted step, and XLA computes
  ``x / s`` as ``x * (1 / s)``, the reciprocal rounded once in the compute
  dtype, and the gradient's ``g * s * (1 / s)`` as ``g * (s * (1 / s))``,
  the two constants folded into one; the clip bounds are ``+-127 * s``
  rounded once.  ``fake_quant_weight``'s ``amax / 127`` is a division by a
  constant as well, so its scale is ``amax * (1 / 127)``, which is an ulp
  off :func:`quantize_weights`' ``amax / 127`` for some channels; the
  weights' own ``k / s`` divides by a computed scale and stays a division.

Everything computes in float32, or in float64 for a float64 run
(``qat_finetune(dtype=torch.float64)``, the reference run against JAX's x64
step).  The trees :func:`qat_finetune` returns have their keys sorted at
both levels, as JAX's ``tree_map`` returns them (the order the int8 export
writes layers in).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yolofastest_torch.models.convert import torch_params_from_folded
from yolofastest_torch.models.graph import (Executor, FoldedExecutor, _nchw, _nhwc,
                                            walk_topology, walk_topology_lite)
from yolofastest_torch.train.trainer import FlatLayout, adam_update
from yolofastest_torch.utils.device import deterministic_fp32, exact_fp32, resolve_device

_WALKS = {"fastest": walk_topology, "lite": walk_topology_lite}
Q_MAX = 127.0

__all__ = ["ste_round", "fake_quant_act", "fake_quant_weight", "FakeQuantExecutor",
           "QatRun", "qat_apply", "qat_finetune"]


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _const(value, dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``value``, already rounded to ``dtype`` in numpy."""
    return torch.tensor(value, dtype=dtype, device=device)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip``: maximum, then minimum; a value on a bound takes half
    the gradient."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _act_consts(scale: float, dtype: torch.dtype, device) -> Tuple[torch.Tensor, ...]:
    """``(s, 1 / s, s * (1 / s), -127 s, 127 s)``, each rounded once to
    ``dtype``."""
    f = np.float64 if dtype == torch.float64 else np.float32
    s = f(scale)
    inv = f(1) / s
    return tuple(_const(v, dtype, device) for v in (s, inv, s * inv, f(-Q_MAX) * s,
                                                    f(Q_MAX) * s))


class _SteScale(torch.autograd.Function):
    """``ste_round(v * inv) * s`` whose gradient is ``g * (s * inv)``: XLA
    folds the backward's two constant factors ``g * s * (1 / s)`` into one
    (their product is 1 or an ulp off it)."""

    @staticmethod
    def forward(ctx, v, s, inv, folded):
        ctx.save_for_backward(folded)
        v = v * inv
        return (v + (torch.round(v) - v)) * s

    @staticmethod
    def backward(ctx, g):
        (folded,) = ctx.saved_tensors
        return g * folded, None, None, None


def _fake_quant_act(x: torch.Tensor, consts: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    s, inv, folded, lo, hi = consts
    return _SteScale.apply(_clip(x, lo, hi), s, inv, folded)


def fake_quant_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-tensor symmetric fake-quant at a fixed scale: the values of
    ``Int8Executor``'s input quantisation followed by its dequantisation;
    the gradient is 1 inside ``+-127 s``, 0.5 on the bounds, 0 outside."""
    dt = _compute_dtype(x)
    return _fake_quant_act(x.to(dt), _act_consts(scale, dt, x.device))


def fake_quant_weight(k: torch.Tensor) -> torch.Tensor:
    """Per-output-channel (last axis) symmetric fake-quant with the dynamic
    scale ``amax * (1 / 127)``, recomputed from the current weights and
    detached."""
    dt = _compute_dtype(k)
    k = k.to(dt)
    f = np.float64 if dt == torch.float64 else np.float32
    amax = k.detach().abs().amax(dim=tuple(range(k.ndim - 1)))
    s = torch.where(amax > 0, amax * _const(f(1) / f(Q_MAX), dt, k.device), 1.0)
    q = _const(Q_MAX, dt, k.device)
    return ste_round(_clip(k / s, -q, q)) * s


class FakeQuantExecutor(Executor):
    """Differentiable stand-in for ``Int8Executor`` over the shared walk.

    ``params`` is ``{layer: {"kernel", "bias"}}`` of tensors in the folded
    tree's layout (HWIO kernels; the deconv's ``(2, 2, Cin, Cout)``), all in
    one dtype; the activation constants are made on their device once per
    layer."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]],
                 act_scales: Dict[str, float]):
        self.p = params
        self.s = act_scales
        self._consts: Dict[str, Tuple[torch.Tensor, ...]] = {}

    def _xq(self, x, name):
        c = self._consts.get(name)
        if c is None:
            k = self.p[name]["kernel"]
            c = self._consts[name] = _act_consts(self.s[name], k.dtype, k.device)
        return _fake_quant_act(x.to(c[0].dtype), c)

    def _conv(self, x, name, stride, groups, pad):
        p = self.p[name]
        w = fake_quant_weight(p["kernel"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.conv2d(_nchw(self._xq(x, name)), w, None, stride, pad, 1, groups)
        return _nhwc(y) + p["bias"]

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        y = self._conv(x, name, stride, x.shape[-1] if depthwise else 1, (kernel - 1) // 2)
        return torch.relu(y) if act else y

    def deconv2x(self, x, name):
        p = self.p[name]
        w = fake_quant_weight(p["kernel"]).permute(2, 3, 0, 1)  # (Cin, Cout, 2, 2)
        y = F.conv_transpose2d(_nchw(self._xq(x, name)), w, None, 2)
        return torch.relu(_nhwc(y) + p["bias"])

    def head(self, x, name):
        return self._conv(x, name, 1, 1, 0)


def _tensor_tree(folded, device, dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    return {n: {k: torch.as_tensor(np.asarray(v)).to(device, dtype) for k, v in p.items()}
            for n, p in folded.items()}


def qat_apply(folded, act_scales: Dict[str, float], x: torch.Tensor, arch: str = "fastest"):
    """Fake-quant forward: (B, H, W, 1) float -> head logits, differentiable
    with respect to ``folded``'s tensors (kernel and bias leaves).  A numpy
    tree is put on ``x``'s device in ``x``'s compute dtype."""
    leaf = next(iter(next(iter(folded.values())).values()))
    params = folded if isinstance(leaf, torch.Tensor) else _tensor_tree(
        folded, x.device, _compute_dtype(x))
    with exact_fp32():
        return _WALKS[arch](x, FakeQuantExecutor(params, act_scales))


def _as_head_tuple(heads) -> Tuple[torch.Tensor, ...]:
    return heads if isinstance(heads, tuple) else (heads,)


class _LayerFoldedExecutor(FoldedExecutor):
    """The fp folded executor with its chains run layer by layer: the
    float64 teacher, which the chain kernel does not take."""

    res_chain = Executor.res_chain


def _teacher(folded, device, dtype, arch):
    """The fp folded forward (heads as a tuple) of the distillation
    teacher: in float32 the chains are the chain kernel on the card."""
    params = torch_params_from_folded(folded, device, dtype, chains=dtype != torch.float64)
    ex = (FoldedExecutor if dtype != torch.float64 else _LayerFoldedExecutor)(params, dtype)

    def teach(x):
        with torch.no_grad(), exact_fp32():
            return _as_head_tuple(_WALKS[arch](x, ex))

    return teach


def _tree_layout(folded) -> FlatLayout:
    """The folded tree's leaves as ``"layer/leaf"`` spans of one flat
    vector, layers and leaves sorted (JAX's tree order)."""
    return FlatLayout([(f"{n}/{leaf}", tuple(np.shape(folded[n][leaf])))
                       for n in sorted(folded) for leaf in sorted(folded[n])])


def _nest(flat_tree: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    tree: Dict[str, Dict[str, Any]] = {}
    for key, v in flat_tree.items():
        n, leaf = key.rsplit("/", 1)
        tree.setdefault(n, {})[leaf] = v
    return tree


class QatRun:
    """One fine-tuning run's fixed parts on a device: the batches, the
    supervision (the teacher's heads, computed here, or the targets), the
    flat parameter layout and the step.  :func:`qat_finetune` drives it;
    :meth:`step` also takes any state, so a run can be held step by step
    against another from the same state."""

    def __init__(self, folded, act_scales, batches, *, arch, targets, anchors, input_hw,
                 num_cls, lr, conf_weight, device, dtype):
        self.dtype, self.lr, self.conf_weight = dtype, lr, conf_weight
        self.layout = _tree_layout(folded)
        self.theta0 = torch.cat([torch.as_tensor(np.asarray(folded[n][leaf])).reshape(-1)
                                 for n, leaf in (k.rsplit("/", 1) for k in self.layout.names)]
                                ).to(device, dtype)
        self.xs = [torch.as_tensor(np.asarray(b, np.float32)).to(device, dtype)
                   for b in batches]
        self.walk = _WALKS[arch]
        self.ex = FakeQuantExecutor({}, act_scales)  # its activation constants made once
        if targets is None:
            teach = _teacher(folded, device, dtype, arch)
            self.refs = [teach(x) for x in self.xs]
            self.loss_fn = self._distill_loss
        else:
            from yolofastest_torch.losses import total_loss

            self.refs = [torch.as_tensor(np.asarray(t)).to(device) for t in targets]
            self.loss_fn = lambda heads, tgt: total_loss(heads, tgt, anchors, input_hw,
                                                         num_cls=num_cls)[0]

    def _distill_loss(self, heads, ref):
        if self.conf_weight == 1.0:
            return sum(torch.mean((h - r) ** 2) for h, r in zip(heads, ref)) / len(heads)
        # the objectness channel (offset 4 of each anchor's 5 + C block)
        # weighted: the deployment failure is a conf logit under the gate
        tot = 0.0
        for h, r in zip(heads, ref):
            blk = h.shape[-1] // 3
            w = torch.ones(h.shape[-1], dtype=h.dtype, device=h.device)
            w[4::blk] = self.conf_weight
            tot = tot + torch.mean((h - r) ** 2 * w) / torch.mean(w)
        return tot / len(heads)

    def loss_and_grad(self, theta: torch.Tensor, j: int):
        """The loss on batch ``j`` at the flat parameters ``theta`` and its
        gradient."""
        theta = theta.detach().requires_grad_(True)
        self.ex.p = _nest(self.layout.views(theta))
        with deterministic_fp32():
            loss = self.loss_fn(_as_head_tuple(self.walk(self.xs[j], self.ex)), self.refs[j])
            (g,) = torch.autograd.grad(loss, theta)
        return loss.detach().to(self.dtype), g

    def step(self, theta, mu, nu, count, j: int):
        """One Adam step on batch ``j`` from ``(theta, mu, nu, count)``
        (``count``: the updates taken so far, an int32 tensor):
        ``(new theta, mu, nu, count, loss at theta, gradient)``."""
        loss, g = self.loss_and_grad(theta, j)
        with torch.no_grad():
            count = count + 1
            update, mu, nu = adam_update(g, mu, nu, count, self.lr)
            return theta.detach() + update, mu, nu, count, loss, g


def qat_finetune(
    folded: Dict[str, Dict[str, np.ndarray]],
    act_scales: Dict[str, float],
    batches: Sequence[np.ndarray],
    *,
    arch: str = "fastest",
    targets: Optional[Sequence[np.ndarray]] = None,
    anchors: Optional[Sequence[Sequence[Tuple[float, float]]]] = None,
    input_hw: Optional[Tuple[int, int]] = None,
    num_cls: int = 3,
    steps: int = 50,
    lr: float = 1e-4,
    conf_weight: float = 1.0,
    snapshot_every: int = 0,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[Any, ...]:
    """Fine-tune folded weights through the fake-quant graph, on ``device``
    (the card unless the caller asks for the CPU).

    Args as JAX's: ``folded`` (not mutated), the frozen ``act_scales`` of
    ``calibrate``, image ``batches`` (B, H, W, 1), optional per-batch
    ``targets`` (B, 64, 6) with ``anchors`` and ``input_hw`` for the label
    loss (else distillation against the fp folded teacher), ``steps`` Adam
    steps cycling over the batches at ``lr``, ``conf_weight`` > 1 to weight
    the objectness channels in the distillation MSE, and ``snapshot_every``
    = K > 0 for every K-th step's parameters as a third element.  ``dtype``
    is float32, or float64 for a reference run.

    Returns ``(finetuned_folded_numpy, per-step loss history)``: the
    parameters of the lowest finite loss on the trajectory (the loss of a
    step is that of the parameters it starts from; STE training is noisy).
    The losses stay on the device and are read to the host once, after the
    last step.
    """
    if targets is not None and (anchors is None or input_hw is None):
        raise ValueError("label mode needs anchors and input_hw")
    if not batches:
        raise ValueError("qat_finetune needs at least one image batch")
    if targets is not None and len(targets) != len(batches):
        raise ValueError("targets must pair 1:1 with batches")
    dev = resolve_device(device)
    run = QatRun(folded, act_scales, batches, arch=arch, targets=targets, anchors=anchors,
                 input_hw=input_hw, num_cls=num_cls, lr=lr, conf_weight=conf_weight,
                 device=dev, dtype=dtype)
    theta = best = run.theta0
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    best_loss = torch.full((), float("inf"), dtype=dtype, device=dev)
    losses, snapshots = [], []
    for i in range(steps):
        new, mu, nu, count, loss, _ = run.step(theta, mu, nu, count, i % len(run.xs))
        better = torch.isfinite(loss) & (loss < best_loss)
        best_loss = torch.where(better, loss, best_loss)
        best = torch.where(better, theta, best)
        losses.append(loss)
        theta = new
        if snapshot_every and (i + 1) % snapshot_every == 0:
            snapshots.append(theta)
    history = torch.stack(losses).cpu().tolist() if losses else []
    def numpy_tree(flat):
        return _nest({k: v.numpy() for k, v in run.layout.unflatten(flat).items()})

    result = numpy_tree(best)
    if snapshot_every:
        return result, history, [numpy_tree(s) for s in snapshots]
    return result, history
