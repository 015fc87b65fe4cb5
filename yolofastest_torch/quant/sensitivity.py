"""Per-layer int8 sensitivity and mixed-precision int8 deployment.

The port of ``yolofastest_tpu/quant/sensitivity.py``.

* :func:`layer_sensitivity` quantises one layer at a time and measures the
  head-logit damage against the fp folded heads.  As in JAX, the per-layer
  int8/fp choice is data: ``flags`` are boolean tensors on the device, the
  dual executors compute both halves of every layer and join them with
  ``torch.where``, so the sweep is one forward per layer with no host read
  in between; the table is read once at the end.
* :func:`quantized_apply_mixed` (per-layer int8 graph) and
  :func:`quantized_apply_fused_mixed` (carried int8 activations) deploy a
  static fp-layer set, each layer as exactly one of the two kernels.

Every executor here subclasses the base :class:`Executor`, so the res
chains run layer by layer and a ``res*/conv*`` layer is picked like any
other; the fp half never sees a whole chain (which would run the fp chain
kernel inside the int8 graph: its launch count stays 0).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from yolofastest_torch.models.convert import torch_params_from_folded
from yolofastest_torch.models.graph import Executor, FoldedExecutor
from yolofastest_torch.quant.ptq import (_WALKS, Int8Executor, Int8FusedExecutor, QuantParams,
                                         _Q, as_quant_params, calibrate, quantize_weights)
from yolofastest_torch.utils.device import exact_fp32, resolve_device


def _check_fp_layers(qparams, fp_layers) -> None:
    unknown = set(fp_layers) - set(qparams)
    if unknown:
        raise ValueError(f"unknown --keep-fp layer(s): {sorted(unknown)}; "
                         f"valid names are the folded-graph layers, e.g. "
                         f"{sorted(qparams)[:4]} ...")


def fp_params(folded: Dict[str, Any], fp_layers: Sequence[str], device) -> Dict[str, Any]:
    """The fp executor's parameters of ``fp_layers`` from a folded numpy
    tree (the whole tree or just those layers), or ``folded`` itself when it
    is such parameters already."""
    if "layers" in folded:
        return folded
    return torch_params_from_folded({k: folded[k] for k in fp_layers}, device, chains=False)


class _MixedStaticExecutor(Executor):
    """Each layer is the int8 executor's or, for ``fp_layers``, the fp
    folded executor's; both exchange float tensors."""

    def __init__(self, qparams, fp, act_scales, fp_layers):
        self._q = Int8Executor(qparams, act_scales)
        self._f = FoldedExecutor(fp)
        self.fp_layers = frozenset(fp_layers)

    def _pick(self, name):
        return self._f if name in self.fp_layers else self._q

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        return self._pick(name).conv(x, name, kernel, stride, depthwise, act)

    def deconv2x(self, x, name):
        return self._pick(name).deconv2x(x, name)

    def head(self, x, name):
        return self._pick(name).head(x, name)


def quantized_apply_mixed(qparams, folded, act_scales: Dict[str, float], x,
                          fp_layers: Sequence[str] = (), arch: str = "fastest"):
    """Mixed-precision int8 inference: every layer in ``fp_layers`` runs the
    fp folded kernel, the rest the int8 kernel.  ``fp_layers=()`` is exactly
    :func:`yolofastest_torch.quant.ptq.quantized_apply`."""
    _check_fp_layers(qparams, fp_layers)
    qp = as_quant_params(qparams, x.device)
    ex = _MixedStaticExecutor(qp, fp_params(folded, fp_layers, x.device), act_scales,
                              fp_layers)
    with exact_fp32():
        return _WALKS[arch](x, ex)


class _MixedFusedExecutor(Executor):
    """Mixed precision for the fused int8 pipeline: activations stay int8
    between layers, but ``fp_layers`` run their conv with the full-precision
    folded kernel (input dequantised, output requantised at the calibrated
    ``out/<name>`` scale)."""

    def __init__(self, qparams, fp, act_scales, fp_layers):
        self._q = Int8FusedExecutor(qparams, act_scales)
        self._fp = FoldedExecutor(fp)
        self.fp_layers = frozenset(fp_layers)
        self.s = act_scales

    def quantize_input(self, x_f32):
        return self._q.quantize_input(x_f32)

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        if name not in self.fp_layers:
            return self._q.conv(x, name, kernel, stride, depthwise, act)
        y = self._fp.conv(self._q.deq(x), name, kernel, stride, depthwise, act)
        return self._q.requant(y, self.s[f"out/{name}"])

    def deconv2x(self, x, name):
        if name not in self.fp_layers:
            return self._q.deconv2x(x, name)
        y = self._fp.deconv2x(self._q.deq(x), name)
        return self._q.requant(y, self.s[f"out/{name}"])

    def head(self, x, name):
        if name not in self.fp_layers:
            return self._q.head(x, name)
        return self._fp.head(self._q.deq(x), name)

    def add(self, x, y):
        return self._q.add(x, y)

    def concat(self, x, y):
        return self._q.concat(x, y)


def quantized_apply_fused_mixed(qparams, folded, act_scales: Dict[str, float], x,
                                fp_layers: Sequence[str] = (), arch: str = "fastest"):
    """Fused (carried-int8) inference with ``fp_layers`` running their conv
    at full weight precision.  ``fp_layers=()`` is exactly
    :func:`yolofastest_torch.quant.ptq.quantized_apply_fused`."""
    _check_fp_layers(qparams, fp_layers)
    qp = as_quant_params(qparams, x.device)
    ex = _MixedFusedExecutor(qp, fp_params(folded, fp_layers, x.device), act_scales,
                             fp_layers)
    with exact_fp32():
        return _WALKS[arch](ex.quantize_input(x), ex)


# ------------------------------------------------------------------ the sweep
class _DualExecutor(Executor):
    """The fp folded and the int8 executors side by side, joined per layer
    by ``flags[name]`` (a boolean tensor on the device, True = int8), so one
    graph serves every subset.  Both halves exchange float tensors (the
    int8 half quantises its own input)."""

    def __init__(self, qparams: QuantParams, fp, act_scales, flags: Dict[str, torch.Tensor]):
        self._q = Int8Executor(qparams, act_scales)
        self._f = FoldedExecutor(fp)
        self.flags = flags

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        return torch.where(self.flags[name],
                           self._q.conv(x, name, kernel, stride, depthwise, act),
                           self._f.conv(x, name, kernel, stride, depthwise, act))

    def deconv2x(self, x, name):
        return torch.where(self.flags[name], self._q.deconv2x(x, name),
                           self._f.deconv2x(x, name))

    def head(self, x, name):
        return torch.where(self.flags[name], self._q.head(x, name), self._f.head(x, name))


class _DualFusedExecutor(Executor):
    """Flags twin of :class:`_MixedFusedExecutor`: every layer computes the
    int8 kernel and the fp kernel (input dequantised, output requantised at
    ``out/<name>``), and ``flags[name]`` picks one of the two int8 results."""

    def __init__(self, qparams: QuantParams, fp, act_scales, flags: Dict[str, torch.Tensor]):
        self._q = Int8FusedExecutor(qparams, act_scales)
        self._fp = FoldedExecutor(fp)
        self.flags = flags
        self.s = act_scales

    def quantize_input(self, x_f32):
        return self._q.quantize_input(x_f32)

    def _both(self, name, yq: _Q, y_fp) -> _Q:
        s_out = self.s[f"out/{name}"]
        yf = self._q.requant(y_fp, s_out).q
        return _Q(torch.where(self.flags[name], yq.q, yf), s_out)

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        yq = self._q.conv(x, name, kernel, stride, depthwise, act)
        yf = self._fp.conv(self._q.deq(x), name, kernel, stride, depthwise, act)
        return self._both(name, yq, yf)

    def deconv2x(self, x, name):
        return self._both(name, self._q.deconv2x(x, name),
                          self._fp.deconv2x(self._q.deq(x), name))

    def head(self, x, name):
        return torch.where(self.flags[name], self._q.head(x, name),
                           self._fp.head(self._q.deq(x), name))

    def add(self, x, y):
        return self._q.add(x, y)

    def concat(self, x, y):
        return self._q.concat(x, y)


def _device_flags(flags, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=torch.bool, device=device) for k, v in flags.items()}


def quantized_apply_flagged(qparams, folded, act_scales: Dict[str, float], x,
                            flags: Dict[str, Any], arch: str = "fastest"):
    """Per-layer int8 pipeline with int8/fp chosen per layer by ``flags``
    (True = int8; boolean tensors on ``x``'s device, or values made so).
    ``qparams`` is :class:`QuantParams` or :func:`quantize_weights`' tree;
    ``folded`` the fold_batchnorm tree or the fp executor's parameters."""
    ex = _DualExecutor(as_quant_params(qparams, x.device),
                       fp_params(folded, tuple(folded), x.device), act_scales,
                       _device_flags(flags, x.device))
    with exact_fp32():
        return _WALKS[arch](x, ex)


def quantized_apply_fused_flagged(qparams, folded, act_scales: Dict[str, float], x,
                                  flags: Dict[str, Any], arch: str = "fastest"):
    """The fused (carried-int8) pipeline with int8/fp chosen per layer by
    ``flags`` (True = int8)."""
    ex = _DualFusedExecutor(as_quant_params(qparams, x.device),
                            fp_params(folded, tuple(folded), x.device), act_scales,
                            _device_flags(flags, x.device))
    with exact_fp32():
        return _WALKS[arch](ex.quantize_input(x), ex)


def layer_sensitivity(folded: Dict[str, Dict[str, np.ndarray]], batches: Sequence[Any],
                      arch: str = "fastest", act_scales: Optional[Dict[str, float]] = None,
                      device=None, **calib_kwargs) -> List[Dict[str, float]]:
    """Quantise one layer at a time and measure the head-logit damage
    against the fp folded graph, on ``device`` (the card unless the caller
    asks for the CPU).  Returns ``[{layer, mean_abs, max_abs}]`` sorted worst
    first (a stable sort, as JAX's).  ``calib_kwargs`` (method, percentile,
    bins) feed :func:`calibrate` when ``act_scales`` is not given.

    The batches are concatenated; the all-fp flags run once, then one
    forward per layer in ``sorted`` name order, each with that layer's flag
    alone set on the device; the table is read to the host once, at the
    end."""
    dev = resolve_device(device)
    if act_scales is None:
        act_scales = calibrate(folded, batches, arch=arch, device=dev, **calib_kwargs)
    qparams = quantize_weights(folded)
    names = sorted(qparams)
    qp = QuantParams(qparams, dev)
    fp = torch_params_from_folded(folded, dev, chains=False)
    x = torch.from_numpy(np.concatenate([np.asarray(b, np.float32) for b in batches])).to(dev)
    walk = _WALKS[arch]

    def run(flagvec):
        ex = _DualExecutor(qp, fp, act_scales, {n: flagvec[i] for i, n in enumerate(names)})
        heads = walk(x, ex)
        return heads if isinstance(heads, tuple) else (heads,)

    zeros = torch.zeros(len(names), dtype=torch.bool, device=dev)
    rows = []  # per layer: each head's sum of |d|, then the largest |d|
    with torch.inference_mode(), exact_fp32():
        fp_heads = run(zeros)
        for i in range(len(names)):
            flagvec = zeros.clone()
            flagvec[i] = True
            diffs = [(h - f).abs() for h, f in zip(run(flagvec), fp_heads)]
            rows.append(torch.stack([*(d.sum() for d in diffs),
                                     torch.stack([d.amax() for d in diffs]).amax()]))
        table = torch.stack(rows).cpu().tolist()  # the one host read
    size = sum(h.numel() for h in fp_heads)
    out = [{"layer": n, "mean_abs": sum(r[:-1]) / size, "max_abs": r[-1]}
           for n, r in zip(names, table)]
    out.sort(key=lambda r: -r["mean_abs"])
    return out
