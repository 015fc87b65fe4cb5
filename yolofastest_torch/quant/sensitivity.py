"""Mixed-precision int8 deployment: named layers keep their fp kernel.

The deployment half of ``yolofastest_tpu/quant/sensitivity.py``:
:func:`quantized_apply_mixed` (per-layer int8 graph) and
:func:`quantized_apply_fused_mixed` (carried int8 activations) run every
layer in ``fp_layers`` with the fp folded kernel and the rest with the int8
one, each layer as exactly one of the two.  Both executors subclass the
base :class:`Executor`, so the res chains run layer by layer and a kept
``res*/conv*`` layer is picked like any other; the fp half never sees a
whole chain (which would run the fp chain kernel inside the int8 graph).
The sensitivity sweep (``layer_sensitivity`` and its dual/flagged
executors) is not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from yolofastest_torch.models.convert import torch_params_from_folded
from yolofastest_torch.models.graph import Executor, FoldedExecutor
from yolofastest_torch.quant.ptq import (_WALKS, Int8Executor, Int8FusedExecutor,
                                         as_quant_params)
from yolofastest_torch.utils.device import exact_fp32


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
