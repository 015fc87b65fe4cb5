"""Serialised programs via ``torch.export`` (``.pt2``).

The port of ``yolofastest_tpu/export/stablehlo.py``, named for the format it
writes.  Each exporter serialises a deploy computation with its weights baked
in, as a versioned, shape-checked artifact that another process loads and
runs without the model's code:

* :func:`export_folded_forward`: the folded graph, ``(B, H, W, 1)`` float
  in, the heads out (``(large, small)``, or ``(small,)`` for lite);
* :func:`export_detect_pipeline`: the whole detect program, ``(B, H, W)``
  uint8 gray in, the detection dict of ``batched_nms`` out (normalise ->
  folded graph -> decode -> NMS);
* :func:`export_int8_forward`: the int8 graph, quantised weights and
  activation scales baked in.

The chain kernel and the NMS kernel are registered operators
(``torch.ops.yolofastest.*``), so the programs record them as nodes: a
``detect.pt2`` exported and run on the card launches 6 chain kernels and 1
NMS kernel a call.  A consumer imports ``yolofastest_torch.kernels`` (which
registers the operators; :func:`load_exported` does so) and nothing of the
model code.

Differences from the JAX artifacts: the detect program runs the folded graph
(the deployed detector's, with the chain kernel), not ``model.apply`` on
unfolded variables; the batch is fixed at export time, as in JAX's; and
tensors made inside the traced function (decode's grids, the NMS outputs)
keep the device they were traced on, so a program is exported on the device
it will run on (``device=None``: the card).  ``torch.export`` records no
cuDNN flag, so :class:`Program` runs fp32 convolutions with TF32 off, as the
``Detector`` does.  ``export/mlir.py`` writes a program's StableHLO text
(``save_exported_mlir``) for the C++ ``yf_shlo``.
"""

from __future__ import annotations

import contextlib
import importlib
import os
from typing import Any, Callable, Dict, Optional

import torch

from yolofastest_torch import kernels  # noqa: F401 (registers torch.ops.yolofastest)
from yolofastest_torch.configs import Config
from yolofastest_torch.models import (fold_batchnorm, folded_apply, folded_apply_lite,
                                      torch_params_from_folded)
from yolofastest_torch.ops import batched_nms, decode_heads, normalize
from yolofastest_torch.ops import decode as _decode
from yolofastest_torch.ops import preprocess as _preprocess
from yolofastest_torch.utils.device import exact_fp32, resolve_device

_FOLDED = {"fastest": folded_apply, "lite": folded_apply_lite}


class Program:
    """An exported program: ``exported`` is the ``torch.export``
    ``ExportedProgram``; :meth:`call` (as JAX's ``Exported.call``) runs it
    without autograd and with fp32 convolutions in full fp32 (TF32 off)."""

    def __init__(self, exported: torch.export.ExportedProgram):
        self.exported = exported
        self._module = None  # made at the first call: a program may only be saved

    def call(self, *args):
        if self._module is None:
            self._module = self.exported.module()
        with torch.no_grad(), exact_fp32():
            return self._module(*args)

    __call__ = call


class _Fn(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def trace(fn, example_args) -> torch.export.ExportedProgram:
    """``torch.export`` (non-strict, no autograd, fp32 without TF32) of
    ``fn`` (a function or an ``nn.Module``) on ``example_args``: the trace
    that both this module and ``export/generic_onnx.py`` take.  The ops'
    per-device constant caches (anchors, resize taps) are cleared after it,
    since the trace may have filled them with its fake tensors."""
    module = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    try:
        with torch.no_grad(), exact_fp32(), _no_stack_traces():
            return torch.export.export(module, tuple(example_args), strict=False)
    finally:
        _decode._anchor_wh.cache_clear()
        _preprocess._device_taps.cache_clear()


@contextlib.contextmanager
def _no_stack_traces():
    """The tracer's per-node Python stack traces off, where this torch has
    the switch: a fifth to a sixth of a trace's time, and no program needs
    them."""
    try:
        fx_config = importlib.import_module("torch.fx.config")
    except ImportError:
        fx_config = None
    old = getattr(fx_config, "do_not_emit_stack_traces", None)
    if old is None:
        yield
        return
    fx_config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        fx_config.do_not_emit_stack_traces = old


_aten = torch.ops.aten
_CASTS = (_aten.to.dtype, _aten.to.dtype_layout, _aten.to.device)


def _drop_bookkeeping(exported: torch.export.ExportedProgram) -> None:
    """Remove the trace's metadata assertions and its casts that change
    nothing (an ``aten.to`` whose output has its input's dtype, device and
    strides returns its input): about half the nodes of the folded graph,
    which the program would otherwise dispatch on every call and
    ``load_exported`` rebuild.  The program's outputs keep their nodes."""
    graph = exported.graph_module.graph
    outputs = set(graph.output_node().all_input_nodes)
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is _aten._assert_tensor_metadata.default and not node.users:
            graph.erase_node(node)
        elif node.target in _CASTS and node not in outputs and not node.kwargs.get("copy"):
            a, b = node.args[0].meta.get("val"), node.meta.get("val")
            if (a is not None and b is not None and a.dtype == b.dtype
                    and a.device == b.device and a.stride() == b.stride()):
                node.replace_all_uses_with(node.args[0])
                graph.erase_node(node)
    graph.lint()
    exported.graph_module.recompile()


def _export(fn: Callable, example_args) -> Program:
    """:func:`trace` of ``fn`` as a :class:`Program`, less its bookkeeping
    nodes."""
    exported = trace(fn, example_args)
    _drop_bookkeeping(exported)
    return Program(exported)


def _heads(out):
    heads = out if isinstance(out, (tuple, list)) else (out,)
    return tuple(h.to(torch.float32) for h in heads)


def export_folded_forward(folded: Dict[str, Any], config: Config, batch: int = 1,
                          compute_dtype: torch.dtype = torch.float32, arch: str = "fastest",
                          device=None) -> Program:
    """Folded graph, weights baked in: (B,H,W,1) float -> head tuple
    ((large, small) for the two-head arch; (small,) for lite), float32.  The
    six res chains are ``yolofastest::res_chain_rows`` nodes."""
    io = config.io
    dev = resolve_device(device)
    params = torch_params_from_folded(folded, dev, compute_dtype)
    apply = _FOLDED[arch]

    def fn(x):
        return _heads(apply(params, x, compute_dtype))

    x = torch.zeros((batch, *io.input_hw, io.input_channels), dtype=torch.float32, device=dev)
    return _export(fn, (x,))


def export_detect_pipeline(variables: Dict[str, Any], config: Config, batch: int = 1,
                           compute_dtype: torch.dtype = torch.float32, arch: str = "fastest",
                           device=None) -> Program:
    """Full pipeline, weights baked in: (B,H,W) uint8 gray -> the detection
    dict (``boxes``, ``conf``, ``cls_score``, ``cls_idx``, ``valid``,
    ``count``).  The graph is the folded one (BatchNorm folded from
    ``variables``), its chains and its NMS the registered kernels."""
    io = config.io
    dev = resolve_device(device)
    params = torch_params_from_folded(fold_batchnorm(variables), dev, compute_dtype)
    apply = _FOLDED[arch]

    def fn(frames):
        heads = _heads(apply(params, normalize(frames, compute_dtype)[..., None], compute_dtype))
        cand = decode_heads(heads, io.anchors, io.input_hw, io.conf_thre, io.max_decode)
        return batched_nms(*cand, iou_thre=io.nms_thre, max_det=io.max_det)

    frames = torch.zeros((batch, *io.input_hw), dtype=torch.uint8, device=dev)
    return _export(fn, (frames,))


def export_int8_forward(variables: Dict[str, Any], config: Config, calibration,
                        batch: int = 1, fused: bool = False, arch: str = "fastest",
                        folded: Optional[Dict[str, Any]] = None,
                        act_scales: Optional[Dict[str, float]] = None,
                        device=None) -> Program:
    """int8 deployment graph, quantised weights and activation scales baked
    in: (B,H,W,1) float net input -> float head tuple ((large, small), or
    (small,) for lite).  ``calibration`` is a batch (or a list of batches)
    of net-input images, calibrated on ``device``; ``folded`` /
    ``act_scales`` override the fold and the calibration (QAT-refined
    weights at their frozen scales).  The int8 graph runs its chains layer
    by layer, so the program holds no kernel node."""
    from yolofastest_torch.quant import QuantParams, calibrate, quantize_weights
    from yolofastest_torch.quant.ptq import quantized_apply, quantized_apply_fused

    io = config.io
    dev = resolve_device(device)
    if folded is None:
        folded = fold_batchnorm(variables)
    batches = calibration if isinstance(calibration, (list, tuple)) else [calibration]
    scales = (calibrate(folded, batches, arch=arch, device=dev) if act_scales is None
              else act_scales)
    qparams = QuantParams(quantize_weights(folded), dev)
    apply_q = quantized_apply_fused if fused else quantized_apply

    def fn(x):
        return _heads(apply_q(qparams, scales, x, arch=arch))

    x = torch.zeros((batch, *io.input_hw, io.input_channels), dtype=torch.float32, device=dev)
    with torch.no_grad():
        fn(x)  # makes the epilogues' constants, so the trace takes them as they are
    return _export(fn, (x,))


def save_exported(program: Program, path: str) -> None:
    """Write ``program`` as a ``.pt2`` file (``torch.export.save``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program.exported, path)


def load_exported(path: str) -> Program:
    """Read a ``.pt2`` file written by :func:`save_exported`.  The kernels'
    operators are registered by this module's import of
    ``yolofastest_torch.kernels``, which is all a consumer needs."""
    return Program(torch.export.load(path))
