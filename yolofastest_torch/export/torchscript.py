"""TorchScript export of the folded deployment graph.

The port of ``yolofastest_tpu/export/torchscript.py``.  The reference ships
its model to external runtimes through torch tracing (``torch.jit.trace``
for the RKNN converter, ``rknn_deploy.py:14-20``).  Here the BN-folded graph
is rebuilt op for op on torch tensors and traced into a ``.pt`` that any
libtorch runtime loads without this package.

The traced graph is plain ``torch.nn.functional`` calls on baked weights:
its executor subclasses the base :class:`~yolofastest_torch.models.graph.Executor`,
which runs each res chain block by block, so the trace never meets the
chain kernel (a ctypes call, which tracing cannot record).  I/O as the
reference's exported models: normalised grayscale NCHW ``(B, 1, H, W)``
float32 (``(pixel - 128) / 255``) in, raw ``(head_large, head_small)`` NCHW
logits out (lite: ``head_small``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from yolofastest_torch.models.graph import Executor, walk_topology, walk_topology_lite


class _TorchExecutor(Executor):
    """Folded-graph executor over NCHW tensors; every op is a plain
    ``torch.nn.functional`` call."""

    def __init__(self, weights: Dict[str, Dict[str, Any]]):
        self.p = weights

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        w, b = self.p[name]["kernel"], self.p[name]["bias"]
        groups = x.shape[1] if depthwise else 1
        y = F.conv2d(x, w, b, stride=stride, padding=(kernel - 1) // 2, groups=groups)
        return F.relu(y) if act else y

    def deconv2x(self, x, name):
        return F.relu(F.conv_transpose2d(x, self.p[name]["kernel"], self.p[name]["bias"],
                                         stride=2))

    def head(self, x, name):
        return F.conv2d(x, self.p[name]["kernel"], self.p[name]["bias"])

    def concat(self, x, y):
        return torch.cat([x, y], dim=1)


def build_torch_module(folded: Dict[str, Dict[str, Any]], arch: str = "yolofastest"):
    """Folded params (``fold_batchnorm`` output, HWIO kernels) -> an
    ``nn.Module`` computing the same forward in NCHW, on the CPU.

    Conv kernels HWIO ``(kh,kw,I,O)`` -> OIHW (depthwise ``(kh,kw,1,C)`` ->
    ``(C,1,kh,kw)`` with ``groups=C``); deconv kernels ``(2,2,Cin,Cout)`` ->
    ``(Cin,Cout,2,2)``.
    """
    walk = {"yolofastest": walk_topology, "yolofastest-lite": walk_topology_lite}[arch]

    def to_torch(name, t):
        a = np.asarray(t, np.float32)
        if a.ndim == 4:
            a = a.transpose((2, 3, 0, 1) if name.startswith("deconv") else (3, 2, 0, 1))
        return torch.from_numpy(np.ascontiguousarray(a))

    weights = {name: {k: to_torch(name, v) for k, v in p.items()} for name, p in folded.items()}

    class FoldedNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self._ex = _TorchExecutor(weights)

        def forward(self, x):
            return walk(x, self._ex)

    return FoldedNet().eval()


def export_torchscript(folded: Dict[str, Dict[str, Any]], input_hw, path: str,
                       batch: int = 1, arch: str = "yolofastest") -> str:
    """Trace the folded graph on a ``(batch, 1, H, W)`` float32 example and
    save a self-contained ``.pt``; re-export per resolution.  Returns
    ``path``."""
    module = build_torch_module(folded, arch=arch)
    example = torch.zeros((batch, 1, *input_hw), dtype=torch.float32)
    with torch.no_grad():
        traced = torch.jit.trace(module, example)
    traced.save(path)
    return path
