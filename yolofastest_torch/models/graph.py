"""Deployment graph: BatchNorm folding and the topology walk over an executor.

The port of ``yolofastest_tpu/models/graph.py``.  :func:`fold_batchnorm` is
the same float64 numpy fold (``kernel' = kernel * g``, ``bias' = bias - mean
* g`` with ``g = scale / sqrt(var + eps)``), so it gives the same bits.
:func:`walk_topology` is the same layer graph, with one difference: the 18
res blocks go to the executor as the six same-shape chains of
:data:`RES_CHAINS` (``ex.res_chain``), so that :class:`FoldedExecutor` runs
each chain as one kernel launch.  The base :class:`Executor` runs a chain
block by block.

Tensors passed along the walk are NHWC, as in the JAX package; a torch
convolution sees them as NCHW tensors in channels_last memory, which is the
same memory, so no copy is made at either end.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yolofastest_torch.kernels.res_block import fused_res_chain_nhwc
from yolofastest_torch.utils.device import exact_fp32

BN_EPS = 1e-5

# The backbone's same-shape chains of res blocks, in walk order.
RES_CHAINS: Tuple[Tuple[str, ...], ...] = (
    ("res1_1",),
    ("res2_1", "res2_2"),
    ("res3_1", "res3_2"),
    ("res3_3", "res3_4", "res3_5", "res3_6"),
    ("res4_1", "res4_2", "res4_3", "res4_4"),
    ("res5_1", "res5_2", "res5_3", "res5_4", "res5_5"),
)


# --------------------------------------------------------------------------- fold
def fold_batchnorm(variables: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """{'params','batch_stats'} -> flat {layer: {'kernel','bias'}} folded
    inference params (numpy).  Layer names match the module names; res blocks
    flatten to ``res1_1/conv1`` etc.  Deconv kernels stay (2,2,Cin,Cout);
    conv kernels stay HWIO."""
    params = variables["params"]
    stats = variables["batch_stats"]
    out: Dict[str, Dict[str, np.ndarray]] = {}

    def fold_one(p, s):
        g = np.asarray(p["bn"]["scale"], np.float64) / np.sqrt(
            np.asarray(s["bn"]["var"], np.float64) + BN_EPS
        )
        kernel = np.asarray(p["kernel"] if "kernel" in p else p["conv"]["kernel"], np.float64)
        kernel = kernel * g  # broadcast over last axis (out channels)
        bias = np.asarray(p["bn"]["bias"], np.float64) - np.asarray(s["bn"]["mean"], np.float64) * g
        return {"kernel": kernel.astype(np.float32), "bias": bias.astype(np.float32)}

    for name, p in params.items():
        if name.startswith("head"):
            out[name] = {
                "kernel": np.asarray(p["kernel"], np.float32),
                "bias": np.asarray(p["bias"], np.float32),
            }
        elif name.startswith("res"):
            for sub in ("conv1", "conv2", "conv3"):
                out[f"{name}/{sub}"] = fold_one(p[sub], stats[name][sub])
        else:
            out[name] = fold_one(p, stats[name])
    return out


# ---------------------------------------------------------------------- executor
class Executor:
    """Interface the topology walk calls into.  ``conv`` covers 1x1/3x3/5x5,
    strided and depthwise; ``deconv2x`` is the kernel-2/stride-2 transposed
    conv; both include bias and optional ReLU.  Tensors are NHWC."""

    def conv(self, x, name: str, kernel: int, stride: int = 1,
             depthwise: bool = False, act: bool = True):
        raise NotImplementedError

    def deconv2x(self, x, name: str):
        raise NotImplementedError

    def head(self, x, name: str):
        raise NotImplementedError

    def add(self, x, y):
        return x + y

    def concat(self, x, y):
        return torch.cat([x, y], dim=-1)

    def res(self, x, name: str):
        """One inverted-residual block: 1x1 expand, 3x3 depthwise, 1x1
        project, plus the input."""
        y = self.conv(x, f"{name}/conv1", 1)
        y = self.conv(y, f"{name}/conv2", 3, depthwise=True)
        y = self.conv(y, f"{name}/conv3", 1, act=False)
        return self.add(y, x)

    def res_chain(self, x, names: Sequence[str]):
        """A chain of same-shape res blocks, block by block."""
        for name in names:
            x = self.res(x, name)
        return x


def walk_topology(x, ex: Executor) -> Tuple[Any, Any]:
    """The YOLO-Fastest layer graph, executor-parameterised, with the res
    blocks grouped into :data:`RES_CHAINS`.  Returns (head_large, head_small)."""
    x = ex.conv(x, "conv0", 3, 2)
    x = ex.conv(x, "conv1_2", 1)
    x = ex.conv(x, "conv1_3", 3, depthwise=True)
    x = ex.conv(x, "conv1_4", 1, act=False)
    x = ex.res_chain(x, RES_CHAINS[0])
    x = ex.conv(x, "conv1_8", 1)
    x = ex.conv(x, "conv1_9", 3, 2)
    x = ex.conv(x, "conv2_1", 1, act=False)
    x = ex.res_chain(x, RES_CHAINS[1])
    x = ex.conv(x, "conv2_2", 1)
    x = ex.conv(x, "conv2_3", 3, 2, depthwise=True)
    x = ex.conv(x, "conv3_1", 1, act=False)
    x = ex.res_chain(x, RES_CHAINS[2])
    x = ex.conv(x, "conv3_2", 1)
    x = ex.conv(x, "conv3_3", 3, depthwise=True)
    x = ex.conv(x, "conv3_4", 1, act=False)
    x = ex.res_chain(x, RES_CHAINS[3])
    x = ex.conv(x, "conv3_5", 1)
    x = ex.conv(x, "conv3_6", 3, 2, depthwise=True)
    x = ex.conv(x, "conv4_1", 1, act=False)
    x = ex.res_chain(x, RES_CHAINS[4])
    c42 = ex.conv(x, "conv4_2", 1)
    x = ex.conv(c42, "conv4_3", 3, 2, depthwise=True)
    x = ex.conv(x, "conv5_1", 1)
    x = ex.res_chain(x, RES_CHAINS[5])
    c52 = ex.conv(x, "conv5_2", 1)
    x = ex.conv(c52, "conv5_3", 5, depthwise=True)
    x = ex.conv(x, "conv5_4", 1, act=False)
    x = ex.conv(x, "conv5_5", 5, depthwise=True)
    x = ex.conv(x, "conv5_6", 1, act=False)
    head_small = ex.head(x, "head_5")

    up = ex.deconv2x(c52, "deconv5_1")
    x = ex.concat(c42, up)
    x = ex.conv(x, "conv4_1_1", 1)
    x = ex.conv(x, "conv4_1_2", 5, depthwise=True)
    x = ex.conv(x, "conv4_1_3", 1, act=False)
    x = ex.conv(x, "conv4_1_4", 5, depthwise=True)
    x = ex.conv(x, "conv4_1_5", 1, act=False)
    head_large = ex.head(x, "head_4")
    return head_large, head_small


# ----------------------------------------------------------------- fp executor
def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class FoldedExecutor(Executor):
    """Float (fp32/bf16) folded inference: conv + bias + optional ReLU, and
    one chain kernel launch per res chain.

    ``params`` comes from :func:`yolofastest_torch.models.convert.torch_params_from_folded`.
    Rounding points follow the JAX ``FoldedExecutor``: the conv emits the
    compute dtype, then the bias (in the compute dtype) is added.  The chain
    kernel rounds where the Pallas chain kernel does, which in bf16 is not
    where the JAX executor's per-conv path rounds.
    """

    chain_fn = staticmethod(fused_res_chain_nhwc)

    def __init__(self, params: Dict[str, Any], compute_dtype=torch.float32):
        self.p = params
        self.dt = compute_dtype

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        p = self.p["layers"][name]
        groups = x.shape[-1] if depthwise else 1
        y = F.conv2d(_nchw(x.to(self.dt)), p["weight"].to(self.dt), None, stride,
                     (kernel - 1) // 2, 1, groups)
        y = _nhwc(y) + p["bias"].to(self.dt)
        return torch.relu(y) if act else y

    def deconv2x(self, x, name):
        p = self.p["layers"][name]
        y = F.conv_transpose2d(_nchw(x.to(self.dt)), p["weight"].to(self.dt), None, 2)
        return torch.relu(_nhwc(y) + p["bias"].to(self.dt))

    def head(self, x, name):
        return self.conv(x, name, 1, act=False)

    def res_chain(self, x, names):
        return self.chain_fn(x.to(self.dt), *self.p["chains"][tuple(names)])


def folded_apply(params: Dict[str, Any], x, compute_dtype=torch.float32):
    """Run the folded deployment graph: (B,H,W,1) -> (head_large, head_small),
    both NHWC.  fp32 convolutions run with TF32 off."""
    with exact_fp32():
        return walk_topology(x, FoldedExecutor(params, compute_dtype))
