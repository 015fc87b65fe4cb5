"""Deployment graph: BatchNorm folding and the topology walk over an executor.

The port of ``yolofastest_tpu/models/graph.py``.  :func:`fold_batchnorm` is
the same float64 numpy fold (``kernel' = kernel * g``, ``bias' = bias - mean
* g`` with ``g = scale / sqrt(var + eps)``), so it gives the same bits.
:func:`walk_topology` is the same layer graph, with one difference: the 18
res blocks go to the executor as the six same-shape chains of
:data:`RES_CHAINS` (``ex.res_chain``), so that :class:`FoldedExecutor` runs
each chain as one kernel launch.  The base :class:`Executor` runs a chain
block by block.  :func:`walk_topology_lite` is the single-head lite graph,
grouped the same way, and :func:`unfold_to_variables` lifts a folded tree
back to a variables tree.

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
from yolofastest_torch.parallel.halo import gather_rows, halo_rows, row_window
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


def _identity_bn_var() -> np.float32:
    """The float32 running variance whose fold gain is closest to exactly 1:
    :func:`fold_batchnorm` computes ``g = scale / sqrt(var + BN_EPS)`` in
    float64, so this is the f32 ``var`` that minimises ``|sqrt(var + eps) -
    1|`` (plain ``f32(1 - eps)`` carries its own rounding error, ~3e-8)."""
    v = np.float32(1.0 - BN_EPS)
    cands = [v]
    lo = hi = v
    for _ in range(4):
        lo = np.nextafter(lo, np.float32(0))
        hi = np.nextafter(hi, np.float32(2))
        cands += [lo, hi]
    return min(cands, key=lambda c: abs(np.sqrt(np.float64(c) + BN_EPS) - 1.0))


def unfold_to_variables(folded: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, Any]:
    """Inverse bridge of :func:`fold_batchnorm`: a folded ``{layer: {kernel,
    bias}}`` dict -> the full ``{'params', 'batch_stats'}`` tree with identity
    batch norms (scale 1, mean 0, bias = the folded bias, the variance of
    :func:`_identity_bn_var`), so that every consumer of a variables tree
    takes it unchanged.  Re-folding gives the input back to within one
    float32 ulp.  The statistics are synthetic: fine-tuning from such a tree
    re-estimates them from data."""
    var = _identity_bn_var()
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def lift(layer):
        c = folded[layer]
        bias = np.asarray(c["bias"], np.float32)
        nout = bias.shape[0]
        kernel = np.asarray(c["kernel"], np.float32)
        # deconv modules hold their kernel directly; convs nest it under a
        # "conv" submodule (the zoo layout)
        p = ({"kernel": kernel} if layer.startswith("deconv")
             else {"conv": {"kernel": kernel}})
        p["bn"] = {"scale": np.ones(nout, np.float32), "bias": bias}
        s = {"bn": {"mean": np.zeros(nout, np.float32),
                    "var": np.full(nout, var, np.float32)}}
        return p, s

    for name in folded:
        if name.startswith("head"):
            params[name] = {"kernel": np.asarray(folded[name]["kernel"], np.float32),
                            "bias": np.asarray(folded[name]["bias"], np.float32)}
        elif name.startswith("res"):
            block, sub = name.split("/")
            params.setdefault(block, {})
            stats.setdefault(block, {})
            params[block][sub], stats[block][sub] = lift(name)
        else:
            params[name], stats[name] = lift(name)
    return {"params": params, "batch_stats": stats}


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


def walk_topology_lite(x, ex: Executor):
    """The single-head YOLO-Fastest-lite layer graph, with the res blocks
    grouped into the same :data:`RES_CHAINS` (the lite backbone is the full
    one's, up to ``conv5_6``).  Returns head_small only."""
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
    x = ex.conv(x, "conv4_2", 1)
    x = ex.conv(x, "conv4_3", 3, 2, depthwise=True)
    x = ex.conv(x, "conv5_1", 1)
    x = ex.res_chain(x, RES_CHAINS[5])
    x = ex.conv(x, "conv5_2", 1)
    x = ex.conv(x, "conv5_3", 5, depthwise=True)
    x = ex.conv(x, "conv5_4", 1, act=False)
    x = ex.conv(x, "conv5_5", 5, depthwise=True)
    x = ex.conv(x, "conv5_6", 1, act=False)
    return ex.head(x, "head_5")


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
        return self._conv(x, name, stride, (kernel - 1) // 2, depthwise, act)

    def _conv(self, x, name, stride, row_pad, depthwise, act):
        p = self.p["layers"][name]
        groups = x.shape[-1] if depthwise else 1
        col_pad = (p["weight"].shape[-1] - 1) // 2
        y = F.conv2d(_nchw(x.to(self.dt)), p["weight"].to(self.dt), None, stride,
                     (row_pad, col_pad), 1, groups)
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


class SpatialExecutor(FoldedExecutor):
    """:class:`FoldedExecutor` on a rank's rows of the images (the mesh's
    ``spatial`` axis, :class:`~yolofastest_torch.parallel.halo.RowShard`).

    A conv of kernel k > 1, strided or not, takes the rows its window needs
    from the neighbouring ranks (:func:`~yolofastest_torch.parallel.halo.row_window`:
    1 for 3x3, 2 for 5x5), with zero rows only at the image's true edges, and
    gives exactly its own output rows.  1x1 convs, the heads, ``add``,
    ``concat`` and ``deconv2x`` (kernel 2, stride 2) need no halo.  A res
    chain of K blocks takes K rows on each side, runs the chain kernel on
    the extended rows (the plane its kernel launch sees is those rows) and
    keeps its own: the zero padding at a cut edge spoils one row per block's
    3x3 depthwise, so K rows and no more.
    """

    def __init__(self, params: Dict[str, Any], rows, compute_dtype=torch.float32):
        super().__init__(params, compute_dtype)
        self.rows = rows

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        if kernel == 1:
            return super().conv(x, name, kernel, stride, depthwise, act)
        return self._conv(row_window(x, kernel, stride, self.rows), name, stride, 0,
                          depthwise, act)

    def res_chain(self, x, names):
        ext, above = halo_rows(x, len(names), len(names), self.rows)
        return super().res_chain(ext, names)[:, above:above + x.shape[1]]


def spatial_apply(params: Dict[str, Any], x, rows, compute_dtype=torch.float32,
                  arch: str = "fastest") -> Tuple[Any, ...]:
    """The folded graph on a rank's rows ``x`` (B, h, W, 1) of images split
    over the spatial ranks of ``rows``; returns the heads of the whole
    images (gathered over the spatial ranks, one ``all_reduce``), NHWC, as
    :func:`folded_apply` (or, for ``arch="lite"``, :func:`folded_apply_lite`)
    returns them on the whole images.  ``h`` must be a multiple of 32 (whole
    rows at every stride)."""
    if x.shape[1] % 32:
        raise ValueError(f"spatial_apply: {x.shape[1]} rows a rank is not whole rows at "
                         f"stride 32 ({rows.count} spatial ranks)")
    walk = walk_topology if arch == "fastest" else walk_topology_lite
    with exact_fp32():
        heads = walk(x, SpatialExecutor(params, rows, compute_dtype))
    heads = gather_rows(heads if isinstance(heads, tuple) else (heads,), rows)
    return heads if arch == "fastest" else heads[0]


def folded_apply(params: Dict[str, Any], x, compute_dtype=torch.float32):
    """Run the folded deployment graph: (B,H,W,1) -> (head_large, head_small),
    both NHWC.  fp32 convolutions run with TF32 off."""
    with exact_fp32():
        return walk_topology(x, FoldedExecutor(params, compute_dtype))


def folded_apply_lite(params: Dict[str, Any], x, compute_dtype=torch.float32):
    """Run the folded lite graph: (B,H,W,1) -> head_small, NHWC."""
    with exact_fp32():
        return walk_topology_lite(x, FoldedExecutor(params, compute_dtype))
