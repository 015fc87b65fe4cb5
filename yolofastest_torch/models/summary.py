"""Model summary: per-layer shapes, parameters and MACs from the topology walk.

The port of ``yolofastest_tpu/models/summary.py`` (``summarize`` and
``format_summary``): an executor whose "tensors" are ``(h, w, c)`` shapes
walks the same graph as every backend, so the table is the deployed graph,
BatchNorm folded.  Host arithmetic only (numpy shapes, no device).

``device_cost_analysis`` keeps the JAX function's name and keys, but it is
not XLA's cost analysis of a compiled forward: the port has no compiler to
ask, so it counts the operations and bytes of the port's own folded forward
from the same walk, at a given batch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from yolofastest_torch.models.graph import Executor, walk_topology, walk_topology_lite


class _SummaryExecutor(Executor):
    """Tensors are ``(h, w, c)`` shapes; every op appends a table row.  The
    base class's ``res_chain`` unrolls the chains into their layers."""

    def __init__(self, folded: Dict[str, Dict[str, Any]]):
        self.p = folded
        self.rows: List[Dict[str, Any]] = []

    def _row(self, name, typ, detail, out, params, macs):
        self.rows.append({"name": name, "type": typ, "detail": detail, "out": out,
                          "params": int(params), "macs": int(macs)})

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        h, w, cin = x
        k = self.p[name]["kernel"]  # HWIO
        cout = int(k.shape[-1])
        ho, wo = math.ceil(h / stride), math.ceil(w / stride)  # SAME padding
        groups = cin if depthwise else 1
        macs = ho * wo * kernel * kernel * (cin // groups) * cout
        params = int(np.prod(k.shape)) + cout  # + the folded bias
        detail = f"{kernel}x{kernel}/{stride}" + ("+relu" if act else "")
        self._row(name, "dwconv" if depthwise else "conv", detail, (ho, wo, cout), params, macs)
        return (ho, wo, cout)

    def deconv2x(self, x, name):
        h, w, cin = x
        k = self.p[name]["kernel"]  # (2, 2, Cin, Cout)
        cout = int(k.shape[-1])
        macs = h * w * 4 * cin * cout  # kernel 2, stride 2: each input pixel feeds 4 taps
        self._row(name, "deconv", "2x2/2+relu", (2 * h, 2 * w, cout),
                  int(np.prod(k.shape)) + cout, macs)
        return (2 * h, 2 * w, cout)

    def head(self, x, name):
        h, w, cin = x
        k = self.p[name]["kernel"]
        cout = int(k.shape[-1])
        self._row(name, "head", "1x1/1", (h, w, cout), int(np.prod(k.shape)) + cout,
                  h * w * cin * cout)
        return (h, w, cout)

    def add(self, x, y):
        if x != y:
            raise ValueError(f"residual shape mismatch {x} vs {y}")
        return x

    def concat(self, x, y):
        if x[:2] != y[:2]:
            raise ValueError(f"concat spatial mismatch {x} vs {y}")
        return (x[0], x[1], x[2] + y[2])


def summarize(folded: Dict[str, Dict[str, Any]], input_hw,
              arch: str = "yolofastest") -> Dict[str, Any]:
    """-> {rows, total_params, total_macs, input_hw, arch, heads}.

    ``rows`` is the per-layer table in walk order; ``total_macs`` counts one
    multiply-accumulate per kernel tap (FLOPs ~ 2x MACs)."""
    h, w = int(input_hw[0]), int(input_hw[1])
    ex = _SummaryExecutor(folded)
    walk = {"yolofastest": walk_topology, "yolofastest-lite": walk_topology_lite}[arch]
    result = walk((h, w, 1), ex)
    # a "tensor" is itself an (h, w, c) tuple, so tell one head from two by arch
    heads = list(result) if arch == "yolofastest" else [result]
    return {"rows": ex.rows, "total_params": sum(r["params"] for r in ex.rows),
            "total_macs": sum(r["macs"] for r in ex.rows), "input_hw": (h, w),
            "arch": arch, "heads": heads}


def format_summary(s: Dict[str, Any], device_cost: Optional[Dict[str, float]] = None) -> str:
    """The summary dict as the table the JAX ``info`` command prints; with
    ``device_cost`` (:func:`device_cost_analysis`) a last line of the port's
    count in place of JAX's XLA line."""
    h, w = s["input_hw"]
    lines = [f"{s['arch']}  input (N, {h}, {w}, 1)  [BN-folded deployment graph]"]
    hdr = f"{'layer':<16}{'type':<8}{'k/s':<12}{'output':<16}{'params':>8}{'MACs':>12}"
    lines += [hdr, "-" * len(hdr)]
    for r in s["rows"]:
        ho, wo, c = r["out"]
        lines.append(f"{r['name']:<16}{r['type']:<8}{r['detail']:<12}"
                     f"{f'({ho}, {wo}, {c})':<16}{r['params']:>8}{r['macs']:>12,}")
    lines.append("-" * len(hdr))
    tp, tm = s["total_params"], s["total_macs"]
    lines.append(f"total params: {tp:,}   MACs/img: {tm:,} ({2 * tm / 1e9:.3f} GFLOPs)")
    lines.append("heads: " + ", ".join(str(tuple(x)) for x in s["heads"]))
    if device_cost:
        lines.append("port's count of its fp32 forward (batch %d): %.3f GFLOPs/img, %.1f MB "
                     "device traffic/img (from the walk's shapes, not a compiler's "
                     "analysis)" % (device_cost["batch"], device_cost["flops_per_img"] / 1e9,
                                    device_cost["bytes_per_img"] / 1e6))
    return "\n".join(lines)


class _CostExecutor(_SummaryExecutor):
    """The summary walk that also counts, per image, the float32 operations
    and the bytes each layer reads and writes as the port's folded forward
    runs it: a layer reads its input and its weights and writes its output;
    a res chain is one kernel, which reads its input and every weight of its
    blocks and writes its output (its inner activations stay on chip)."""

    def __init__(self, folded, batch: int):
        super().__init__(folded)
        self.batch = batch
        self.flops = 0
        self.bytes = 0.0
        self.in_chain = False

    def _traffic(self, elements: int, params: int = 0) -> None:
        """float32 bytes per image: activations per image, weights once a batch."""
        self.bytes += 4 * (elements + params / self.batch)

    def _layer(self, x, out, act: bool):
        r = self.rows[-1]
        n_out = math.prod(out)
        self.flops += 2 * r["macs"] + n_out * (2 if act else 1)  # + bias, + ReLU
        if not self.in_chain:
            self._traffic(math.prod(x) + n_out, r["params"])
        return out

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        return self._layer(x, super().conv(x, name, kernel, stride, depthwise, act), act)

    def deconv2x(self, x, name):
        return self._layer(x, super().deconv2x(x, name), True)

    def head(self, x, name):
        return self._layer(x, super().head(x, name), False)

    def add(self, x, y):
        self.flops += math.prod(x)
        if not self.in_chain:
            self._traffic(3 * math.prod(x))
        return super().add(x, y)

    def concat(self, x, y):
        out = super().concat(x, y)
        self._traffic(math.prod(x) + math.prod(y) + math.prod(out))
        return out

    def res_chain(self, x, names):
        first = len(self.rows)
        self.in_chain = True
        out = super().res_chain(x, names)
        self.in_chain = False
        self._traffic(math.prod(x) + math.prod(out), sum(r["params"] for r in self.rows[first:]))
        return out


def device_cost_analysis(folded, input_hw, arch: str = "yolofastest",
                         batch: int = 8) -> Dict[str, float]:
    """``{batch, flops_per_img, bytes_per_img}`` of the port's fp32 folded
    forward at ``batch``, counted from the walk's shapes (no device, no
    compiler): 2 operations a multiply-accumulate plus each bias, ReLU and
    residual add; the bytes each layer reads and writes (weights once a
    batch), a res chain counted as the one kernel that runs it.  The JAX
    function of this name returns XLA's cost analysis of its compiled
    forward instead, which fuses and counts in its own way."""
    h, w = int(input_hw[0]), int(input_hw[1])
    ex = _CostExecutor(folded, batch)
    walk = {"yolofastest": walk_topology, "yolofastest-lite": walk_topology_lite}[arch]
    walk((h, w, 1), ex)
    return {"batch": batch, "flops_per_img": float(ex.flops), "bytes_per_img": ex.bytes}
