"""Model summary: per-layer shapes, parameters and MACs from the topology walk.

The port of ``yolofastest_tpu/models/summary.py`` (``summarize`` and
``format_summary``): an executor whose "tensors" are ``(h, w, c)`` shapes
walks the same graph as every backend, so the table is the deployed graph,
BatchNorm folded.  Host arithmetic only (numpy shapes, no device).  The JAX
module's ``device_cost_analysis`` (XLA's compiled cost of the jitted
forward) has no counterpart here yet (ROADMAP: the ``info`` command).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

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


def format_summary(s: Dict[str, Any]) -> str:
    """The summary dict as the table the JAX ``info`` command prints (without
    its XLA cost line)."""
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
    return "\n".join(lines)
