"""Caffe ``.prototxt`` / ``.caffemodel`` export of the folded graph.

The port of ``yolofastest_tpu/export/caffe.py``.  Caffe is the reference's
second interchange target (its vendored pytorch->Caffe tracer,
``convert_model/pytorch_to_caffe.py:9-17``).  This module writes the same
two artifacts from the topology walk, the binary with the protobuf wire
helpers of :mod:`.onnx`; the port's chains unroll into the JAX walk's calls
in its order, so the files are byte for byte the JAX writer's.

Format (field numbers from the public ``caffe.proto``):

* ``NetParameter``: ``name``=1, ``layer``=100 (repeated ``LayerParameter``).
* ``LayerParameter``: ``name``=1, ``type``=2, ``bottom``=3, ``top``=4,
  ``blobs``=7 (repeated ``BlobProto``), ``convolution_param``=106.
* ``BlobProto``: ``shape``=7 (``BlobShape.dim``=1, packed varints),
  ``data``=5 (packed little-endian float32).
* BN is folded, ReLU is a separate in-place layer, residual adds are
  ``Eltwise`` (SUM), depthwise convs are ``Convolution`` with ``group ==
  num_output``, and the 2x upsample is ``Deconvolution`` with its weight
  blob ``(Cin, Cout, kh, kw)``.  Caffe blobs may feed several consumers, so
  there are no Split layers.
* ``.caffemodel`` is itself a ``NetParameter`` holding ``name``/``type``/
  ``blobs`` of each weighted layer (Caffe matches layers by name).

Output blobs are ``head_large`` / ``head_small`` (lite: ``head_small``
only).  An independent consumer, ``tools/caffe_check.py``, parses and
executes the files with numpy alone.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from yolofastest_torch.export.onnx import _ld, _packed_ints, _s
from yolofastest_torch.models.graph import Executor, walk_topology, walk_topology_lite

_HEAD_BLOBS = {"head_4": "head_large", "head_5": "head_small"}


class _Layer:
    def __init__(self, typ: str, name: str, bottoms: List[str],
                 tops: List[str], proto: str = "",
                 blobs: Tuple[np.ndarray, ...] = ()):
        self.typ, self.name = typ, name
        self.bottoms, self.tops = bottoms, tops
        self.proto = proto          # extra prototxt body (param blocks)
        self.blobs = blobs          # (weight, bias) for weighted layers


class _CaffeEmit(Executor):
    """Topology-walk executor whose tensors are Caffe blob names; collects
    the layer table (prototxt + caffemodel are both rendered from it)."""

    def __init__(self, folded: Dict[str, Dict[str, Any]]):
        self.p = folded
        self.layers: List[_Layer] = []

    def _conv_layer(self, x: str, name: str, top: str, kernel: int,
                    stride: int, pad: int, group: int, typ: str,
                    weight_oihw: np.ndarray, bias: np.ndarray) -> str:
        # num_output is the top blob's channel count; for Deconvolution the
        # blob layout is (Cin, Cout, kh, kw), everything else (Cout, ., ., .)
        nout = (weight_oihw.shape[1] if typ == "Deconvolution"
                else weight_oihw.shape[0])
        lines = [f"    num_output: {nout}",
                 "    bias_term: true",
                 f"    pad: {pad}",
                 f"    kernel_size: {kernel}"]
        if group != 1:
            lines.append(f"    group: {group}")
        lines.append(f"    stride: {stride}")
        proto = "  convolution_param {\n" + "\n".join(lines) + "\n  }\n"
        self.layers.append(_Layer(typ, name, [x], [top], proto,
                                  (weight_oihw, np.asarray(bias, np.float32))))
        return top

    def _relu(self, blob: str) -> str:
        # standard Caffe idiom: activation layers run in place (top == bottom)
        self.layers.append(_Layer("ReLU", f"relu_{blob}", [blob], [blob]))
        return blob

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        k = np.asarray(self.p[name]["kernel"], np.float32)  # HWIO
        group = int(k.shape[3]) if depthwise else 1
        # HWIO -> Caffe's OIHW; depthwise (kh,kw,1,C) -> (C,1,kh,kw)
        y = self._conv_layer(x, name, name, kernel, stride, (kernel - 1) // 2,
                             group, "Convolution", k.transpose(3, 2, 0, 1),
                             self.p[name]["bias"])
        return self._relu(y) if act else y

    def deconv2x(self, x, name):
        k = np.asarray(self.p[name]["kernel"], np.float32)  # (2,2,Cin,Cout)
        # Caffe Deconvolution weights are (Cin, Cout, kh, kw)
        y = self._conv_layer(x, name, name, 2, 2, 0, 1, "Deconvolution",
                             k.transpose(2, 3, 0, 1), self.p[name]["bias"])
        return self._relu(y)

    def head(self, x, name):
        k = np.asarray(self.p[name]["kernel"], np.float32)
        return self._conv_layer(x, name, _HEAD_BLOBS[name], 1, 1, 0, 1,
                                "Convolution", k.transpose(3, 2, 0, 1),
                                self.p[name]["bias"])

    def add(self, x, y):
        top = f"add_{len(self.layers)}"
        self.layers.append(_Layer(
            "Eltwise", top, [x, y], [top],
            "  eltwise_param {\n    operation: SUM\n  }\n"))
        return top

    def concat(self, x, y):
        top = f"cat_{len(self.layers)}"
        self.layers.append(_Layer(
            "Concat", top, [x, y], [top],
            "  concat_param {\n    axis: 1\n  }\n"))
        return top


def _blob_proto(a: np.ndarray) -> bytes:
    """BlobProto: shape(7){dim(1) packed} + data(5) packed float32."""
    a = np.ascontiguousarray(a, np.float32)
    return (_ld(5, a.astype("<f4").tobytes())
            + _ld(7, _packed_ints(1, a.shape)))


def export_caffe(folded: Dict[str, Dict[str, Any]], input_hw,
                 prototxt_path: str, caffemodel_path: Optional[str] = None,
                 arch: str = "yolofastest") -> None:
    """Write the folded graph (``fold_batchnorm`` output) as Caffe
    ``.prototxt`` + ``.caffemodel``.

    ``input_hw`` is the net input ``(H, W)``; the input blob is ``data``,
    grayscale NCHW ``(1, 1, H, W)`` with the reference's ``(pixel-128)/255``
    normalisation applied by the consumer.  ``arch`` selects the two-head
    graph or the single-head lite graph.
    """
    if caffemodel_path is None:
        stem = (prototxt_path[: -len(".prototxt")]
                if prototxt_path.endswith(".prototxt") else prototxt_path)
        caffemodel_path = stem + ".caffemodel"
    h, w = int(input_hw[0]), int(input_hw[1])

    em = _CaffeEmit(folded)
    em.layers.append(_Layer(
        "Input", "data", [], ["data"],
        "  input_param {\n    shape {\n"
        f"      dim: 1\n      dim: 1\n      dim: {h}\n      dim: {w}\n"
        "    }\n  }\n"))
    if arch == "yolofastest":
        walk_topology("data", em)
    elif arch == "yolofastest-lite":
        walk_topology_lite("data", em)
    else:
        raise ValueError(f"unknown arch {arch!r}")

    net_name = f"{arch}_{h}x{w}"
    with open(prototxt_path, "w") as f:
        f.write(f'name: "{net_name}"\n')
        for L in em.layers:
            f.write("layer {\n")
            f.write(f'  name: "{L.name}"\n  type: "{L.typ}"\n')
            for b in L.bottoms:
                f.write(f'  bottom: "{b}"\n')
            for t in L.tops:
                f.write(f'  top: "{t}"\n')
            f.write(L.proto)
            f.write("}\n")

    net = _s(1, net_name)
    for L in em.layers:
        if not L.blobs:
            continue
        layer = _s(1, L.name) + _s(2, L.typ)
        layer += b"".join(_ld(7, _blob_proto(b)) for b in L.blobs)
        net += _ld(100, layer)
    with open(caffemodel_path, "wb") as f:
        f.write(net)
