"""ONNX export and import of the folded deployment graph, without the onnx
package.

The port of ``yolofastest_tpu/export/onnx.py``.  An ONNX
file is a protobuf ``ModelProto``; the writer below serialises the folded
graph directly with the protobuf wire format (varint tags and
length-delimited submessages), through the same topology walk as every other
executor: an :class:`~yolofastest_torch.models.graph.Executor` whose
"tensors" are ONNX value names and whose ops append ``NodeProto`` messages.  The
port's walk hands each res chain to ``Executor.res_chain``, which the base
class unrolls into the same ``conv``/``add`` calls, in the same order, as the
JAX walk's blocks, so the files are byte for byte the JAX writer's; only the
producer name (ModelProto field 2) names this package.

Standard opset 13, NCHW: Conv / Relu / Add / Concat / ConvTranspose.  Input
``input`` is the normalised grayscale ``(N, 1, H, W)`` float32 batch
(``(pixel - 128) / 255``); outputs are the raw ``head_large`` /
``head_small`` logit maps (lite: ``head_small`` only); the batch dimension is
symbolic.  :func:`export_onnx_detect` adds the decode and NMS tail.
:func:`import_onnx` reads both our BN-folded exports and the reference's
torch exports, which keep their BatchNormalization nodes.
:func:`export_onnx_qdq` writes the int8 graph in QDQ form.

An independent consumer, ``tools/onnx_check.py``, parses and executes the
files with numpy alone.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from yolofastest_torch.models.graph import Executor, walk_topology, walk_topology_lite

PRODUCER = "yolofastest_torch"

# --------------------------------------------------------------- wire format
# Wire types: 0 = varint, 2 = length-delimited (the only two ONNX needs
# here; floats ride in length-delimited raw_data).


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field (submessage / string / bytes / packed)."""
    return _tag(field, 2) + _varint(len(payload)) + payload


def _s(field: int, text: str) -> bytes:
    return _ld(field, text.encode("utf-8"))


def _i(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _packed_ints(field: int, values) -> bytes:
    return _ld(field, b"".join(_varint(v) for v in values))


# ------------------------------------------------------------ ONNX messages
_FLOAT = 1  # TensorProto.DataType.FLOAT
_INT8 = 3  # TensorProto.DataType.INT8
_INT64 = 7  # TensorProto.DataType.INT64
_ATTR_INT, _ATTR_INTS = 2, 7  # AttributeProto.AttributeType


def _tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims(1) data_type(2) name(8) raw_data(9)."""
    a = np.ascontiguousarray(array, dtype=np.float32)
    return (_packed_ints(1, a.shape) + _i(2, _FLOAT) + _s(8, name)
            + _ld(9, a.tobytes()))  # raw_data is little-endian on all hosts we target


def _tensor_i8(name: str, array: np.ndarray) -> bytes:
    """Int8 TensorProto (quantised weights, zero points)."""
    a = np.ascontiguousarray(array, dtype=np.int8)
    return (_packed_ints(1, a.shape) + _i(2, _INT8) + _s(8, name)
            + _ld(9, a.tobytes()))


def _tensor_i64(name: str, array: np.ndarray) -> bytes:
    """Int64 TensorProto (shape/axes operands of shape-manipulation ops)."""
    a = np.ascontiguousarray(array, dtype=np.int64)
    return (_packed_ints(1, a.shape) + _i(2, _INT64) + _s(8, name)
            + _ld(9, a.tobytes()))


def _attr_int(name: str, value: int) -> bytes:
    return _s(1, name) + _i(3, value) + _i(20, _ATTR_INT)


def _attr_ints(name: str, values) -> bytes:
    return _s(1, name) + _packed_ints(8, values) + _i(20, _ATTR_INTS)


def _node(op_type: str, inputs: List[str], outputs: List[str], name: str,
          attrs: List[bytes] = ()) -> bytes:
    """NodeProto: input(1) output(2) name(3) op_type(4) attribute(5)."""
    buf = b"".join(_s(1, i) for i in inputs)
    buf += b"".join(_s(2, o) for o in outputs)
    buf += _s(3, name) + _s(4, op_type)
    buf += b"".join(_ld(5, a) for a in attrs)
    return buf


def _value_info(name: str, shape: Tuple, elem_type: int = _FLOAT) -> bytes:
    """ValueInfoProto with a tensor type; str dims become dim_param."""
    dims = b""
    for d in shape:
        dims += _ld(1, _s(2, d) if isinstance(d, str) else _i(1, int(d)))
    tensor_type = _i(1, elem_type) + _ld(2, dims)  # elem_type, shape
    return _s(1, name) + _ld(2, _ld(1, tensor_type))  # name, type.tensor_type


# ----------------------------------------------------------------- executor
class _OnnxExecutor(Executor):
    """Topology-walk executor whose tensors are ONNX value names: every op
    appends a ``NodeProto`` + weight initializers (NCHW / OIHW layouts,
    converted from the folded graph's HWIO as :mod:`.torchscript` converts
    them)."""

    def __init__(self, folded: Dict[str, Dict[str, Any]]):
        self.p = folded
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._n = 0

    def _uniq(self, stem: str) -> str:
        self._n += 1
        return f"{stem}_{self._n}"

    def _weights(self, name: str, depthwise: bool, deconv: bool = False):
        k = np.asarray(self.p[name]["kernel"], np.float32)
        # HWIO (kh,kw,I,O) -> OIHW; depthwise (kh,kw,1,C) -> (C,1,kh,kw);
        # deconv (2,2,Cin,Cout) -> ONNX ConvTranspose's (Cin,Cout,kh,kw)
        k = k.transpose((2, 3, 0, 1) if deconv else (3, 2, 0, 1))
        wn, bn = f"{name}.weight", f"{name}.bias"
        self.initializers.append(_tensor(wn, k))
        self.initializers.append(_tensor(bn, np.asarray(self.p[name]["bias"], np.float32)))
        return wn, bn

    def _conv(self, x, name, kernel, stride, groups, pad, wn, bn,
              op="Conv") -> str:
        out = self._uniq(name)
        attrs = [
            _attr_ints("dilations", (1, 1)),
            _attr_int("group", groups),
            _attr_ints("kernel_shape", (kernel, kernel)),
            _attr_ints("pads", (pad, pad, pad, pad)),
            _attr_ints("strides", (stride, stride)),
        ]
        self.nodes.append(_node(op, [x, wn, bn], [out], name, attrs))
        return out

    def _relu(self, x: str) -> str:
        out = self._uniq("relu")
        self.nodes.append(_node("Relu", [x], [out], out))
        return out

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        groups = int(self.p[name]["kernel"].shape[-1]) if depthwise else 1
        wn, bn = self._weights(name, depthwise)
        y = self._conv(x, name, kernel, stride, groups, (kernel - 1) // 2, wn, bn)
        return self._relu(y) if act else y

    def deconv2x(self, x, name):
        wn, bn = self._weights(name, depthwise=False, deconv=True)
        y = self._conv(x, name, 2, 2, 1, 0, wn, bn, op="ConvTranspose")
        return self._relu(y)

    def head(self, x, name):
        wn, bn = self._weights(name, depthwise=False)
        return self._conv(x, name, 1, 1, 1, 0, wn, bn)

    def add(self, x, y):
        out = self._uniq("add")
        self.nodes.append(_node("Add", [x, y], [out], out))
        return out

    def concat(self, x, y):
        out = self._uniq("concat")
        self.nodes.append(_node("Concat", [x, y], [out], out,
                                [_attr_int("axis", 1)]))
        return out


# ------------------------------------------------------------------- export
OPSET = 13
_IR_VERSION = 7  # minimum IR for opset 13


def export_onnx(folded: Dict[str, Dict[str, Any]], input_hw, path: str,
                arch: str = "yolofastest") -> str:
    """Serialise the folded graph (``fold_batchnorm`` output) as ``.onnx``.

    ``input_hw`` is the net input ``(H, W)``.  The batch dimension is
    symbolic, so one artifact serves any batch size (unlike the traced
    TorchScript artifact, which is shape-specialised).
    Returns ``path``.
    """
    ex = _OnnxExecutor(folded)
    num_out = int(folded["head_5"]["kernel"].shape[-1])
    return _serialize(ex, arch, input_hw, num_out, path)


def _serialize(ex: _OnnxExecutor, arch: str, input_hw, num_out: int,
               path: str) -> str:
    """Walk the topology with ``ex`` and write the ModelProto."""
    walk = {"yolofastest": walk_topology, "yolofastest-lite": walk_topology_lite}[arch]
    result = walk("input", ex)

    if arch == "yolofastest":
        head_large, head_small = result
        outs = [("head_large", head_large, 16), ("head_small", head_small, 32)]
    else:
        outs = [("head_small", result, 32)]
    # Rename raw head outputs to their public names (the reference's ncnn
    # deploy notes require exactly these names — SURVEY.md §2.2)
    for public, internal, _ in outs:
        ex.nodes.append(_node("Identity", [internal], [public], f"out_{public}"))

    h, w = input_hw
    graph = b"".join(_ld(1, n) for n in ex.nodes)
    graph += _s(2, f"{arch}_{h}x{w}")
    graph += b"".join(_ld(5, t) for t in ex.initializers)
    graph += _ld(11, _value_info("input", ("N", 1, h, w)))
    for public, _, stride in outs:
        graph += _ld(12, _value_info(public, ("N", num_out, h // stride, w // stride)))

    model = (_i(1, _IR_VERSION) + _s(2, PRODUCER) + _s(3, "0.3")
             + _ld(7, graph) + _ld(8, _i(2, OPSET)))  # opset_import{version}

    with open(path, "wb") as f:
        f.write(model)
    return path


# --------------------------------------------------------------- QDQ (int8)
class _QdqOnnxExecutor(_OnnxExecutor):
    """QDQ-form int8 graph: every conv/deconv/head input passes through
    QuantizeLinear -> DequantizeLinear at its calibrated per-tensor scale,
    and the weights ship as int8 initializers dequantised per output
    channel: the quantisation :class:`~yolofastest_torch.quant.ptq.
    Int8Executor` applies (symmetric, zero point 0, round half to even), so a
    QDQ-aware runtime can fuse the patterns into int8 kernels while a plain
    one runs the equivalent fake-quant float graph.

    Known spec divergence, as in JAX's writer: ONNX saturates int8 to
    [-128, 127] where the executors clip to [-127, 127], so a fully
    saturated negative activation can differ by one step.
    """

    def __init__(self, qparams: Dict[str, Dict[str, Any]], act_scales: Dict[str, float]):
        super().__init__(qparams)
        self.act_scales = act_scales

    def _qdq_in(self, x: str, name: str) -> str:
        sn, zn = f"{name}.x_scale", f"{name}.x_zp"
        self.initializers.append(_tensor(sn, np.float32(float(self.act_scales[name]))))
        # an explicit int8 zero point: it selects the quantised type
        self.initializers.append(_tensor_i8(zn, np.int8(0)))
        q, dq = f"{name}.x_q", f"{name}.x_dq"
        self.nodes.append(_node("QuantizeLinear", [x, sn, zn], [q], q))
        self.nodes.append(_node("DequantizeLinear", [q, sn, zn], [dq], dq))
        return dq

    def _weights(self, name: str, depthwise: bool, deconv: bool = False):
        # the fp writer's layout moves; the deconv's output channel is axis 1
        # of (Cin, Cout, kh, kw), every other kernel's axis 0
        kq = np.asarray(self.p[name]["kernel_q"], np.int8).transpose(
            (2, 3, 0, 1) if deconv else (3, 2, 0, 1))
        qn, sn, wn, bn = (f"{name}.weight_q", f"{name}.w_scale", f"{name}.weight",
                          f"{name}.bias")
        self.initializers.append(_tensor_i8(qn, kq))
        self.initializers.append(_tensor(sn, np.asarray(self.p[name]["w_scale"], np.float32)))
        # no zero point: 0 of the input's (int8) type
        self.nodes.append(_node("DequantizeLinear", [qn, sn], [wn], wn,
                                [_attr_int("axis", 1 if deconv else 0)]))
        self.initializers.append(_tensor(bn, np.asarray(self.p[name]["bias"], np.float32)))
        return wn, bn

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        groups = int(self.p[name]["kernel_q"].shape[-1]) if depthwise else 1
        wn, bn = self._weights(name, depthwise)
        y = self._conv(self._qdq_in(x, name), name, kernel, stride, groups,
                       (kernel - 1) // 2, wn, bn)
        return self._relu(y) if act else y

    def deconv2x(self, x, name):
        wn, bn = self._weights(name, depthwise=False, deconv=True)
        y = self._conv(self._qdq_in(x, name), name, 2, 2, 1, 0, wn, bn, op="ConvTranspose")
        return self._relu(y)

    def head(self, x, name):
        wn, bn = self._weights(name, depthwise=False)
        return self._conv(self._qdq_in(x, name), name, 1, 1, 1, 0, wn, bn)


def export_onnx_qdq(qparams: Dict[str, Dict[str, Any]], act_scales: Dict[str, float],
                    input_hw, path: str, arch: str = "yolofastest") -> str:
    """Serialise the int8-quantised graph as QDQ-form ONNX: ``qparams`` from
    :func:`~yolofastest_torch.quant.ptq.quantize_weights`, ``act_scales``
    from :func:`~yolofastest_torch.quant.ptq.calibrate`.  The portable
    equivalent of ``model_int8.yfb``.  Returns ``path``."""
    ex = _QdqOnnxExecutor(qparams, act_scales)
    num_out = int(qparams["head_5"]["kernel_q"].shape[-1])
    return _serialize(ex, arch, input_hw, num_out, path)


# ------------------------------------------------------------------- import
# Reader for the same wire format the exporter above writes.  It exists so
# the *reference's own shipped* ONNX artifacts
# (``models/onnx/{256x320,512x640}/YOLO-Fastest_epoch_*.onnx``, produced by
# ``convert_model/pytorch_to_onnx.py:17-23``) can be lifted back into the
# framework: torch's exporter preserves BatchNormalization nodes, so the
# import reconstructs the full *unfolded* flax variables tree — bitwise
# identical to converting the matching ``.pth`` — and the result is
# trainable, not just deployable.  Our own BN-folded exports round-trip too
# (batch norms identity-lifted, like ``import_ncnn``).


def _r_uvarint(buf: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _r_fields(buf: bytes):
    """Yield ``(field, wire, value)`` triples of one serialized message."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _r_uvarint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _r_uvarint(buf, i)
        elif wire == 2:
            ln, i = _r_uvarint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = buf[i:i + 4]
            i += 4
        elif wire == 1:
            v = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, v


def _r_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, float32 array).  Handles the layouts torch and
    our own writer emit: raw_data or packed/repeated float_data."""
    name, dims, dtype, raw, floats = "", [], 1, b"", []
    for f, wire, v in _r_fields(buf):
        if f == 1:
            if wire == 0:
                dims.append(v)
            else:  # packed varints
                j = 0
                while j < len(v):
                    d, j = _r_uvarint(v, j)
                    dims.append(d)
        elif f == 2:
            dtype = v
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
        elif f == 4:
            # float_data: one fixed32 (wire 5) and packed (wire 2) both
            # arrive as little-endian f32 byte strings here
            floats.append(np.frombuffer(v, "<f4"))
    if dtype == _INT64:  # shape/axes operands of a detect-pipeline tail
        return name, np.frombuffer(raw, "<i8").reshape(dims)
    if dtype != 1:  # onnx TensorProto.FLOAT
        raise ValueError(f"initializer {name!r}: dtype {dtype} unsupported "
                         "(fp32 graphs only — QDQ/int8 artifacts are not "
                         "importable)")
    if raw:
        arr = np.frombuffer(raw, "<f4")
    else:
        arr = np.concatenate(floats) if floats else np.zeros(0, np.float32)
    return name, arr.reshape(dims).astype(np.float32)


def _parse_onnx(path: str):
    """-> (nodes, initializers): node = (op_type, inputs, outputs).

    Truncated/corrupt input surfaces as ``ValueError`` with the path — a
    hostile byte stream can otherwise reach the wire-format walker as
    out-of-range reads (IndexError), a node with no op_type field
    (StopIteration) or an initializer whose payload disagrees with its dims
    (numpy ValueError)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        model = list(_r_fields(data))
        graph = next((v for f_, _, v in model if f_ == 7), None)
        if graph is None:
            raise ValueError("no GraphProto — not an ONNX ModelProto?")
        nodes, init = [], {}
        for f, _, v in _r_fields(graph):
            if f == 1:  # NodeProto
                nf = list(_r_fields(v))
                op = next(x.decode() for fn, _, x in nf if fn == 4)
                ins = [x.decode() for fn, _, x in nf if fn == 1]
                outs = [x.decode() for fn, _, x in nf if fn == 2]
                nodes.append((op, ins, outs))
            elif f == 5:  # initializer
                name, arr = _r_tensor(v)
                init[name] = arr
        return nodes, init
    except (AttributeError, IndexError, StopIteration, TypeError,
            UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"{path}: malformed ONNX ({e})") from e


def import_onnx(path: str, arch: str = None):
    """Load a YOLO-Fastest ``.onnx`` back into flax variables.

    Returns ``(variables, arch, bn_preserved)``:

    * the reference's shipped exports keep Conv→BatchNormalization pairs, so
      ``variables`` is the full unfolded ``{'params', 'batch_stats'}`` tree —
      bitwise equal to ``load_torch_checkpoint`` on the matching ``.pth``
      (``bn_preserved=True``);
    * our own :func:`export_onnx` artifacts are BN-folded, so batch norms
      are identity-lifted (``bn_preserved=False``), exactly like
      :func:`~yolofastest_torch.export.ncnn.import_ncnn`.

    torch names initializers numerically, so weights are aligned to graph
    layers by *weighted-node order*, with every position verified against
    the expected op type and kernel size (the walk order equals torch's
    module order).
    """
    from yolofastest_torch.export.ncnn import _weight_schedule
    from yolofastest_torch.models.graph import unfold_to_variables
    from yolofastest_torch.models.torch_io import torch_state_dict_to_variables

    nodes, init = _parse_onnx(path)
    if any(op in ("QuantizeLinear", "DequantizeLinear") for op, _, _ in nodes):
        raise ValueError(f"{path}: QDQ (int8) graph — import the fp32 "
                         "artifact; quantisation is re-derived by calibrate()")
    weighted = [(op, ins, outs) for op, ins, outs in nodes
                if op in ("Conv", "ConvTranspose")]
    bn_by_input = {ins[0]: ins for op, ins, outs in nodes
                   if op == "BatchNormalization"}

    if arch is None:
        for cand in ("yolofastest", "yolofastest-lite"):
            if len(_weight_schedule(cand)) == len(weighted):
                arch = cand
                break
        else:
            raise ValueError(f"{path}: {len(weighted)} weighted nodes match "
                             "neither arch")
    sched = _weight_schedule(arch)
    if len(sched) != len(weighted):
        raise ValueError(f"{path}: {len(weighted)} weighted nodes, arch "
                         f"{arch!r} expects {len(sched)}")

    sd: Dict[str, np.ndarray] = {}
    folded: Dict[str, Dict[str, np.ndarray]] = {}
    n_bn = 0
    def _init(name: str, what: str) -> np.ndarray:
        try:
            return init[name]
        except KeyError:
            raise ValueError(f"{path}: {what} {name!r} is not an "
                             "initializer (external/computed weights "
                             "unsupported)") from None

    for (op, ins, outs), (gname, kind, ksize) in zip(weighted, sched):
        expect_op = "ConvTranspose" if kind == "deconv" else "Conv"
        if len(ins) < (3 if kind == "head" else 2) or not outs:
            raise ValueError(f"{path}: node for graph layer {gname!r} has "
                             f"{len(ins)} inputs — not a YOLO-Fastest "
                             "ONNX graph?")
        w = _init(ins[1], "weight")
        if op != expect_op or w.ndim != 4 or w.shape[2] != ksize \
                or (kind == "dw" and w.shape[1] != 1):
            raise ValueError(
                f"{path}: node for graph layer {gname!r} is {op} "
                f"{tuple(w.shape)}, expected {expect_op} k={ksize} — not a "
                "YOLO-Fastest ONNX graph?")
        pref = gname.replace("/", ".")
        bn = bn_by_input.get(outs[0])
        if kind == "head":
            if bn is not None:
                raise ValueError(f"{path}: head {gname!r} followed by BN")
            sd[f"{pref}.weight"] = w
            sd[f"{pref}.bias"] = _init(ins[2], "bias")
            folded[gname] = {
                "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                "bias": sd[f"{pref}.bias"]}
            continue
        if bn is not None:
            # unfolded: Conv (no bias) + BatchNormalization(scale, B, mean, var)
            n_bn += 1
            sd[f"{pref}.0.weight"] = w
            if len(bn) < 5:
                raise ValueError(f"{path}: BN after {gname!r} has "
                                 f"{len(bn)} inputs, expected 5")
            sd[f"{pref}.1.weight"] = _init(bn[1], "bn scale")
            sd[f"{pref}.1.bias"] = _init(bn[2], "bn bias")
            sd[f"{pref}.1.running_mean"] = _init(bn[3], "bn mean")
            sd[f"{pref}.1.running_var"] = _init(bn[4], "bn var")
        else:
            # folded: conv carries the bias; kernel back to HWIO
            if len(ins) < 3:
                raise ValueError(f"{path}: {gname!r} has neither BN nor "
                                 "bias — mixed/unknown graph form")
            tr = (2, 3, 0, 1) if kind == "deconv" else (2, 3, 1, 0)
            folded[gname] = {
                "kernel": np.ascontiguousarray(w.transpose(tr)),
                "bias": _init(ins[2], "bias")}
    n_weighted_bn = sum(1 for _, kind, _ in sched if kind != "head")
    if n_bn == n_weighted_bn:
        return torch_state_dict_to_variables(sd), arch, True
    if n_bn == 0:
        return unfold_to_variables(folded), arch, False
    raise ValueError(f"{path}: {n_bn}/{n_weighted_bn} convs carry BN — "
                     "mixed folded/unfolded graph unsupported")


# --------------------------------------------------- detect pipeline (ONNX)
class _DetectTail:
    """Appends the decode + NMS tail onto an :class:`_OnnxExecutor` graph:
    normalization, per-head YOLO decode (the exact
    :func:`~yolofastest_torch.losses.yolo_loss.decode_for_eval` math as
    Sigmoid/Exp/Mul/Add over reshaped NCHW heads) and class-aware
    ``NonMaxSuppression``."""

    def __init__(self, ex: _OnnxExecutor):
        self.ex = ex

    def n(self, op: str, ins, attrs=(), stem: str = None) -> str:
        out = self.ex._uniq(stem or op.lower())
        self.ex.nodes.append(_node(op, list(ins), [out], out, list(attrs)))
        return out

    def const(self, arr: np.ndarray, name: str) -> str:
        a = np.asarray(arr)
        name = self.ex._uniq(name)
        t = _tensor_i64(name, a) if a.dtype.kind == "i" else _tensor(
            name, a.astype(np.float32))
        self.ex.initializers.append(t)
        return name

    def slice2(self, x, lo, hi, stem):
        return self.n("Slice", [x,
                                self.const(np.array([lo], np.int64), "st"),
                                self.const(np.array([hi], np.int64), "en"),
                                self.const(np.array([2], np.int64), "ax")],
                      stem=stem)

    def decode_head(self, head: str, hw, stride: int, anchors,
                    num_anchors: int, num_cls: int):
        """-> (boxes (N, A*h*w, 4) center-form pixels, scores (N, C, A*h*w)
        single-label: conf at the argmax class, 0 elsewhere)."""
        h, w = hw[0] // stride, hw[1] // stride
        na, nf = num_anchors, 5 + num_cls
        t = self.n("Reshape", [head, self.const(
            np.array([0, na, nf, h, w], np.int64), "shape")], stem="thead")
        tx, ty = self.slice2(t, 0, 1, "tx"), self.slice2(t, 1, 2, "ty")
        tw, th = self.slice2(t, 2, 3, "tw"), self.slice2(t, 3, 4, "th")
        tconf, tcls = self.slice2(t, 4, 5, "tconf"), self.slice2(t, 5, nf, "tcls")

        grid_x = np.broadcast_to(np.arange(w, dtype=np.float32),
                                 (1, 1, 1, h, w))
        grid_y = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None],
                                 (1, 1, 1, h, w))
        stride_w = hw[1] / w
        stride_h = hw[0] / h
        anc = np.asarray(anchors, np.float32)  # (A, 2) in input pixels
        xc = self.n("Mul", [self.n("Add", [self.n("Sigmoid", [tx]),
                                           self.const(grid_x, "gx")]),
                            self.const(np.float32(stride_w), "sw")], stem="xc")
        yc = self.n("Mul", [self.n("Add", [self.n("Sigmoid", [ty]),
                                           self.const(grid_y, "gy")]),
                            self.const(np.float32(stride_h), "sh")], stem="yc")
        bw = self.n("Mul", [self.n("Exp", [tw]),
                            self.const(anc[:, 0].reshape(1, na, 1, 1, 1),
                                       "aw")], stem="bw")
        bh = self.n("Mul", [self.n("Exp", [th]),
                            self.const(anc[:, 1].reshape(1, na, 1, 1, 1),
                                       "ah")], stem="bh")
        box = self.n("Concat", [xc, yc, bw, bh], [_attr_int("axis", 2)],
                     stem="box")                       # (N, A, 4, h, w)
        box = self.n("Transpose", [box],
                     [_attr_ints("perm", (0, 1, 3, 4, 2))], stem="boxt")
        box = self.n("Reshape", [box, self.const(
            np.array([0, na * h * w, 4], np.int64), "bshape")], stem="boxes")

        conf = self.n("Sigmoid", [tconf], stem="conf")   # (N, A, 1, h, w)
        cls = self.n("Sigmoid", [tcls], stem="cls")      # (N, A, C, h, w)
        # single-label semantics (batched_nms classifies by argmax): only
        # the max class keeps the objectness score
        mx = self.n("ReduceMax", [cls], [_attr_ints("axes", (2,)),
                                         _attr_int("keepdims", 1)], stem="mx")
        mask = self.n("Cast", [self.n("Equal", [cls, mx])],
                      [_attr_int("to", _FLOAT)], stem="mask")
        sc = self.n("Mul", [conf, mask], stem="sc")      # (N, A, C, h, w)
        sc = self.n("Transpose", [sc],
                    [_attr_ints("perm", (0, 2, 1, 3, 4))], stem="sct")
        sc = self.n("Reshape", [sc, self.const(
            np.array([0, num_cls, na * h * w], np.int64), "sshape")],
            stem="scores")
        return box, sc


def export_onnx_detect(folded: Dict[str, Dict[str, Any]], config,
                       path: str, arch: str = "yolofastest") -> str:
    """Serialise the FULL detect pipeline as ``detect.onnx``: raw grayscale
    frames in, class-aware NMS out (the reference's exported ONNX, like our
    ``model.onnx``, stops at the head logits and leaves decode/NMS to
    hand-written consumer code, ``YOLO_ncnn.cpp:83-167``).

    Graph I/O:

    * input ``image`` — ``(N, 1, H, W)`` float32, RAW 0..255 grayscale
      (the reference's ``(pixel - 128) / 255`` normalisation is the first
      two nodes);
    * output ``boxes`` — ``(N, B, 4)`` center-form ``(xc, yc, w, h)`` in
      input pixels (every candidate, :func:`decode_for_eval` math);
    * output ``scores`` — ``(N, num_cls, B)`` single-label scores
      (objectness at the argmax class, 0 elsewhere — matching
      ``batched_nms``'s argmax classification);
    * output ``selected`` — ``(S, 3)`` int64 ``[batch, class, box]`` rows
      from ``NonMaxSuppression`` (``center_point_box=1``,
      ``score_threshold=conf_thre``, ``iou_threshold=nms_thre``,
      ``max_output_boxes_per_class=max_det``).

    Documented divergences from the on-device pipeline: standard IOU (the
    ONNX op has no +1px convention), the detection cap applies per class
    rather than globally, boxes stay float (no integer rounding), and a
    bitwise TIE in class sigmoid scores (e.g. two classes saturated at
    fp32 1.0) keeps the candidate under BOTH classes where the device
    argmax picks one — so parity with the golden detections holds at
    detection level, not bitwise.
    """
    io = config.io
    ex = _OnnxExecutor(folded)
    b = _DetectTail(ex)
    x = b.n("Mul", [b.n("Sub", ["image", b.const(np.float32(128.0), "m")]),
                    b.const(np.float32(1.0 / 255.0), "s")], stem="norm")
    walk = {"yolofastest": walk_topology,
            "yolofastest-lite": walk_topology_lite}[arch]
    result = walk(x, ex)
    heads = list(result) if arch == "yolofastest" else [result]

    boxes_l, scores_l = [], []
    for head, stride, anchors in zip(heads, io.strides, io.anchors):
        bx, sc = b.decode_head(head, io.input_hw, stride, anchors,
                               io.num_anchors, io.num_cls)
        boxes_l.append(bx)
        scores_l.append(sc)
    if len(heads) > 1:
        boxes = b.n("Concat", boxes_l, [_attr_int("axis", 1)], stem="allbox")
        scores = b.n("Concat", scores_l, [_attr_int("axis", 2)], stem="allsc")
    else:
        boxes, scores = boxes_l[0], scores_l[0]
    ex.nodes.append(_node("Identity", [boxes], ["boxes"], "out_boxes"))
    ex.nodes.append(_node("Identity", [scores], ["scores"], "out_scores"))
    ex.nodes.append(_node(
        "NonMaxSuppression",
        ["boxes", "scores",
         b.const(np.array(io.max_det, np.int64), "maxdet"),
         b.const(np.float32(io.nms_thre), "iou_t"),
         b.const(np.float32(io.conf_thre), "conf_t")],
        ["selected"], "nms", [_attr_int("center_point_box", 1)]))

    h, w = io.input_hw
    n_box = sum(io.num_anchors * (h // s) * (w // s) for s in io.strides)
    graph = b"".join(_ld(1, n) for n in ex.nodes)
    graph += _s(2, f"{arch}_detect_{h}x{w}")
    graph += b"".join(_ld(5, t) for t in ex.initializers)
    graph += _ld(11, _value_info("image", ("N", 1, h, w)))
    graph += _ld(12, _value_info("boxes", ("N", n_box, 4)))
    graph += _ld(12, _value_info("scores", ("N", io.num_cls, n_box)))
    graph += _ld(12, _value_info("selected", ("S", 3), _INT64))
    model = (_i(1, _IR_VERSION) + _s(2, PRODUCER) + _s(3, "0.3")
             + _ld(7, graph) + _ld(8, _i(2, OPSET)))
    with open(path, "wb") as f:
        f.write(model)
    return path
