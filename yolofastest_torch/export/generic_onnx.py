"""Generic torch -> ONNX exporter: write any traceable function as ``.onnx``.

The port of ``yolofastest_tpu/export/generic_onnx.py``, which walks a jaxpr.
Here the trace is ``torch.export`` (non-strict) lowered to core ATen with
``run_decompositions``; this module walks that graph and maps each operator
to ONNX nodes through the wire helpers of ``export/onnx.py`` (opset 13).  Any
module or function whose core-ATen trace stays inside the supported set
exports directly, with no per-architecture walk (the hand-written walks in
``export/onnx.py`` remain the deployment path of the shipped detectors).

The port's registered kernels (``torch.ops.yolofastest.*``) are inlined
through their plain versions, as the JAX walker inlines ``pjit`` and
``custom_jvp`` calls: a folded forward whose chains are the chain kernel on
the card becomes plain Conv / Relu / Add nodes.

Only operators that ``tools/onnx_check.py`` runs are emitted; the others are
decomposed into them: ``addmm`` into MatMul + Add, an eval ``batch_norm``
into a scale and shift computed at export time, ``select`` into Slice +
Reshape, ``mean`` into ReduceSum + Mul, ``clamp`` into Max / Min, ``log1p``
into Add + Log, ``constant_pad_nd`` into Concat with constant blocks, and a
transposed ``convolution`` into ConvTranspose (which the JAX walker
refuses).  The trace's bookkeeping (``_assert_tensor_metadata``, ``clone``,
``alias``, ``detach``) becomes nothing or Identity.  Parameters, buffers and
lifted constants become initializers, and a node whose inputs are all
constants (the weights' ``select`` / ``permute``) is computed at export time.

Fail loud, as JAX does: an unsupported operator raises ``NotImplementedError``
naming it, and so do graph inputs or outputs that are not float32 and
constants that float32 does not hold exactly.  Convolutions and pools are
NCHW in torch already, so no transposes are wrapped around them.
"""

from __future__ import annotations

import operator
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from yolofastest_torch.export.onnx import (OPSET, _IR_VERSION, _attr_int, _attr_ints, _i, _ld,
                                           _node, _s, _tensor, _tensor_i64, _value_info)
from yolofastest_torch.export.pt2 import trace
from yolofastest_torch.kernels import nms as _nms
from yolofastest_torch.kernels import res_block as _rb

PRODUCER = "yolofastest_torch-generic"
_ONNX_TYPES = {torch.float32: 1, torch.int32: 6, torch.int64: 7, torch.bool: 9}
# the port's kernels, inlined through their plain versions
_INLINE = {
    _rb.CHAIN_OPS[False]: lambda x, *w_hw: _rb.res_chain_cf_plain(x, *w_hw[:6], w_hw[6:]),
    _rb.CHAIN_OPS[True]: lambda x, *w_hw: _rb.res_chain_rows_plain(x, *w_hw[:6], w_hw[6:]),
    _nms.NMS_PACKED_OP: _nms.nms_packed_plain,
    _nms.NMS_KEEP_OP: _nms.nms_keep_plain,
}
# operators that carry no value of their own
_SKIP = {"_assert_tensor_metadata", "_assert_scalar", "sym_constrain_range_for_size"}
_PASS = {"clone", "alias", "detach", "lift_fresh_copy"}
_UNARY = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh", "exp": "Exp", "log": "Log",
          "sqrt": "Sqrt", "abs": "Abs", "neg": "Neg", "reciprocal": "Reciprocal"}
_BINARY = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div", "maximum": "Max",
           "minimum": "Min", "gt": "Greater", "lt": "Less", "ge": "GreaterOrEqual",
           "le": "LessOrEqual", "eq": "Equal"}


_UNKNOWN = object()  # an argument whose value is known only when the graph runs


class _Const:
    """A value known at export time, and its initializer once written."""

    def __init__(self, value: torch.Tensor):
        self.value = value
        self.name = None


def _f32_exact(arr: np.ndarray, what: str) -> np.ndarray:
    """``arr`` as float32, raising where float32 does not hold it exactly."""
    if arr.dtype == np.float32:
        return arr
    f32 = arr.astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        exact = arr.dtype != np.bool_ and np.array_equal(f32.astype(arr.dtype), arr)
    if not exact:
        raise NotImplementedError(f"{what} of dtype {arr.dtype} not exactly f32-representable; "
                                  "cast it explicitly before tracing")
    return f32


class _Graph:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.n = 0

    def name(self, hint: str) -> str:
        self.n += 1
        return f"{hint}_{self.n}"

    def emit(self, op: str, ins: List[str], attrs: Sequence[bytes] = ()) -> str:
        out = self.name(op.lower())
        self.nodes.append(_node(op, ins, [out], out + "_node", list(attrs)))
        return out

    def const(self, arr, hint: str = "const") -> str:
        name = self.name(hint)
        self.initializers.append(_tensor(name, np.asarray(arr, np.float32)))
        return name

    def const_i64(self, values, hint: str = "shape") -> str:
        name = self.name(hint)
        self.initializers.append(_tensor_i64(name, np.asarray(values, np.int64)))
        return name


def _shape(node) -> List[int]:
    return [int(d) for d in node.meta["val"].shape]


def _pair(v) -> List[int]:
    v = [int(x) for x in (v if isinstance(v, (list, tuple)) else [v])]
    return v * 2 if len(v) == 1 else v


class _Lowerer:
    """Walks a core-ATen graph; ``env`` maps an fx node to an ONNX value
    name, a :class:`_Const`, or a tuple of either (multi-output operators)."""

    def __init__(self, g: _Graph):
        self.g = g
        self.env: Dict[Any, Any] = {}

    # ------------------------------------------------------------ plumbing
    def value(self, arg, what: str = "literal") -> str:
        """An ONNX value name for a node, a constant or a Python scalar."""
        if isinstance(arg, torch.fx.Node):
            v = self.env[arg]
            if not isinstance(v, _Const):
                return v
            if v.name is None:
                arr = v.value.detach().cpu().numpy()
                v.name = self.g.const(_f32_exact(arr, "captured constant"), "w")
            return v.name
        arr = np.asarray(arg)
        if arr.dtype == np.bool_:
            raise NotImplementedError("bool literals unsupported")
        return self.g.const(_f32_exact(arr, what), "lit")

    def known(self, arg):
        """The export-time value of an argument, or :data:`_UNKNOWN`."""
        if isinstance(arg, torch.fx.Node):
            v = self.env[arg]
            return v.value if isinstance(v, _Const) else _UNKNOWN
        if isinstance(arg, (list, tuple)):
            vals = [self.known(a) for a in arg]
            return _UNKNOWN if any(v is _UNKNOWN for v in vals) else type(arg)(vals)
        return arg

    def run(self, graph: torch.fx.Graph) -> None:
        for node in graph.nodes:
            if node.op == "call_function":
                self.call(node)

    def call(self, node) -> None:
        target = node.target
        if target is operator.getitem:
            self.env[node] = self.env[node.args[0]][node.args[1]]
            if self.env[node] is None:
                raise NotImplementedError(f"output {node.args[1]} of "
                                          f"{node.args[0].target} has no ONNX lowering")
            return
        name = getattr(target, "_opname", None)
        if name in _SKIP:
            return
        if not isinstance(target, torch._ops.OpOverload):
            raise NotImplementedError(f"{target} has no ONNX lowering (export/generic_onnx.py)")
        args = [self.known(a) for a in node.args]
        kwargs = {k: self.known(v) for k, v in node.kwargs.items()}
        if not any(v is _UNKNOWN for v in (*args, *kwargs.values())):
            if torch.Tag.nondeterministic_seeded in target.tags:
                raise NotImplementedError(f"random operator {target} has no ONNX lowering")
            out = target(*args, **kwargs)  # every input known: computed at export time
            self.env[node] = (tuple(_Const(o) for o in out) if isinstance(out, (tuple, list))
                              else _Const(out))
            return
        if name in _PASS:
            self.env[node] = self.env[node.args[0]]
            return
        if name in _UNARY:
            self.env[node] = self.g.emit(_UNARY[name], [self.value(node.args[0])])
            return
        if name in _BINARY and not target._overloadname.endswith("_mode"):
            a, b = node.args[:2]
            if node.kwargs.get("alpha", 1) != 1:
                b_name = self.g.emit("Mul", [self.value(b), self.value(node.kwargs["alpha"])])
                self.env[node] = self.g.emit(_BINARY[name], [self.value(a), b_name])
                return
            self.env[node] = self.g.emit(_BINARY[name], [self.value(a), self.value(b)])
            return
        handler = getattr(self, f"op_{name}", None)
        if handler is None:
            raise NotImplementedError(f"torch operator {target} has no ONNX lowering "
                                      "(export/generic_onnx.py)")
        self.env[node] = handler(node, *node.args, **node.kwargs)

    # --------------------------------------------------------- elementwise
    def op_log1p(self, node, x):
        return self.g.emit("Log", [self.g.emit("Add", [self.value(x), self.value(1.0)])])

    def op_expm1(self, node, x):
        return self.g.emit("Sub", [self.g.emit("Exp", [self.value(x)]), self.value(1.0)])

    def op_rsqrt(self, node, x):
        return self.g.emit("Reciprocal", [self.g.emit("Sqrt", [self.value(x)])])

    def op_pow(self, node, x, y):
        if not isinstance(y, torch.fx.Node) and y == 2:
            a = self.value(x)
            return self.g.emit("Mul", [a, a])
        return self.g.emit("Pow", [self.value(x), self.value(y, "exponent")])

    def op_clamp(self, node, x, min=None, max=None):
        y = self.value(x)
        if min is not None:
            y = self.g.emit("Max", [y, self.value(min)])
        if max is not None:
            y = self.g.emit("Min", [y, self.value(max)])
        return y

    def op_where(self, node, cond, x, y):
        return self.g.emit("Where", [self.value(cond), self.value(x), self.value(y)])

    def op__to_copy(self, node, x, dtype=None, **_):
        if dtype is None or dtype == node.args[0].meta["val"].dtype:
            return self.g.emit("Identity", [self.value(x)])
        if dtype not in _ONNX_TYPES:
            raise NotImplementedError(f"cast to {dtype} unsupported")
        return self.g.emit("Cast", [self.value(x)], [_attr_int("to", _ONNX_TYPES[dtype])])

    # -------------------------------------------------------------- shapes
    def _reshape(self, node, x, *_):
        return self.g.emit("Reshape", [self.value(x), self.g.const_i64(_shape(node))])

    op_view = op__unsafe_view = op_reshape = op_squeeze = op_unsqueeze = _reshape

    def op_permute(self, node, x, dims):
        rank = len(dims)
        return self.g.emit("Transpose", [self.value(x)],
                           [_attr_ints("perm", [int(d) % rank for d in dims])])

    def op_expand(self, node, x, *_):
        return self.g.emit("Expand", [self.value(x), self.g.const_i64(_shape(node))])

    def op_cat(self, node, tensors, dim=0):
        rank = len(_shape(node))
        return self.g.emit("Concat", [self.value(t) for t in tensors],
                           [_attr_int("axis", int(dim) % rank)])

    def _slice(self, y: str, dim: int, start: int, end: int) -> str:
        return self.g.emit("Slice", [y, self.g.const_i64([start]), self.g.const_i64([end]),
                                     self.g.const_i64([dim]), self.g.const_i64([1])])

    def op_slice(self, node, x, dim=0, start=None, end=None, step=1):
        if step != 1:
            raise NotImplementedError("slice with a step other than 1 (onnx_check's Slice "
                                      "takes none)")
        size = _shape(node.args[0])
        dim = int(dim) % len(size)
        start = 0 if start is None else min(max(start + size[dim] if start < 0 else start, 0),
                                            size[dim])
        end = size[dim] if end is None else min(max(end + size[dim] if end < 0 else end, 0),
                                                size[dim])
        return self._slice(self.value(x), dim, start, end)

    def op_select(self, node, x, dim, index):
        size = _shape(node.args[0])
        dim = int(dim) % len(size)
        index = int(index) % size[dim]
        picked = self._slice(self.value(x), dim, index, index + 1)
        return self.g.emit("Reshape", [picked, self.g.const_i64(_shape(node))])

    def op_constant_pad_nd(self, node, x, pad, value=0.0):
        """Blocks of ``value`` concatenated on each side of each padded axis."""
        if any(int(p) < 0 for p in pad):
            raise NotImplementedError("constant_pad_nd with negative pads (a crop)")
        y, shape = self.value(x), _shape(node.args[0])
        for k in range(len(pad) // 2):
            dim = len(shape) - 1 - k
            parts = []
            for width in (int(pad[2 * k]), None, int(pad[2 * k + 1])):
                if width is None:
                    parts.append(y)
                elif width:
                    block = list(shape)
                    block[dim] = width
                    parts.append(self.g.const(np.full(block, value, np.float32), "pad"))
            if len(parts) > 1:
                y = self.g.emit("Concat", parts, [_attr_int("axis", dim)])
            shape[dim] += int(pad[2 * k]) + int(pad[2 * k + 1])
        return y

    # ---------------------------------------------------------- reductions
    def _axes(self, node, dims):
        rank = len(_shape(node.args[0]))
        return list(range(rank)) if not dims else [int(d) % rank for d in dims]

    def op_sum(self, node, x, dims=None, keepdim=False, **_):
        return self.g.emit("ReduceSum", [self.value(x), self.g.const_i64(self._axes(node, dims),
                                                                         "axes")],
                           [_attr_int("keepdims", int(keepdim))])

    def op_mean(self, node, x, dims=None, keepdim=False, **_):
        axes = self._axes(node, dims)
        size = _shape(node.args[0])
        total = self.op_sum(node, x, axes, keepdim)
        n = int(np.prod([size[a] for a in axes]))
        return self.g.emit("Mul", [total, self.g.const(np.float32(1.0 / n), "inv_n")])

    def _reduce(self, op, node, x, dims=(), keepdim=False):
        return self.g.emit(op, [self.value(x)], [_attr_ints("axes", self._axes(node, dims)),
                                                 _attr_int("keepdims", int(keepdim))])

    def op_amax(self, node, x, dims=(), keepdim=False):
        return self._reduce("ReduceMax", node, x, dims, keepdim)

    def op_amin(self, node, x, dims=(), keepdim=False):
        return self._reduce("ReduceMin", node, x, dims, keepdim)

    # ------------------------------------------- convolution, matmul, pools
    def op_convolution(self, node, x, w, bias, stride, padding, dilation, transposed,
                       output_padding, groups):
        if len(stride) != 2:
            raise NotImplementedError("only 2D convolutions supported")
        ins = [self.value(x), self.value(w)]
        if transposed:
            if (any(int(p) for p in padding) or any(int(p) for p in output_padding)
                    or any(int(d) != 1 for d in dilation) or groups != 1):
                raise NotImplementedError("ConvTranspose with padding, output padding, "
                                          "dilation or groups unsupported")
            cout = _shape(node)[1]
            ins.append(self.value(bias) if bias is not None
                       else self.g.const(np.zeros(cout, np.float32), "bias"))
            return self.g.emit("ConvTranspose", ins,
                               [_attr_ints("strides", [int(s) for s in stride])])
        if bias is not None:
            ins.append(self.value(bias))
        pads = [int(p) for p in padding]
        return self.g.emit("Conv", ins, [
            _attr_ints("strides", [int(s) for s in stride]),
            _attr_ints("pads", pads + pads),
            _attr_ints("dilations", [int(d) for d in dilation]),
            _attr_int("group", int(groups))])

    def op_mm(self, node, a, b):
        return self.g.emit("MatMul", [self.value(a), self.value(b)])

    op_bmm = op_mm

    def op_addmm(self, node, bias, a, b, beta=1, alpha=1):
        if beta != 1 or alpha != 1:
            raise NotImplementedError("addmm with beta or alpha other than 1")
        return self.g.emit("Add", [self.op_mm(node, a, b), self.value(bias)])

    def _pool(self, op, x, kernel, stride, padding):
        kernel = _pair(kernel)
        stride = _pair(stride) if stride else kernel
        pads = _pair(padding)
        return self.g.emit(op, [self.value(x)], [
            _attr_ints("kernel_shape", kernel), _attr_ints("strides", stride),
            _attr_ints("pads", pads + pads)] + (
            [_attr_int("count_include_pad", 1)] if op == "AveragePool" else []))

    def op_max_pool2d_with_indices(self, node, x, kernel, stride=(), padding=(0, 0),
                                   dilation=(1, 1), ceil_mode=False):
        if any(d != 1 for d in _pair(dilation)) or ceil_mode:
            raise NotImplementedError("dilated or ceil-mode pooling unsupported")
        return (self._pool("MaxPool", x, kernel, stride, padding), None)

    def op_avg_pool2d(self, node, x, kernel, stride=(), padding=(0, 0), ceil_mode=False,
                      count_include_pad=True, divisor_override=None):
        if ceil_mode or divisor_override is not None or (
                not count_include_pad and any(_pair(padding))):
            raise NotImplementedError("avg_pool2d other than count_include_pad unsupported")
        return self._pool("AveragePool", x, kernel, stride, padding)

    def op__native_batch_norm_legit_no_training(self, node, x, weight, bias, mean, var,
                                                momentum, eps):
        """Eval batch norm: ``x * scale + shift`` with both computed here."""
        known = [self.known(t) for t in (weight, bias, mean, var)]
        if any(t is None for t in known):
            raise NotImplementedError("batch_norm whose statistics are not constants")
        w, b, m, v = (t.detach().cpu().double().numpy() for t in known)
        scale = w / np.sqrt(v + eps)
        shape = [1, -1] + [1] * (len(_shape(node.args[0])) - 2)
        y = self.g.emit("Mul", [self.value(x), self.g.const(scale.reshape(shape), "bn_scale")])
        y = self.g.emit("Add", [y, self.g.const((b - m * scale).reshape(shape), "bn_shift")])
        return (y, None, None)


def _decompositions():
    table = torch.export.default_decompositions()
    table.update(_INLINE)
    return table


def export_torch_onnx(fn, example_args, path: str, input_names: Sequence[str] = None,
                      output_names: Sequence[str] = None) -> str:
    """Trace ``fn(*example_args)`` (a function or an ``nn.Module``) and write
    it as a self-contained ``.onnx``: parameters, buffers and captured
    tensors become initializers, the example arguments the graph inputs, the
    batch dimension kept static.  Returns ``path``."""
    exported = trace(fn, tuple(torch.as_tensor(a) for a in example_args))
    exported = exported.run_decompositions(_decompositions())
    graph, sig = exported.graph, exported.graph_signature

    g = _Graph()
    lw = _Lowerer(g)
    placeholders = {n.name: n for n in graph.nodes if n.op == "placeholder"}
    user = [placeholders[name] for name in sig.user_inputs]
    in_names = list(input_names or [f"input_{i}" for i in range(len(user))])
    if len(in_names) != len(user):
        raise ValueError("example_args flatten to a different arity than the traced "
                         "function's inputs")
    for name, node in zip(in_names, user):
        dtype = node.meta["val"].dtype
        if dtype != torch.float32:
            raise NotImplementedError(f"graph input {name!r} has dtype {dtype}; only float32 "
                                      "inputs are supported (cast before tracing)")
        lw.env[node] = name
    state = {**exported.state_dict, **exported.constants}
    for spec in sig.input_specs:
        if spec.target is not None and spec.arg.name in placeholders:
            lw.env[placeholders[spec.arg.name]] = _Const(state[spec.target])
    outputs = [n for n in graph.output_node().args[0]]
    for i, node in enumerate(outputs):
        dtype = node.meta["val"].dtype
        if dtype != torch.float32:
            raise NotImplementedError(f"graph output {i} has dtype {dtype}; only float32 "
                                      "outputs are supported (cast inside the function)")

    lw.run(graph)
    out_names = list(output_names or [f"output_{i}" for i in range(len(outputs))])
    for node, public in zip(outputs, out_names):
        g.nodes.append(_node("Identity", [lw.value(node)], [public], f"out_{public}"))

    body = b"".join(_ld(1, n) for n in g.nodes)
    body += _s(2, "torch_generic")
    body += b"".join(_ld(5, t) for t in g.initializers)
    for name, node in zip(in_names, user):
        body += _ld(11, _value_info(name, tuple(_shape(node))))
    for name, node in zip(out_names, outputs):
        body += _ld(12, _value_info(name, tuple(_shape(node))))
    model = (_i(1, _IR_VERSION) + _s(2, PRODUCER) + _s(3, "0.1")
             + _ld(7, body) + _ld(8, _i(2, OPSET)))
    with open(path, "wb") as f:
        f.write(model)
    return path

