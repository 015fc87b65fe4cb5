"""StableHLO text of a port program, for the native consumer ``yf_shlo``.

The port of ``save_exported_mlir`` (``yolofastest_tpu/export/stablehlo.py``).
JAX prints the module that XLA would compile; a ``torch.export`` program has
no StableHLO of its own, so this module lowers one.  The walk is the one of
``export/generic_onnx.py``: :func:`yolofastest_torch.export.pt2.trace`'s
graph, ``run_decompositions`` to core ATen with the chain operators
(``yolofastest::res_chain_cf`` / ``res_chain_rows``) inlined through their
plain versions, then one lowering per operator.  An operator with no
lowering raises ``NotImplementedError`` naming it.

What is emitted is the dialect subset that ``cpp/runner/shlo_runner.cpp``
parses, in JAX's printed form:

* element types f32, i32, i1 and ui8 only: int64 values (sort and gather
  indices, counts) are emitted as i32, and a constant outside +-2^24 (what
  ``yf_shlo``'s float storage holds exactly) raises;
* convolutions in NHWC/HWIO only.  The port's graph permutes to NCHW around
  every convolution; here a ``permute`` is recorded, not emitted (a value
  carries its permutation), a convolution reads its NHWC input as it lies
  and gives NHWC, the OIHW weights are turned into HWIO constants here, and
  a pair of permutes that cancel emits nothing.  Elementwise operators run
  in their operands' layout; a ``stablehlo.transpose`` is emitted only where
  an operator needs the logical layout (a reshape, a slice, an output);
* the stride-2 transposed convolution (the deconv) as JAX computes it, a
  ``dot_general`` over channels, a reshape and a transpose, since
  ``yf_shlo`` takes no dilated convolution;
* ``torch.sort`` (decode's stable top-k) as a stable ``stablehlo.sort`` with
  a comparator region: ``yf_shlo`` sorts with ``std::stable_sort``, so ties
  (the gated -1.0 rows that reach the output) keep their input order, as in
  the port;
* ``yolofastest::nms_packed`` as a fragment in JAX's form
  (``yolofastest_tpu/ops/nms.py``): the IOU matrix of ``ops/boxes.py`` with
  the same float32 operations, the greedy keep mask as one
  ``stablehlo.while`` over the K rows, and the kept-first compaction as a
  stable sort of ``not keep`` and a gather of the packed rows.  The plain
  version would not lower: it packs bits with shifts, compacts with a
  scatter and bounds its loop with a host read.

The results of a program whose output is a dict are emitted in the order of
JAX's flattened dict (sorted keys), so ``<prefix>.out<i>.raw`` of
``yf_shlo`` means the same for both packages' files.
"""

from __future__ import annotations

import operator
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolofastest_torch.export.generic_onnx import _INLINE as _ONNX_INLINE
from yolofastest_torch.export.pt2 import Program, _no_stack_traces
from yolofastest_torch.kernels import nms as _nms
from yolofastest_torch.kernels import res_block as _rb

_TYPES = {torch.float32: "f32", torch.int64: "i32", torch.int32: "i32", torch.bool: "i1",
          torch.uint8: "ui8"}
_NUMPY = {"f32": np.float32, "i32": np.int32, "i1": np.bool_, "ui8": np.uint8}
_COMPARE_TYPE = {"f32": "FLOAT", "i32": "SIGNED", "i1": "UNSIGNED", "ui8": "UNSIGNED"}
INT_LIMIT = 1 << 24  # integers yf_shlo holds exactly (it stores every value as a float)
# the chain operators inlined through their plain versions, as the ONNX exporter
# inlines them; the NMS operator is lowered as a fragment (op_nms)
_INLINE = {op: fn for op, fn in _ONNX_INLINE.items() if op in _rb.CHAIN_OPS.values()}
_SKIP = {"_assert_tensor_metadata", "_assert_scalar", "sym_constrain_range_for_size"}
_PASS = {"clone", "alias", "detach", "lift_fresh_copy"}
_UNARY = {"sigmoid": "logistic", "exp": "exponential", "neg": "negate",
          "round": "round_nearest_even"}
_BINARY = {"add": "add", "sub": "subtract", "mul": "multiply", "div": "divide",
           "maximum": "maximum", "minimum": "minimum"}
_COMPARE = {"gt": "GT", "lt": "LT", "ge": "GE", "le": "LE", "eq": "EQ", "ne": "NE"}
_UNKNOWN = object()  # an argument whose value is known only when the program runs


def _ty(shape: Sequence[int], dt: str) -> str:
    return "tensor<" + "".join(f"{int(d)}x" for d in shape) + dt + ">"


def _dt(dtype: torch.dtype, what: str) -> str:
    if dtype not in _TYPES:
        raise NotImplementedError(f"{what} has dtype {dtype}; yf_shlo holds f32, i32, i1 and "
                                  "ui8 only")
    return _TYPES[dtype]


def _inverse(perm: Sequence[int]) -> Tuple[int, ...]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def _f32_literal(v) -> str:
    v = np.float32(v)
    if not np.isfinite(v):  # MLIR prints inf and NaN as their bit patterns
        return "0x" + v.tobytes()[::-1].hex().upper()
    return f"{float(v):.17e}"


class _V:
    """An emitted value: its SSA name, its shape and element type as
    emitted, and ``perm``, the permutation that gives the torch graph's
    (logical) view of it: ``logical.shape[i] == shape[perm[i]]``."""

    __slots__ = ("name", "shape", "dt", "perm")

    def __init__(self, name: str, shape, dt: str, perm: Optional[Tuple[int, ...]] = None):
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.dt = dt
        self.perm = None if perm is None or tuple(perm) == tuple(range(len(perm))) else tuple(perm)

    @property
    def logical(self) -> Tuple[int, ...]:
        return self.shape if self.perm is None else tuple(self.shape[p] for p in self.perm)


class _Const:
    """A value known at export time."""

    def __init__(self, value: torch.Tensor):
        self.value = value


class _Text:
    """The module's lines, SSA names and constants.  Constants are cached
    per region: a region sees its parents' constants, and its own go out of
    scope with it."""

    def __init__(self):
        self.lines: List[str] = []
        self.n = 0
        self.depth = 2
        self.consts: List[Dict[Any, str]] = [{}]

    def fresh(self, base: str = "v") -> str:
        self.n += 1
        return f"%{base}{self.n}"

    def line(self, text: str) -> None:
        self.lines.append("  " * self.depth + text)

    def op(self, rhs: str, results: int = 1) -> str:
        name = self.fresh()
        self.line(f"{name}{':%d' % results if results > 1 else ''} = {rhs}")
        return name

    def enter(self) -> None:
        self.depth += 1
        self.consts.append({})

    def leave(self) -> None:
        self.depth -= 1
        self.consts.pop()

    def constant(self, arr, dt: str) -> str:
        arr = np.asarray(arr)
        if arr.dtype != _NUMPY[dt]:
            cast = arr.astype(_NUMPY[dt])
            if dt != "f32" and not np.array_equal(cast, arr):
                raise NotImplementedError(f"constant not exactly representable as {dt}")
            arr = cast
        if dt in ("i32", "ui8") and arr.size and np.abs(arr.astype(np.int64)).max() >= INT_LIMIT:
            raise NotImplementedError("integer constant beyond 2^24, which yf_shlo's float "
                                      "storage does not hold exactly")
        splat = arr.size > 0 and bool((arr.reshape(-1) == arr.reshape(-1)[0]).all()) and (
            dt != "f32" or arr.reshape(-1)[0].tobytes() * arr.size == arr.tobytes())
        key = (dt, arr.shape, arr.reshape(-1)[0].tobytes() if splat else arr.tobytes())
        for scope in reversed(self.consts):
            if key in scope:
                return scope[key]
        if dt == "i1" and not splat:  # yf_shlo reads no list of booleans
            ints = self.constant(arr.astype(np.int32), "i32")
            name = self.op(f"stablehlo.convert {ints} : ({_ty(arr.shape, 'i32')}) -> "
                           f"{_ty(arr.shape, 'i1')}")
        else:
            if splat:
                v = arr.reshape(-1)[0]
                lit = (_f32_literal(v) if dt == "f32" else ("true" if v else "false")
                       if dt == "i1" else str(int(v)))
            elif dt == "f32":
                lit = '"0x' + arr.astype("<f4").tobytes().hex().upper() + '"'
            else:
                lit = str(arr.astype(np.int64).tolist())
            name = self.op(f"stablehlo.constant dense<{lit}> : {_ty(arr.shape, dt)}")
        self.consts[-1][key] = name
        return name


def _node_val(node):
    return node.meta["val"]


class _Lowerer:
    """Walks a core-ATen graph; ``env`` maps an fx node to a :class:`_V`, a
    :class:`_Const` or a tuple of either."""

    def __init__(self, text: _Text):
        self.t = text
        self.env: Dict[Any, Any] = {}

    # ------------------------------------------------------------ plumbing
    def known(self, arg):
        """The export-time value of an argument, or :data:`_UNKNOWN`."""
        if isinstance(arg, torch.fx.Node):
            v = self.env[arg]
            return v.value if isinstance(v, _Const) else _UNKNOWN
        if isinstance(arg, (list, tuple)):
            vals = [self.known(a) for a in arg]
            return _UNKNOWN if any(v is _UNKNOWN for v in vals) else type(arg)(vals)
        return arg

    def value(self, arg, dt: Optional[str] = None) -> _V:
        """An emitted value for a node, a constant or a Python scalar (as
        ``dt``, converted where its type differs)."""
        if isinstance(arg, torch.fx.Node):
            v = self.env[arg]
            if isinstance(v, _Const):
                return self.value(v.value, dt)
        elif isinstance(arg, torch.Tensor):
            arr = arg.detach().cpu().numpy()
            vdt = dt or _dt(arg.dtype, "a constant")
            return _V(self.t.constant(arr, vdt), arr.shape, vdt)
        elif isinstance(arg, (bool, int, float)):
            vdt = dt or ("i1" if isinstance(arg, bool) else "i32" if isinstance(arg, int)
                         else "f32")
            return _V(self.t.constant(np.asarray(arg), vdt), (), vdt)
        else:
            raise NotImplementedError(f"argument {arg!r} has no StableHLO lowering")
        return v if dt is None or v.dt == dt else self.convert(v, dt)

    def convert(self, v: _V, dt: str) -> _V:
        if v.dt == dt:
            return v
        name = self.t.op(f"stablehlo.convert {v.name} : ({_ty(v.shape, v.dt)}) -> "
                         f"{_ty(v.shape, dt)}")
        return _V(name, v.shape, dt, v.perm)

    def transpose(self, v: _V, dims: Sequence[int]) -> _V:
        """``stablehlo.transpose`` of the emitted value (result dim i = its
        dim ``dims[i]``), nothing where ``dims`` is the identity."""
        dims = tuple(int(d) for d in dims)
        if dims == tuple(range(len(dims))):
            return _V(v.name, v.shape, v.dt)
        shape = tuple(v.shape[d] for d in dims)
        name = self.t.op(f"stablehlo.transpose {v.name}, dims = {list(dims)} : "
                         f"({_ty(v.shape, v.dt)}) -> {_ty(shape, v.dt)}")
        return _V(name, shape, v.dt)

    def plain(self, v: _V) -> _V:
        """``v`` in its logical layout."""
        return v if v.perm is None else self.transpose(v, v.perm)

    def in_layout(self, v: _V, perm: Optional[Tuple[int, ...]]) -> _V:
        """``v`` (of full rank) laid out so that ``perm`` gives its logical
        view."""
        if v.perm == perm:
            return v
        rank = len(v.shape)
        have = v.perm or tuple(range(rank))
        inv = _inverse(perm or tuple(range(rank)))
        out = self.transpose(v, [have[inv[j]] for j in range(rank)])
        return _V(out.name, out.shape, out.dt, perm)

    def reshape(self, v: _V, shape: Sequence[int]) -> _V:
        v = self.plain(v)
        shape = tuple(int(d) for d in shape)
        if shape == v.shape:
            return v
        name = self.t.op(f"stablehlo.reshape {v.name} : ({_ty(v.shape, v.dt)}) -> "
                         f"{_ty(shape, v.dt)}")
        return _V(name, shape, v.dt)

    def broadcast(self, v: _V, dims: Sequence[int], shape: Sequence[int]) -> _V:
        """``stablehlo.broadcast_in_dim`` of the emitted value (operand dim
        j goes to result dim ``dims[j]``; size-1 dims stretch)."""
        shape = tuple(int(d) for d in shape)
        if v.shape == shape and list(dims) == list(range(len(shape))):
            return _V(v.name, v.shape, v.dt)
        name = self.t.op(f"stablehlo.broadcast_in_dim {v.name}, dims = {list(dims)} : "
                         f"({_ty(v.shape, v.dt)}) -> {_ty(shape, v.dt)}")
        return _V(name, shape, v.dt)

    def scalar(self, value, dt: str, shape: Sequence[int]) -> _V:
        """A Python scalar as ``dt``, broadcast to ``shape``."""
        return self.broadcast(self.value(value, dt), [], shape)

    def slice(self, v: _V, start: Sequence[int], limit: Sequence[int]) -> _V:
        v = self.plain(v)
        shape = tuple(b - a for a, b in zip(start, limit))
        bounds = ", ".join(f"{a}:{b}" for a, b in zip(start, limit))
        name = self.t.op(f"stablehlo.slice {v.name} [{bounds}] : ({_ty(v.shape, v.dt)}) -> "
                         f"{_ty(shape, v.dt)}")
        return _V(name, shape, v.dt)

    def concat(self, parts: Sequence[_V], dim: int) -> _V:
        parts = [self.plain(p) for p in parts]
        if len(parts) == 1:
            return parts[0]
        shape = list(parts[0].shape)
        shape[dim] = sum(p.shape[dim] for p in parts)
        dt = parts[0].dt
        name = self.t.op("stablehlo.concatenate " + ", ".join(p.name for p in parts)
                         + f", dim = {dim} : (" + ", ".join(_ty(p.shape, dt) for p in parts)
                         + f") -> {_ty(shape, dt)}")
        return _V(name, shape, dt)

    def binary(self, op: str, a: _V, b: _V) -> _V:
        name = self.t.op(f"stablehlo.{op} {a.name}, {b.name} : {_ty(a.shape, a.dt)}")
        return _V(name, a.shape, a.dt, a.perm)

    def unary(self, op: str, a: _V) -> _V:
        name = self.t.op(f"stablehlo.{op} {a.name} : {_ty(a.shape, a.dt)}")
        return _V(name, a.shape, a.dt, a.perm)

    def compare(self, direction: str, a: _V, b: _V) -> _V:
        name = self.t.op(f"stablehlo.compare  {direction}, {a.name}, {b.name},  "
                         f"{_COMPARE_TYPE[a.dt]} : ({_ty(a.shape, a.dt)}, {_ty(b.shape, b.dt)}) "
                         f"-> {_ty(a.shape, 'i1')}")
        return _V(name, a.shape, "i1", a.perm)

    def select(self, p: _V, a: _V, b: _V) -> _V:
        name = self.t.op(f"stablehlo.select {p.name}, {a.name}, {b.name} : "
                         f"{_ty(p.shape, 'i1')}, {_ty(a.shape, a.dt)}")
        return _V(name, a.shape, a.dt, a.perm)

    def iota(self, dim: int, shape: Sequence[int], dt: str = "i32") -> _V:
        name = self.t.op(f"stablehlo.iota dim = {dim} : {_ty(shape, dt)}")
        return _V(name, shape, dt)

    def gather(self, operand: _V, indices: _V, offset_dims, collapsed, start_index_map,
               index_vector_dim: int, slice_sizes, shape) -> _V:
        operand, indices = self.plain(operand), self.plain(indices)
        numbers = []
        if offset_dims:
            numbers.append(f"offset_dims = {list(offset_dims)}")
        if collapsed:
            numbers.append(f"collapsed_slice_dims = {list(collapsed)}")
        numbers += [f"start_index_map = {list(start_index_map)}",
                    f"index_vector_dim = {index_vector_dim}"]
        name = self.t.op(
            f'"stablehlo.gather"({operand.name}, {indices.name}) <{{dimension_numbers = '
            f'#stablehlo.gather<{", ".join(numbers)}>, indices_are_sorted = false, '
            f'slice_sizes = array<i64: {", ".join(str(int(s)) for s in slice_sizes)}>}}> : '
            f'({_ty(operand.shape, operand.dt)}, {_ty(indices.shape, indices.dt)}) -> '
            f'{_ty(shape, operand.dt)}')
        return _V(name, shape, operand.dt)

    def take_along(self, operand: _V, index: _V, dim: int) -> _V:
        """``torch.gather(operand, dim, index)``: one gather whose index
        vectors are the index along ``dim`` and iotas along the other dims."""
        index = self.convert(self.plain(index), "i32")
        rank = len(index.shape)
        parts = []
        for d in range(rank):
            part = index if d == dim else self.iota(d, index.shape)
            parts.append(self.reshape(part, (*index.shape, 1)))
        indices = self.concat(parts, rank)
        dims = list(range(rank))
        return self.gather(operand, indices, [], dims, dims, rank, [1] * rank, index.shape)

    def sort(self, operands: Sequence[_V], dim: int, direction: str) -> str:
        """Stable sort of ``operands`` along ``dim`` by the first, compared
        with ``direction``; returns the results' SSA base (``#i``)."""
        operands = [self.plain(v) for v in operands]
        key = operands[0]
        params = [(self.t.fresh("p"), self.t.fresh("p"), v.dt) for v in operands]
        types = ", ".join(_ty(v.shape, v.dt) for v in operands)
        name = self.t.op(f'"stablehlo.sort"(' + ", ".join(v.name for v in operands)
                         + f') <{{dimension = {dim} : i64, is_stable = true}}> ({{',
                         len(operands))
        self.t.enter()
        self.t.line("^bb0(" + ", ".join(f"{a}: {_ty((), dt)}, {b}: {_ty((), dt)}"
                                        for a, b, dt in params) + "):")
        a, b, _ = params[0]
        lt = self.t.op(f"stablehlo.compare  {direction}, {a}, {b},  {_COMPARE_TYPE[key.dt]} : "
                       f"({_ty((), key.dt)}, {_ty((), key.dt)}) -> {_ty((), 'i1')}")
        self.t.line(f"stablehlo.return {lt} : {_ty((), 'i1')}")
        self.t.leave()
        self.t.line(f"}}) : ({types}) -> ({types})")
        return name

    def run(self, graph: torch.fx.Graph) -> None:
        for node in graph.nodes:
            if node.op == "call_function":
                self.call(node)

    def call(self, node) -> None:
        target = node.target
        if target is operator.getitem:
            self.env[node] = self.env[node.args[0]][node.args[1]]
            return
        name = getattr(target, "_opname", None)
        if name in _SKIP:
            return
        if not isinstance(target, torch._ops.OpOverload):
            raise NotImplementedError(f"{target} has no StableHLO lowering (export/mlir.py)")
        args = [self.known(a) for a in node.args]
        kwargs = {k: self.known(v) for k, v in node.kwargs.items()}
        if not any(v is _UNKNOWN for v in (*args, *kwargs.values())):
            if torch.Tag.nondeterministic_seeded in target.tags:
                raise NotImplementedError(f"random operator {target} has no StableHLO lowering")
            out = target(*args, **kwargs)  # every input known: computed at export time
            self.env[node] = (tuple(_Const(o) for o in out) if isinstance(out, (tuple, list))
                              else _Const(out))
            return
        if target is _nms.NMS_PACKED_OP:
            self.env[node] = self.op_nms(node, *node.args)
            return
        if target.namespace != "aten":
            raise NotImplementedError(f"operator {target} has no StableHLO lowering "
                                      "(export/mlir.py)")
        if name in _PASS:
            self.env[node] = self.env[node.args[0]]
            return
        if name in _UNARY or name in _BINARY or name in _COMPARE:
            if target._overloadname.endswith("_mode") or target._overloadname == "decimals":
                raise NotImplementedError(f"torch operator {target} has no StableHLO lowering "
                                          "for yf_shlo (export/mlir.py)")
            self.env[node] = self.elementwise(node)
            return
        handler = getattr(self, f"op_{name}", None)
        if handler is None:
            raise NotImplementedError(f"torch operator {target} has no StableHLO lowering for "
                                      "yf_shlo (export/mlir.py)")
        self.env[node] = handler(node, *node.args, **node.kwargs)

    # --------------------------------------------------------- elementwise
    @staticmethod
    def _meta(arg):
        """A meta tensor standing for ``arg`` in dtype promotion."""
        if isinstance(arg, torch.fx.Node):
            val = _node_val(arg)
            return torch.empty([1] * val.dim(), dtype=val.dtype, device="meta")
        if isinstance(arg, torch.Tensor):
            return torch.empty([1] * arg.dim(), dtype=arg.dtype, device="meta")
        return arg

    def operands(self, node, args, dt: str) -> List[_V]:
        """``args`` broadcast to the node's shape, as ``dt``, in one layout:
        that of an operand of the node's full shape that carries a
        permutation, so that a convolution's output needs no transpose."""
        out = tuple(int(d) for d in _node_val(node).shape)
        rank = len(out)
        perm = None
        for a in args:
            if isinstance(a, torch.fx.Node) and isinstance(self.env[a], _V):
                v = self.env[a]
                if v.perm is not None and v.logical == out:
                    perm = v.perm
                    break
        inv = _inverse(perm) if perm else tuple(range(rank))
        phys = tuple(out[inv[j]] for j in range(rank))
        vals = []
        for a in args:
            known = self.known(a)
            if known is _UNKNOWN:
                v = self.convert(self.env[a], dt)
                if len(v.shape) < rank:
                    v = self.reshape(v, (1,) * (rank - len(v.shape)) + v.logical)
                v = self.in_layout(v, perm)
            elif isinstance(known, torch.Tensor) and known.numel() > 1:
                arr = known.detach().cpu().numpy()
                arr = arr.reshape((1,) * (rank - arr.ndim) + arr.shape).transpose(inv)
                v = _V(self.t.constant(arr, dt), arr.shape, dt)
            else:  # a Python scalar or a one-element constant
                scalar = known.reshape(()).item() if isinstance(known, torch.Tensor) else known
                v = self.value(scalar, dt)
            vals.append(_V(self.broadcast(v, range(len(v.shape)), phys).name, phys, dt, perm))
        return vals

    def elementwise(self, node) -> _V:
        name = node.target._opname
        val = _node_val(node)
        args = list(node.args)
        if name in _COMPARE:
            cdt = _dt(torch.result_type(*(self._meta(a) for a in args[:2])), str(node.target))
            a, b = self.operands(node, args[:2], cdt)
            return self.compare(_COMPARE[name], a, b)
        dt = _dt(val.dtype, str(node.target))
        if name in _UNARY:
            if dt != "f32":
                raise NotImplementedError(f"{node.target} on {val.dtype} has no lowering")
            (a,) = self.operands(node, args[:1], dt)
            return self.unary(_UNARY[name], a)
        if dt not in ("f32", "i32"):
            raise NotImplementedError(f"{node.target} on {val.dtype} has no lowering")
        if name == "div" and dt != "f32":
            raise NotImplementedError(f"{node.target} on integers has no lowering")
        a, b = self.operands(node, args[:2], dt)
        alpha = node.kwargs.get("alpha", 1)
        if alpha != 1:
            b = self.binary("multiply", b, self.scalar(alpha, dt, b.shape))
        return self.binary(_BINARY[name], a, b)

    def op_relu(self, node, x):
        (a,) = self.operands(node, [x], "f32")
        return self.binary("maximum", a, self.scalar(0.0, "f32", a.shape))

    def op_where(self, node, cond, x, y):
        dt = _dt(_node_val(node).dtype, str(node.target))
        out = self.operands(node, [x, y], dt)
        perm = out[0].perm
        p = self.value(cond, "i1")
        rank = len(out[0].shape)
        if len(p.shape) < rank:
            p = self.reshape(p, (1,) * (rank - len(p.shape)) + p.logical)
        p = self.in_layout(p, perm)
        p = self.broadcast(p, range(rank), out[0].shape)
        return self.select(p, *out)

    def op_clamp(self, node, x, min=None, max=None):
        dt = _dt(_node_val(node).dtype, str(node.target))
        (y,) = self.operands(node, [x], dt)
        if min is not None:
            y = self.binary("maximum", y, self.scalar(min, dt, y.shape))
        if max is not None:
            y = self.binary("minimum", y, self.scalar(max, dt, y.shape))
        return y

    def op__to_copy(self, node, x, dtype=None, **_):
        v = self.env[x]
        return self.convert(v, _dt(_node_val(node).dtype, str(node.target)))

    def op_full_like(self, node, x, value, **_):
        val = _node_val(node)
        return self.scalar(value, _dt(val.dtype, str(node.target)), val.shape)

    # -------------------------------------------------------------- shapes
    def _reshape(self, node, x, *_):
        return self.reshape(self.env[x], _node_val(node).shape)

    op_view = op__unsafe_view = op_reshape = op_squeeze = op_unsqueeze = _reshape

    def op_permute(self, node, x, dims):
        v = self.env[x]
        rank = len(v.shape)
        have = v.perm or tuple(range(rank))
        return _V(v.name, v.shape, v.dt, tuple(have[int(d) % rank] for d in dims))

    def op_expand(self, node, x, *_):
        v = self.plain(self.env[x])
        out = tuple(int(d) for d in _node_val(node).shape)
        lead = len(out) - len(v.shape)
        return self.broadcast(v, range(lead, len(out)), out)

    def op_cat(self, node, tensors, dim=0):
        val = _node_val(node)
        dt = _dt(val.dtype, str(node.target))
        parts = [self.value(t, dt) for t in tensors
                 if 0 not in (_node_val(t).shape if isinstance(t, torch.fx.Node) else t.shape)]
        return self.concat(parts, int(dim) % val.dim())

    def op_slice(self, node, x, dim=0, start=None, end=None, step=1):
        if step != 1:
            raise NotImplementedError(f"{node.target} with a step other than 1 (yf_shlo's "
                                      "slice takes none)")
        v = self.env[x]
        size = v.logical
        dim = int(dim) % len(size)
        start = 0 if start is None else min(max(start + size[dim] if start < 0 else start, 0),
                                            size[dim])
        end = size[dim] if end is None else min(max(end + size[dim] if end < 0 else end, 0),
                                                size[dim])
        lo = [0] * len(size)
        hi = list(size)
        lo[dim], hi[dim] = start, max(end, start)
        return self.slice(v, lo, hi)

    def op_select(self, node, x, dim, index):
        v = self.env[x]
        size = v.logical
        dim = int(dim) % len(size)
        index = int(index) % size[dim]
        lo = [0] * len(size)
        hi = list(size)
        lo[dim], hi[dim] = index, index + 1
        return self.reshape(self.slice(v, lo, hi), _node_val(node).shape)

    # ---------------------------------------------------------- reductions
    def _dims(self, node, dims):
        rank = _node_val(node.args[0]).dim()
        return list(range(rank)) if not dims else sorted(int(d) % rank for d in dims)

    def _reduce(self, node, x, dims, keepdim, combiner, init, dt):
        v = self.plain(self.convert(self.env[x], dt))
        dims = self._dims(node, dims)
        shape = tuple(s for i, s in enumerate(v.shape) if i not in dims)
        c = self.value(init, dt)
        name = self.t.op(f"stablehlo.reduce({v.name} init: {c.name}) applies "
                         f"stablehlo.{combiner} across dimensions = {dims} : "
                         f"({_ty(v.shape, dt)}, {_ty((), dt)}) -> {_ty(shape, dt)}")
        out = _V(name, shape, dt)
        return self.reshape(out, _node_val(node).shape) if keepdim else out

    def op_sum(self, node, x, dims=None, keepdim=False, **_):
        dt = _dt(_node_val(node).dtype, str(node.target))
        return self._reduce(node, x, dims, keepdim, "add", 0, dt)

    def op_amax(self, node, x, dims=(), keepdim=False):
        dt = _dt(_node_val(node).dtype, str(node.target))
        init = -np.inf if dt == "f32" else -(INT_LIMIT - 1)
        return self._reduce(node, x, dims, keepdim, "maximum", init, dt)

    def op_argmax(self, node, x, dim=None, keepdim=False):
        """JAX's argmax: a two-operand reduce that keeps the first maximum."""
        if dim is None:
            raise NotImplementedError(f"{node.target} over a flattened tensor")
        v = self.plain(self.env[x])
        if v.dt != "f32":
            raise NotImplementedError(f"{node.target} on {v.dt}")
        dim = int(dim) % len(v.shape)
        shape = tuple(s for i, s in enumerate(v.shape) if i != dim)
        idx = self.iota(dim, v.shape)
        lo, zero = self.value(-np.inf, "f32"), self.value(0, "i32")
        name = self.t.op(f"stablehlo.reduce({v.name} init: {lo.name}), ({idx.name} init: "
                         f"{zero.name}) across dimensions = [{dim}] : ({_ty(v.shape, 'f32')}, "
                         f"{_ty(v.shape, 'i32')}, {_ty((), 'f32')}, {_ty((), 'i32')}) -> "
                         f"({_ty(shape, 'f32')}, {_ty(shape, 'i32')})", 2)
        f, i = _ty((), "f32"), _ty((), "i32")
        av, bv, ai, bi = (self.t.fresh("p") for _ in range(4))
        self.t.enter()
        self.t.line(f"reducer({av}: {f}, {bv}: {f}) ({ai}: {i}, {bi}: {i})  {{")
        gt = self.t.op(f"stablehlo.compare  GT, {av}, {bv},  FLOAT : ({f}, {f}) -> tensor<i1>")
        eq = self.t.op(f"stablehlo.compare  EQ, {av}, {bv},  FLOAT : ({f}, {f}) -> tensor<i1>")
        first = self.t.op(f"stablehlo.compare  LT, {ai}, {bi},  SIGNED : ({i}, {i}) -> "
                          "tensor<i1>")
        tie = self.t.op(f"stablehlo.and {eq}, {first} : tensor<i1>")
        take = self.t.op(f"stablehlo.or {gt}, {tie} : tensor<i1>")
        best = self.t.op(f"stablehlo.select {gt}, {av}, {bv} : tensor<i1>, {f}")
        at = self.t.op(f"stablehlo.select {take}, {ai}, {bi} : tensor<i1>, {i}")
        self.t.line(f"stablehlo.return {best}, {at} : {f}, {i}")
        self.t.leave()
        self.t.line("}")
        out = _V(f"{name}#1", shape, "i32")
        return self.reshape(out, _node_val(node).shape) if keepdim else out

    def op_sort(self, node, x, dim=-1, descending=False, stable=None):
        """``sort.stable`` (and ``sort.default``, sorted stably too)."""
        v = self.plain(self.env[x])
        dim = int(dim) % len(v.shape)
        name = self.sort([v, self.iota(dim, v.shape)], dim, "GT" if descending else "LT")
        return (_V(f"{name}#0", v.shape, v.dt), _V(f"{name}#1", v.shape, "i32"))

    def op_gather(self, node, x, dim, index, sparse_grad=False):
        v = self.value(x)
        dim = int(dim) % len(v.shape)
        return self.take_along(v, self.value(index), dim)

    # --------------------------------------------------------- convolution
    def _nhwc(self, x) -> _V:
        """The NHWC value of a logically NCHW operand: as it lies where it
        carries the permutation a convolution's output has."""
        v = self.value(x, "f32")
        have = v.perm or (0, 1, 2, 3)
        return self.transpose(v, [have[d] for d in (0, 2, 3, 1)])

    def op_convolution(self, node, x, w, bias, stride, padding, dilation, transposed,
                       output_padding, groups):
        weight = self.known(w)
        if weight is _UNKNOWN or self.known(bias) is _UNKNOWN:
            raise NotImplementedError(f"{node.target} with weights computed when the program "
                                      "runs")
        if len(stride) != 2:
            raise NotImplementedError(f"{node.target}: only 2D convolutions")
        if weight.dtype != torch.float32:
            raise NotImplementedError(f"{node.target} in {weight.dtype}: yf_shlo runs f32")
        xin = self._nhwc(x)
        b, c, oh, ow = (int(d) for d in _node_val(node).shape)
        kernel = weight.detach().cpu().numpy()
        if transposed:
            y = self._deconv(node, xin, kernel, stride, padding, dilation, output_padding,
                             groups)
        else:
            if any(int(d) != 1 for d in dilation):
                raise NotImplementedError(f"{node.target} with dilation: yf_shlo runs no "
                                          "rhs_dilate")
            hwio = kernel.transpose(2, 3, 1, 0)
            wname = self.t.constant(hwio, "f32")
            ph, pw = (int(p) for p in padding)
            sh, sw = (int(s) for s in stride)
            out = (b, oh, ow, c)
            name = self.t.op(
                f"stablehlo.convolution({xin.name}, {wname}) dim_numbers = "
                f"[b, 0, 1, f]x[0, 1, i, o]->[b, 0, 1, f], window = {{stride = [{sh}, {sw}], "
                f"pad = [[{ph}, {ph}], [{pw}, {pw}]]}} {{batch_group_count = 1 : i64, "
                f"feature_group_count = {int(groups)} : i64}} : ({_ty(xin.shape, 'f32')}, "
                f"{_ty(hwio.shape, 'f32')}) -> {_ty(out, 'f32')}")
            y = _V(name, out, "f32")
        if bias is not None:
            bvec = self.known(bias).detach().cpu().numpy().reshape(1, 1, 1, -1)
            bc = _V(self.t.constant(bvec, "f32"), bvec.shape, "f32")
            y = self.binary("add", y, self.broadcast(bc, range(4), y.shape))
        return _V(y.name, y.shape, "f32", (0, 3, 1, 2))

    def _deconv(self, node, xin, kernel, stride, padding, dilation, output_padding, groups):
        """A transposed convolution whose stride equals its kernel (windows
        that do not overlap), as JAX's deconv computes it: (B,H,W,C) x
        (C, kh*kw*O) -> (B,H,W,kh,kw,O) -> (B,H*kh,W*kw,O)."""
        cin, cout, kh, kw = kernel.shape
        if ([int(s) for s in stride] != [kh, kw] or any(int(p) for p in padding)
                or any(int(p) for p in output_padding) or any(int(d) != 1 for d in dilation)
                or int(groups) != 1):
            raise NotImplementedError(f"{node.target} (transposed) other than stride = kernel, "
                                      "no padding, dilation or groups")
        rhs = kernel.transpose(0, 2, 3, 1).reshape(cin, kh * kw * cout)
        rname = self.t.constant(rhs, "f32")
        b, h, w, _ = xin.shape
        flat = (b, h, w, kh * kw * cout)
        name = self.t.op(f"stablehlo.dot_general {xin.name}, {rname}, contracting_dims = [3] x "
                         f"[0], precision = [DEFAULT, DEFAULT] : ({_ty(xin.shape, 'f32')}, "
                         f"{_ty(rhs.shape, 'f32')}) -> {_ty(flat, 'f32')}")
        y = self.reshape(_V(name, flat, "f32"), (b, h, w, kh, kw, cout))
        y = self.transpose(y, (0, 1, 3, 2, 4, 5))
        return self.reshape(y, (b, h * kh, w * kw, cout))

    # ----------------------------------------------------------------- NMS
    def op_nms(self, node, boxes, conf, cls_score, cls_idx, valid, iou_thre, max_det,
               pixel_offset):
        """``yolofastest::nms_packed`` in JAX's form: the suppression
        matrix, the greedy keep mask as a while loop over the rows, and the
        kept-first compaction as a stable sort and a gather.  Returns the
        packed rows and the keep mask, as the operator does."""
        t = self.t
        bx = self.plain(self.value(boxes, "f32"))
        ci = self.plain(self.value(cls_idx, "i32"))
        vd = self.plain(self.value(valid, "i1"))
        b, k = vd.shape
        kk = (b, k, k)

        def corner(c, dims, shape):
            col = self.reshape(self.slice(bx, (0, 0, c), (b, k, c + 1)), (b, k))
            return self.broadcast(col, dims, shape)

        rows = [corner(c, [0, 1], kk) for c in range(4)]  # candidate i (a)
        cols = [corner(c, [0, 2], kk) for c in range(4)]  # candidate j (b)
        po = self.scalar(float(pixel_offset), "f32", kk)
        zero = self.scalar(0.0, "f32", kk)
        ix1 = self.binary("maximum", rows[0], cols[0])
        iy1 = self.binary("maximum", rows[1], cols[1])
        ix2 = self.binary("minimum", rows[2], cols[2])
        iy2 = self.binary("minimum", rows[3], cols[3])
        iw = self.binary("maximum", self.binary("add", self.binary("subtract", ix2, ix1), po),
                         zero)
        ih = self.binary("maximum", self.binary("add", self.binary("subtract", iy2, iy1), po),
                         zero)
        inter = self.binary("multiply", iw, ih)

        def area(c):
            w = self.binary("add", self.binary("subtract", c[2], c[0]), po)
            return self.binary("multiply", w, self.binary("add", self.binary("subtract", c[3],
                                                                               c[1]), po))

        den = self.binary("subtract", self.binary("add", area(rows), area(cols)), inter)
        iou = self.binary("divide", inter, self.binary("add", den, zero))
        over = self.compare("GT", iou, self.scalar(float(np.float32(iou_thre)), "f32", kk))
        same = self.compare("EQ", self.broadcast(ci, [0, 1], kk), self.broadcast(ci, [0, 2], kk))
        later = self.compare("LT", self.iota(0, (k, k)), self.iota(1, (k, k)))
        sup = self.binary("and", self.binary("and", over, same), self.broadcast(later, [1, 2], kk))
        sup = self.binary("and", sup, self.broadcast(vd, [0, 1], kk))

        # keep &= ~(suppress[:, i] & keep[:, i]) for i = 0 .. K-1
        i0, kc, one = (self.value(v, "i32") for v in (0, k, 1))
        it_i, it_keep = t.fresh("iterArg"), t.fresh("iterArg")
        loop_ty = f"{_ty((), 'i32')}, {_ty((b, k), 'i1')}"
        loop = t.op(f"stablehlo.while({it_i} = {i0.name}, {it_keep} = {vd.name}) : {loop_ty}", 2)
        t.enter()
        t.line("cond {")
        more = t.op(f"stablehlo.compare  LT, {it_i}, {kc.name},  SIGNED : ({_ty((), 'i32')}, "
                    f"{_ty((), 'i32')}) -> {_ty((), 'i1')}")
        t.line(f"stablehlo.return {more} : {_ty((), 'i1')}")
        t.depth -= 1
        t.line("} do {")
        t.depth += 1
        i1 = self.reshape(_V(it_i, (), "i32"), (1,))
        start = self.concat([i1, _V(t.constant(np.zeros(1, np.int32), "i32"), (1,), "i32")], 0)
        row = self.gather(_V(sup.name, kk, "i1"), start, [0, 1, 2], [], [1, 2], 0, (b, 1, k),
                          (b, 1, k))
        row = self.reshape(row, (b, k))
        alive = self.gather(_V(it_keep, (b, k), "i1"), i1, [0, 1], [], [1], 0, (b, 1), (b, 1))
        alive = self.broadcast(alive, [0, 1], (b, k))
        gone = self.unary("not", self.binary("and", row, alive))
        keep_next = self.binary("and", _V(it_keep, (b, k), "i1"), gone)
        i_next = self.binary("add", _V(it_i, (), "i32"), one)
        t.line(f"stablehlo.return {i_next.name}, {keep_next.name} : {loop_ty}")
        t.leave()
        t.line("}")
        keep = _V(f"{loop}#1", (b, k), "i1")

        # kept rows first, each part in conf order: a stable sort of ~keep
        m = min(k, int(max_det))
        order = self.sort([self.unary("not", keep), self.iota(1, (b, k))], 1, "LT")
        order = self.slice(_V(f"{order}#1", (b, k), "i32"), (0, 0), (b, m))
        columns = [bx] + [self.reshape(self.value(v, "f32"), (b, k, 1))
                          for v in (conf, cls_score)]
        columns += [self.reshape(self.convert(ci, "f32"), (b, k, 1)),
                    self.reshape(self.convert(keep, "f32"), (b, k, 1))]
        stacked = self.concat(columns, 2)  # (B, K, 8)
        index = self.concat([self.reshape(self.iota(0, (b, m)), (b, m, 1)),
                             self.reshape(order, (b, m, 1))], 2)
        packed = self.gather(stacked, index, [2], [0, 1], [0, 1], 2, (1, 1, 8), (b, m, 8))
        return (packed, keep)


def _decompositions():
    table = torch.export.default_decompositions()
    table.update(_INLINE)
    return table


def to_mlir_text(program) -> str:
    """The StableHLO text of ``program`` (a :class:`Program` or a
    ``torch.export.ExportedProgram``): one ``@main`` of one argument, the
    weights as constants.  Raises ``NotImplementedError`` naming the first
    operator that ``yf_shlo`` could not run."""
    exported = program.exported if isinstance(program, Program) else program
    with _no_stack_traces():
        exported = exported.run_decompositions(_decompositions())
    graph, sig = exported.graph, exported.graph_signature
    placeholders = {n.name: n for n in graph.nodes if n.op == "placeholder"}
    user = [placeholders[name] for name in sig.user_inputs]
    if len(user) != 1:
        raise NotImplementedError(f"yf_shlo runs a @main of one argument; this program takes "
                                  f"{len(user)}")
    text = _Text()
    lw = _Lowerer(text)
    arg = user[0].meta["val"]
    arg_dt = _dt(arg.dtype, "the program's input")
    lw.env[user[0]] = _V("%arg0", arg.shape, arg_dt)
    state = {**exported.state_dict, **exported.constants}
    for spec in sig.input_specs:
        if spec.target is not None and spec.arg.name in placeholders:
            lw.env[placeholders[spec.arg.name]] = _Const(state[spec.target])
    lw.run(graph)
    outputs = list(graph.output_node().args[0])
    results = []
    for node in outputs:
        val = node.meta["val"]
        dt = _dt(val.dtype, "an output")
        results.append(lw.plain(lw.value(node, dt)))
    # JAX's order of the flattened outputs: a dict's leaves by sorted key
    spec = exported.call_spec.out_spec
    keys = spec.context if spec is not None and spec.type is dict else None
    order = sorted(range(len(results)), key=keys.__getitem__) if keys else range(len(results))
    results = [results[i] for i in order]
    head = [f"// yolofastest_torch program for yf_shlo (cpp/runner/shlo_runner.cpp): input "
            f"{_ty(arg.shape, arg_dt)}"]
    for i, j in enumerate(order):
        label = f"result {keys[j]!r}" if keys else f"result {j}"
        head.append(f"// out{i}: {label} {_ty(results[i].shape, results[i].dt)}")
    ret_types = ", ".join(_ty(r.shape, r.dt) for r in results)
    lines = head + ["module @yolofastest_torch {",
                    f"  func.func public @main(%arg0: {_ty(arg.shape, arg_dt)}) -> "
                    f"({ret_types}) {{"]
    lines += text.lines
    lines.append("    return " + ", ".join(r.name for r in results) + f" : {ret_types}")
    lines += ["  }", "}", ""]
    return "\n".join(lines)


def save_exported_mlir(program, path: str) -> None:
    """Write the StableHLO text of ``program`` (:func:`to_mlir_text`) to
    ``path``, for ``cpp/runner/shlo_runner.cpp`` (``yf_shlo model.mlir
    input.raw out_prefix``; :func:`yolofastest_torch.native.build_shlo_runner`
    builds it)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    mlir = to_mlir_text(program)
    with open(path, "w") as f:
        f.write(mlir)
