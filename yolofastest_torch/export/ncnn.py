"""ncnn ``.param`` / ``.bin`` export and import of the folded deployment graph.

The port of ``yolofastest_tpu/export/ncnn.py``.  ncnn is the
reference's embedded runtime: its chain ``.pth -> ONNX -> onnx2ncnn ->
ncnnoptimize -> .param/.bin`` ends in the artifacts ``Detect_YOLO`` loads
(``ncnn_deploy/src/YOLO_ncnn.cpp:12-14``).  :func:`export_ncnn` writes that
final optimised form directly from the folded graph: the same ``data`` input
blob, the same ``head_large`` / ``head_small`` outputs, the same ``(pixel -
128) / 255`` normalisation.

Format:

* ``.param`` is the magic-``7767517`` text format: one layer per line,
  ``type name n_in n_out in-blobs... out-blobs... k=v...``.  BN is folded
  (the ``-opt`` form), ReLU rides the conv's activation param (``9=1``), and
  a blob with more than one consumer goes through an explicit ``Split``.
* ``.bin`` is, in param-file layer order, each weighted layer's ``uint32``
  quantisation tag (0 = fp32), its OIHW kernel floats (Deconvolution too)
  and its bias floats.

The layer table comes from the topology walk over an executor whose
"tensors" are blob names; the port's chains unroll into the JAX walk's
calls in its order, so the files are byte for byte the JAX writer's.
:func:`import_ncnn` reads such a pair back, the reference's own shipped
ones included, and :func:`export_ncnn_table` writes the int8 calibration
table ncnn's own ``ncnn2int8`` takes.  An independent consumer, ``tools/ncnn_check.py``,
parses and executes the files with numpy alone.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from yolofastest_torch.models.graph import Executor, walk_topology, walk_topology_lite

_HEAD_BLOBS = {"head_4": "head_large", "head_5": "head_small"}


class _Layer:
    def __init__(self, typ: str, name: str, ins: List[str], outs: List[str],
                 params: Dict[int, str]):
        self.typ, self.name, self.ins, self.outs, self.params = (
            typ, name, ins, outs, params)


class _NcnnEmit(Executor):
    """Topology-walk executor whose tensors are ncnn blob names; emits the
    layer table and the weight chunks (in layer order) as a side effect."""

    def __init__(self, folded: Dict[str, Dict[str, np.ndarray]]):
        self.p = folded
        self.layers: List[_Layer] = []
        self.chunks: List[np.ndarray] = []  # per weighted layer: tag,k,b

    # -- helpers ----------------------------------------------------------
    def _weights(self, kernel_oihw: np.ndarray, bias: np.ndarray) -> None:
        self.chunks.append(np.asarray([0], np.uint32).view(np.float32))
        self.chunks.append(np.ascontiguousarray(kernel_oihw, np.float32).ravel())
        self.chunks.append(np.asarray(bias, np.float32).ravel())

    # -- ops --------------------------------------------------------------
    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        p = self.p[name]
        k = np.asarray(p["kernel"], np.float32)  # HWIO
        nout = k.shape[3]
        pad = (kernel - 1) // 2
        wsize = int(k.size)
        params: Dict[int, str] = {0: str(nout), 1: str(kernel)}
        if stride != 1:
            params[3] = str(stride)
        if pad:
            params[4] = str(pad)
        params[5] = "1"
        params[6] = str(wsize)
        typ = "Convolution"
        if depthwise:
            typ = "ConvolutionDepthWise"
            params[7] = str(nout)
        if act:
            params[9] = "1"
        out = name
        self.layers.append(_Layer(typ, name, [x], [out], params))
        self._weights(k.transpose(3, 2, 0, 1), p["bias"])
        return out

    def deconv2x(self, x, name):
        p = self.p[name]
        k = np.asarray(p["kernel"], np.float32)  # (2, 2, Cin, Cout)
        nout = k.shape[3]
        params = {0: str(nout), 1: "2", 3: "2", 5: "1",
                  6: str(int(k.size)), 9: "1"}
        out = name
        self.layers.append(_Layer("Deconvolution", name, [x], [out], params))
        self._weights(k.transpose(3, 2, 0, 1), p["bias"])
        return out

    def head(self, x, name):
        p = self.p[name]
        k = np.asarray(p["kernel"], np.float32)
        out = _HEAD_BLOBS[name]
        params = {0: str(k.shape[3]), 1: "1", 5: "1", 6: str(int(k.size))}
        self.layers.append(_Layer("Convolution", name, [x], [out], params))
        self._weights(k.transpose(3, 2, 0, 1), p["bias"])
        return out

    def add(self, x, y):
        out = f"add_{len(self.layers)}"
        self.layers.append(_Layer("BinaryOp", out, [x, y], [out], {}))
        return out

    def concat(self, x, y):
        out = f"cat_{len(self.layers)}"
        self.layers.append(_Layer("Concat", out, [x, y], [out], {}))
        return out


def _insert_splits(layers: List[_Layer]) -> List[_Layer]:
    """ncnn blobs are single-consumer: route every multiply-consumed blob
    through a Split layer placed right after its producer (matching the
    ``splitncnn`` convention of the reference's ncnnoptimize output)."""
    consumers: Dict[str, List[Any]] = {}
    for L in layers:
        for slot, blob in enumerate(L.ins):
            consumers.setdefault(blob, []).append((L, slot))

    out: List[_Layer] = []
    n_split = 0
    for L in layers:
        out.append(L)
        for blob in L.outs:
            cons = consumers.get(blob, [])
            if len(cons) > 1:
                outs = [f"{blob}_split{i}" for i in range(len(cons))]
                out.append(_Layer("Split", f"split{n_split}", [blob], outs, {}))
                n_split += 1
                for (cl, slot), new in zip(cons, outs):
                    cl.ins[slot] = new
    return out


class _NcnnNames(Executor):
    """Records the weighted-layer schedule (graph name, kind, kernel size)
    in topology-walk order; the tensors are dummies."""

    def __init__(self):
        self.sched: List[tuple] = []

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        self.sched.append((name, "dw" if depthwise else "conv", kernel))
        return x

    def deconv2x(self, x, name):
        self.sched.append((name, "deconv", 2))
        return x

    def head(self, x, name):
        self.sched.append((name, "head", 1))
        return x

    def add(self, x, y):
        return x

    def concat(self, x, y):
        return x


def _weight_schedule(arch: str) -> List[tuple]:
    em = _NcnnNames()
    walk = {"yolofastest": walk_topology,
            "yolofastest-lite": walk_topology_lite}[arch]
    walk("data", em)
    return em.sched


_WEIGHTED_TYPES = ("Convolution", "ConvolutionDepthWise", "Deconvolution")


def _parse_param(param_path: str) -> List[Dict[str, Any]]:
    """Magic-7767517 text param -> ordered layer dicts
    {type, name, ins, outs, params{int: str}}.  Malformed input fails as
    ``ValueError`` with the path (truncated/garbage files would otherwise
    leak IndexError/int() errors from the token walker)."""
    try:
        lines = [ln.split() for ln in open(param_path).read().splitlines()
                 if ln.strip()]
        if not lines or lines[0] != ["7767517"]:
            raise ValueError(
                f"bad ncnn param magic {lines[0] if lines else '(empty)'}")
        n_layers = int(lines[1][0])
        if len(lines) < 2 + n_layers:
            raise ValueError(f"header claims {n_layers} layers, file has "
                             f"{len(lines) - 2} lines")
        layers = []
        for toks in lines[2:2 + n_layers]:
            typ, name, nin, nout = toks[0], toks[1], int(toks[2]), int(toks[3])
            ins = toks[4:4 + nin]
            outs = toks[4 + nin:4 + nin + nout]
            if len(ins) != nin or len(outs) != nout:
                raise ValueError(f"layer {name!r}: truncated blob list")
            params = {}
            for kv in toks[4 + nin + nout:]:
                k, v = kv.split("=", 1)
                params[int(k)] = v
            layers.append({"type": typ, "name": name, "ins": ins,
                           "outs": outs, "params": params})
        return layers
    except ValueError as e:
        raise ValueError(f"{param_path}: malformed ncnn param ({e})"
                         if param_path not in str(e) else str(e)) from None
    except IndexError as e:
        raise ValueError(
            f"{param_path}: malformed ncnn param ({e})") from None


def import_ncnn(param_path: str, bin_path: Optional[str] = None,
                arch: Optional[str] = None):
    """Load an ncnn ``.param``/``.bin`` pair back into the folded-graph
    representation — including the *reference's own shipped* deployment
    artifacts (``models/ncnn/*/YOLO-Fastest_epoch_*-opt.{param,bin}``), so a
    reference user whose only model is the compiled embedded artifact can
    run it through the Detector (:func:`~yolofastest_torch.models.unfold_to_variables`
    lifts the result to a variables tree).

    ncnnoptimize autogenerates layer names, so blobs are aligned to our
    graph names by *weighted-layer order*, with each position verified
    against the expected layer type and kernel size.  Returns
    ``(folded, arch)`` where ``folded`` is the ``fold_batchnorm``-shaped
    ``{layer: {kernel, bias}}`` dict (HWIO kernels) and ``arch`` is
    ``"yolofastest"`` / ``"yolofastest-lite"`` (auto-detected from the
    weighted-layer sequence unless given).
    """
    if bin_path is None:
        bin_path = (param_path[: -len(".param")] + ".bin"
                    if param_path.endswith(".param") else param_path + ".bin")
    layers = _parse_param(param_path)
    weighted = [L for L in layers if L["type"] in _WEIGHTED_TYPES]

    if arch is None:
        for cand in ("yolofastest", "yolofastest-lite"):
            sched = _weight_schedule(cand)
            if len(sched) == len(weighted):
                arch = cand
                break
        else:
            raise ValueError(
                f"{param_path}: {len(weighted)} weighted layers match "
                "neither arch")
    sched = _weight_schedule(arch)
    if len(sched) != len(weighted):
        raise ValueError(
            f"{param_path}: {len(weighted)} weighted layers, arch {arch!r} "
            f"expects {len(sched)}")

    buf = open(bin_path, "rb").read()
    off = 0
    folded: Dict[str, Dict[str, np.ndarray]] = {}
    for L, (gname, kind, ksize) in zip(weighted, sched):
        p = L["params"]
        nout = int(p[0])
        kernel = int(p.get(1, "1"))
        wsize = int(p[6])
        expect_type = {"conv": "Convolution", "head": "Convolution",
                       "dw": "ConvolutionDepthWise",
                       "deconv": "Deconvolution"}[kind]
        if L["type"] != expect_type or kernel != ksize:
            raise ValueError(
                f"{param_path}: layer {L['name']!r} is {L['type']} k={kernel}"
                f", expected {expect_type} k={ksize} for graph layer "
                f"{gname!r} — not a YOLO-Fastest ncnn graph?")
        tag = int(np.frombuffer(buf, np.uint32, 1, off)[0])
        off += 4
        if tag != 0:
            raise ValueError(f"{bin_path}: {L['name']}: non-fp32 weight tag "
                             f"{tag:#x} unsupported")
        w = np.frombuffer(buf, np.float32, wsize, off).copy()
        off += 4 * wsize
        if int(p.get(5, "0")) != 1:
            raise ValueError(f"{param_path}: {L['name']}: bias_term=0 "
                             "unsupported (BN-folded graphs carry biases)")
        b = np.frombuffer(buf, np.float32, nout, off).copy()
        off += 4 * nout
        cin = wsize // (nout * kernel * kernel)
        # bin layout is OIHW for conv/dw AND deconv (deconv rides
        # (Cout, Cin, kh, kw)); invert the export transpose (3,2,0,1)
        k_hwio = w.reshape(nout, cin, kernel, kernel).transpose(2, 3, 1, 0)
        folded[gname] = {"kernel": np.ascontiguousarray(k_hwio), "bias": b}
    if off != len(buf):
        raise ValueError(f"{bin_path}: {len(buf) - off} trailing bytes "
                         "after the last weighted layer")
    return folded, arch


def export_ncnn(folded: Dict[str, Dict[str, np.ndarray]], input_hw,
                param_path: str, bin_path: Optional[str] = None,
                arch: str = "yolofastest") -> None:
    """Write the folded graph as ncnn ``.param`` + ``.bin``.

    ``input_hw`` is (H, W); the input blob is grayscale ``data`` with the
    reference's ``(pixel - 128) / 255`` normalisation applied by the caller
    (``substract_mean_normalize(mean=128, norm=1/255)`` on the ncnn side,
    ``YOLO_ncnn.cpp:45-47``).  ``arch`` selects the two-head graph or the
    single-head lite graph (output blob ``head_small`` only).
    """
    if bin_path is None:
        bin_path = param_path[: -len(".param")] + ".bin" \
            if param_path.endswith(".param") else param_path + ".bin"
    h, w = int(input_hw[0]), int(input_hw[1])
    em = _NcnnEmit(folded)
    em.layers.append(_Layer("Input", "data", [], ["data"],
                            {0: str(w), 1: str(h), 2: "1"}))
    if arch == "yolofastest":
        walk_topology("data", em)
    elif arch == "yolofastest-lite":
        walk_topology_lite("data", em)
    else:
        raise ValueError(f"unknown arch {arch!r}")

    layers = _insert_splits(em.layers)
    blobs = [b for L in layers for b in L.outs]

    with open(param_path, "w") as f:
        f.write("7767517\n")
        f.write(f"{len(layers)} {len(blobs)}\n")
        for L in layers:
            kv = " ".join(f"{k}={L.params[k]}" for k in sorted(L.params))
            ins = " ".join(L.ins)
            outs = " ".join(L.outs)
            line = f"{L.typ:<24} {L.name:<24} {len(L.ins)} {len(L.outs)}"
            for part in (ins, outs, kv):
                if part:
                    line += f" {part}"
            f.write(line + "\n")

    with open(bin_path, "wb") as f:
        for chunk in em.chunks:
            f.write(chunk.tobytes())


def export_ncnn_table(qparams: Dict[str, Dict[str, np.ndarray]], act_scales: Dict[str, float],
                      table_path: str, arch: str = "yolofastest") -> None:
    """Write the ncnn int8 calibration table for the exported ``.param``
    (``ncnn2int8 model.param model.bin out.param out.bin model.table``), from
    the scales the port's quantisation already computed.

    Two lines per quantised layer, the scales as multipliers (``127 /
    amax``, the inverse of the dequantisation scales), printed with
    ``%.17g`` so the float64 values round-trip::

        <layer>_param_0 <w_mult_out0> <w_mult_out1> ...
        <layer> <input_blob_mult>

    Only Convolution and ConvolutionDepthWise layers are listed: ncnn does
    not int8-quantise Deconvolution.
    """
    lines = []
    for name, kind, _k in _weight_schedule(arch):
        if kind == "deconv":
            continue
        if name not in qparams or name not in act_scales:
            raise ValueError(f"missing int8 scales for layer {name!r} (qparams from "
                             "quantize_weights, act_scales from calibrate)")
        w_mult = 1.0 / np.asarray(qparams[name]["w_scale"], np.float64)
        lines.append(name + "_param_0 " + " ".join("%.17g" % m for m in w_mult))
        lines.append("%s %.17g" % (name, 1.0 / float(act_scales[name])))
    with open(table_path, "w") as f:
        f.write("\n".join(lines) + "\n")
