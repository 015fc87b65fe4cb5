"""The port's serialised programs (``yolofastest_torch.export.pt2``) and its
generic ONNX exporter (``export_torch_onnx``) on the CPU, held against the
JAX package's ``export/stablehlo.py`` and ``export_jax_onnx``.

* The kernels as registered operators: schema and fake versions
  (``torch.library.opcheck``), and the exported graphs' targets (6
  ``res_chain_rows`` nodes in a folded forward, and 1 ``nms_packed`` in the
  detect pipeline).
* The generic exporter: each test of ``tests/test_generic_onnx.py`` mirrored
  (an MLP, a conv/pool CNN, the elementwise zoo; flax parameters from a seed
  carried into torch modules), both packages' files run by
  ``tools/onnx_check.py`` and held to JAX's function and to JAX's file with
  JAX's tolerances; the whole model at 64x96 (the trainable model in eval
  mode, and the folded forward through the chain operator) against JAX's
  ``model.apply`` within 2e-4; the same failures as JAX's.
* ``.pt2`` round trips at 64x96 (the golden frames resized, the confidence
  gate at 0.1 so that they keep detections): the folded forward of both
  architectures against JAX's ``folded_apply`` (1e-5, as
  ``tests/test_export.py``), the detect pipeline against JAX's exported
  one (counts, classes, boxes within 1 px, conf within 1e-4, as
  ``tests/test_torch_detector.py`` holds the Detector), the int8 forward
  against JAX's ``export_int8_forward`` bit for bit, and ``detect.pt2`` in a
  fresh process that imports ``yolofastest_torch.kernels`` and no model
  module.

The port's programs and the two large ONNX files are exported, loaded back
(``load_exported``) and run once, in a process of their own that also starts
the fresh consumer (``tests/_torch_programs.py``, started early by
``tests/_background.py``); this module holds what they wrote.  The JAX
references run in the workers of ``tests/_jax_refs.py``.
"""

import importlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from tests._background import port_exports  # noqa: F401 (a fixture)
from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from tests._torch_programs import (FORWARD_BATCH, INT8_BATCH, ZOOS, config_json, frames,
                                   net_input)
from yolofastest_torch.export import export_torch_onnx
from yolofastest_torch.kernels import nms as tnms
from yolofastest_torch.kernels import res_block as rb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
sys.path.insert(0, os.path.join(ROOT, "tools"))
pytestmark = pytest.mark.usefixtures("jax_refs")
# the operators tools/onnx_check.py runs
ONNX_CHECK_OPS = {"Conv", "ConvTranspose", "Relu", "Add", "Sub", "Mul", "Div", "Concat", "Identity",
                  "Sigmoid", "Exp", "Log", "Tanh", "Sqrt", "Reciprocal", "Abs", "Neg", "Pow",
                  "Max", "Min", "MatMul", "Reshape", "Transpose", "Slice", "Expand", "Where",
                  "Cast", "Greater", "Less", "GreaterOrEqual", "LessOrEqual", "Equal",
                  "ReduceSum", "ReduceMax", "ReduceMin", "MaxPool", "AveragePool"}


def _run_onnx(path, feeds):
    """(outputs, operator types) of ``tools/onnx_check.py`` on the file."""
    oc = importlib.import_module("onnx_check")
    nodes, init, g_in, g_out = oc.load_model(path)
    env = oc.run(nodes, init, dict(zip(g_in, feeds)))
    return [env[o] for o in g_out], {n[0] for n in nodes}


# ---------------------------------------------------------- JAX references
def _jax_generic():
    """The three functions of tests/test_generic_onnx.py with its seeds:
    inputs, flax parameters, JAX's outputs, and JAX's ONNX file run by
    tools/onnx_check.py."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.export import export_jax_onnx

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Dense(16)(x)
            x = nn.tanh(x)
            x = nn.Dense(8)(x)
            x = nn.sigmoid(x)
            return nn.Dense(3)(x)

    class CNN(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Conv(8, (3, 3), strides=(2, 2))(x)
            x = nn.relu(x)
            x = nn.avg_pool(x, (2, 2), strides=(2, 2))
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
            x = x.reshape((x.shape[0], -1))
            return nn.Dense(10)(x)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, module, x in (
                ("mlp", MLP(), np.random.default_rng(0).standard_normal((4, 10))),
                ("cnn", CNN(), np.random.default_rng(1).standard_normal((2, 32, 32, 3)))):
            x = np.asarray(x, np.float32)
            v = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
            fn = lambda x, module=module, v=v: module.apply(v, x)  # noqa: E731
            path = os.path.join(tmp, f"{name}.onnx")
            export_jax_onnx(fn, (jnp.asarray(x),), path)
            out[name] = {"params": jax.tree.map(np.asarray, v["params"]), "inputs": (x,),
                         "want": [np.asarray(fn(jnp.asarray(x)))],
                         "onnx": _run_onnx(path, [x])[0]}
        rng = np.random.default_rng(2)
        ab = tuple(rng.standard_normal((5, 7)).astype(np.float32) for _ in range(2))
        path = os.path.join(tmp, "ew.onnx")
        export_jax_onnx(_zoo_jax, tuple(jnp.asarray(a) for a in ab), path)
        out["ew"] = {"params": None, "inputs": ab,
                     "want": [np.asarray(o) for o in _zoo_jax(*map(jnp.asarray, ab))],
                     "onnx": _run_onnx(path, list(ab))[0]}
    return out


def _zoo_jax(a, b):
    import jax.numpy as jnp

    c = jnp.maximum(a, b) * jnp.exp(-jnp.abs(b)) + a / (1 + b ** 2)
    d = jnp.where(a > b, c, -c)
    e = d - jnp.log1p(jnp.exp(d))
    return e.sum(axis=1), e.max(axis=0) + jnp.sqrt(jnp.abs(a)).mean(axis=0)


def _zoo_torch(a, b):
    c = torch.maximum(a, b) * torch.exp(-torch.abs(b)) + a / (1 + b ** 2)
    d = torch.where(a > b, c, -c)
    e = d - torch.log1p(torch.exp(d))
    return e.sum(dim=1), e.amax(dim=0) + torch.sqrt(torch.abs(a)).mean(dim=0)


def _jax_heads(kind):
    """JAX's heads on the 64x96 net input: ``folded_<arch>`` (the jitted
    ``folded_apply``), ``model`` (``model.apply`` in eval mode, jitted), or
    ``model_256x320`` (on two golden frames)."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.models import (YoloFastest, fold_batchnorm, folded_apply,
                                        folded_apply_lite, load_variables, zoo_path)

    arch = kind.split("_")[1] if kind.startswith("folded") else "fastest"
    variables = jax.tree.map(jnp.asarray, load_variables(zoo_path(ZOOS[arch])))
    if kind == "model_256x320":
        fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
        x = (fx["pre_imgs"][:2].astype(np.float32)[..., None] - 128.0) / 255.0
    else:
        x = net_input(FORWARD_BATCH)
    if kind.startswith("model"):
        model = YoloFastest(num_cls=3, num_anchors=3)
        heads = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x))
    else:
        apply = folded_apply if arch == "fastest" else folded_apply_lite
        heads = jax.jit(apply)(jax.tree.map(jnp.asarray, fold_batchnorm(variables)),
                               jnp.asarray(x))
    return [np.asarray(h) for h in (heads if isinstance(heads, (tuple, list)) else (heads,))]


def _jax_program(kind):
    """JAX's exported program at 64x96 after a save and a load: ``detect``
    on the 20 frames (its dict), ``int8`` on the first INT8_BATCH frames
    (its heads), with the scales of the port's calibration on those frames,
    made here with one thread as the port's exporter makes them (the two
    packages' calibrations differ in the last bits of some amax,
    tests/test_torch_quant.py::test_calibrate_matches_jax)."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.configs import Config
    from yolofastest_tpu.export import (export_detect_pipeline, export_int8_forward,
                                        load_exported, save_exported)
    from yolofastest_tpu.models import load_variables, zoo_path

    cfg = Config.from_json(config_json())
    variables = load_variables(zoo_path(ZOOS["fastest"]))
    if kind == "detect":
        exp, arg = export_detect_pipeline(variables, cfg, batch=len(frames())), frames()
    else:
        from yolofastest_torch.models import fold_batchnorm
        from yolofastest_torch.quant import calibrate

        arg = net_input(INT8_BATCH)
        scales = calibrate(fold_batchnorm(variables), [arg], device="cpu")
        exp = export_int8_forward(variables, cfg, arg, batch=INT8_BATCH, act_scales=scales)
    with tempfile.TemporaryDirectory() as tmp:
        save_exported(exp, os.path.join(tmp, "p"))
        out = load_exported(os.path.join(tmp, "p")).call(jnp.asarray(arg))
    return jax.tree.map(np.asarray, out)


register("programs/generic", _jax_generic,
         tests=["test_mlp_roundtrip", "test_cnn_with_pooling_roundtrip",
                "test_elementwise_zoo_roundtrip"])
for _kind in ("folded_fastest", "folded_lite", "model"):
    register(f"programs/heads/{_kind}", _jax_heads, lambda k=_kind: (k,),
             tests=["test_forward_pt2_matches_jax", "test_full_model_generic_export_64x96"])
register("programs/heads/model_256x320", _jax_heads, lambda: ("model_256x320",),
         tests=["test_full_model_generic_export"])
register("programs/detect", _jax_program, lambda: ("detect",),
         tests=["test_detect_pt2_matches_jax"])
register("programs/int8", _jax_program, lambda: ("int8",), tests=["test_int8_pt2_matches_jax"])


# ----------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def programs(port_exports):  # noqa: F811
    """The exporter's directory, once it has written every file."""
    return port_exports.programs()


@pytest.fixture(scope="module")
def outputs(programs):
    """What the loaded programs and the port's functions gave in the
    exporter's process, and its record of the loaded graphs."""
    with np.load(os.path.join(programs, "outputs.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    with open(os.path.join(programs, "targets.json")) as f:
        return arrays, json.load(f)


def _heads(arrays, name):
    return [arrays[f"{name}/{j}"] for j in range(2) if f"{name}/{j}" in arrays]


# -------------------------------------------------------- the registered ops
def _chain_args(rows):
    rng = np.random.default_rng(0)
    k, c, i, b, h, w = 2, 8, 16, 2, 6, 5
    shapes = ((b * h * w, c) if rows else (c, b * h * w), (k, c, i), (k, i), (k, 3, 3, i),
              (k, i), (k, i, c), (k, c))
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
                 for s in shapes) + (h, w)


def _nms_args(keep_only):
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 50, (2, 24, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 30, (2, 24, 2))], -1)
                             .astype(np.float32))
    conf = torch.sort(torch.from_numpy(rng.uniform(0, 1, (2, 24)).astype(np.float32)),
                      dim=1, descending=True).values
    cls = torch.from_numpy(rng.integers(0, 3, (2, 24)).astype(np.int32))
    valid = conf > 0.3
    if keep_only:
        return boxes, cls, valid, 0.45, 0.0
    return boxes, conf, conf * 0.9, cls, valid, 0.45, 10, 0.0


@pytest.mark.parametrize("op,args", [
    (rb.CHAIN_OPS[False], lambda: _chain_args(False)),
    (rb.CHAIN_OPS[True], lambda: _chain_args(True)),
    (tnms.NMS_PACKED_OP, lambda: _nms_args(False)),
    (tnms.NMS_KEEP_OP, lambda: _nms_args(True))],
    ids=["res_chain_cf", "res_chain_rows", "nms_packed", "nms_keep"])
def test_registered_op_schema_and_fake(op, args):
    """Each kernel is a ``yolofastest::`` operator whose schema and fake
    (shape-only) version agree with its CPU version (the plain one)."""
    torch.library.opcheck(op, args(), test_utils=("test_schema", "test_faketensor"))


# ------------------------------------------------------------- generic ONNX
def _torch_module(name, params):
    """The flax module of ``_jax_generic`` as a torch module, with its
    parameters; input and output layouts as flax's (NHWC)."""
    def linear(p):
        layer = torch.nn.Linear(*p["kernel"].shape)
        layer.weight.data = torch.from_numpy(np.ascontiguousarray(p["kernel"].T))
        layer.bias.data = torch.from_numpy(p["bias"])
        return layer

    if name == "mlp":
        dense = [linear(params[f"Dense_{i}"]) for i in range(3)]
        return torch.nn.Sequential(dense[0], torch.nn.Tanh(), dense[1], torch.nn.Sigmoid(),
                                   dense[2])
    conv = torch.nn.Conv2d(3, 8, 3, 2)
    conv.weight.data = torch.from_numpy(
        np.ascontiguousarray(params["Conv_0"]["kernel"].transpose(3, 2, 0, 1)))
    conv.bias.data = torch.from_numpy(params["Conv_0"]["bias"])
    fc = linear(params["Dense_0"])

    class CNN(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv, self.fc = conv, fc

        def forward(self, x):
            # flax's SAME padding of a stride-2 3x3 conv on 32 rows: 0 above, 1 below
            y = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
            y = torch.relu(self.conv(y))
            y = torch.nn.functional.max_pool2d(torch.nn.functional.avg_pool2d(y, 2, 2), 2, 2)
            return self.fc(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1))

    return CNN()


def _generic_roundtrip(jax_refs, name, atol, tmp_path):  # noqa: F811
    ref = jax_refs["programs/generic"][name]
    fn = _zoo_torch if name == "ew" else _torch_module(name, ref["params"])
    path = str(tmp_path / f"{name}.onnx")
    assert export_torch_onnx(fn, tuple(map(torch.from_numpy, ref["inputs"])), path) == path
    got, ops = _run_onnx(path, list(ref["inputs"]))
    assert ops <= ONNX_CHECK_OPS
    assert len(got) == len(ref["want"]) == len(ref["onnx"])
    for g, w, o in zip(got, ref["want"], ref["onnx"]):
        np.testing.assert_allclose(g, w, atol=atol)
        np.testing.assert_allclose(g, o, atol=atol)


def test_mlp_roundtrip(jax_refs, tmp_path):  # noqa: F811
    _generic_roundtrip(jax_refs, "mlp", 1e-5, tmp_path)


def test_cnn_with_pooling_roundtrip(jax_refs, tmp_path):  # noqa: F811
    _generic_roundtrip(jax_refs, "cnn", 1e-4, tmp_path)


def test_elementwise_zoo_roundtrip(jax_refs, tmp_path):  # noqa: F811
    """Broadcasting, reductions, selects, comparisons, powers, log1p."""
    _generic_roundtrip(jax_refs, "ew", 1e-5, tmp_path)


@pytest.mark.slow
def test_full_model_generic_export(tmp_path, jax_refs):  # noqa: F811
    """tests/test_generic_onnx.py's whole-model case: the trainable model at
    256x320 on two golden frames, its file run by tools/onnx_check.py in a
    fresh process, against JAX's ``model.apply`` within 2e-4."""
    from yolofastest_torch.models import build_model, load_variables, zoo_path

    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    imgs = (fx["pre_imgs"][:2].astype(np.float32)[..., None] - 128.0) / 255.0
    model = build_model(3, 3, variables=load_variables(zoo_path("256x320"))).eval()
    path = export_torch_onnx(model, (torch.from_numpy(imgs),), str(tmp_path / "yolo.onnx"))
    np.save(tmp_path / "in.npy", imgs)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "onnx_check.py"), path,
                        str(tmp_path / "in.npy"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "ONNX_CONSUMED_OK" in r.stdout
    res = np.load(tmp_path / "out.npz")
    got = [res[k] for k in sorted(res.files)]
    for g, w in zip(got, jax_refs["programs/heads/model_256x320"]):
        np.testing.assert_allclose(g, w, atol=2e-4)


def test_unsupported_op_fails_loud(tmp_path):
    with pytest.raises(NotImplementedError, match="cumsum"):
        export_torch_onnx(lambda x: torch.cumsum(x, 0), (torch.zeros(4, 3),),
                          str(tmp_path / "bad.onnx"))


_BIG = torch.tensor([2 ** 31 - 1], dtype=torch.int32)
_SMALL = torch.tensor([1, 2, 3], dtype=torch.int64)


@pytest.mark.parametrize("case,fn,x,match", [
    ("input", lambda x: x.to(torch.float32), torch.zeros(4, dtype=torch.int32), "float32 inputs"),
    ("output", lambda x: x.to(torch.int32), torch.zeros(4), "float32 outputs"),
    ("constant", lambda x: (x.to(torch.int32) + _BIG).to(torch.float32), torch.zeros(1),
     "not exactly"),
    ("exact_constant", lambda x: x + _SMALL.to(torch.float32), torch.zeros(3), None)],
    ids=["input", "output", "constant", "exact_constant"])
def test_non_f32_io_and_consts_fail_loud(tmp_path, case, fn, x, match):
    """The graph carries float32 tensors only: an int input or output and a
    captured constant that float32 does not hold raise; an exactly
    representable int constant still exports (and runs)."""
    path = str(tmp_path / f"{case}.onnx")
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            export_torch_onnx(fn, (x,), path)
        return
    export_torch_onnx(fn, (x,), path)
    (got,), _ = _run_onnx(path, [x.numpy()])
    np.testing.assert_array_equal(got, [1.0, 2.0, 3.0])


# ------------------------ read from the exports' process (last: it needs the longest)
def test_exported_graphs_record_the_kernels(outputs):
    """The folded forward records each res chain as one operator node and
    the detect pipeline its NMS as one more, in the loaded programs; the int8
    graph runs its chains layer by layer and holds none."""
    targets = outputs[1]
    rows, nms = "yolofastest.res_chain_rows.default", "yolofastest.nms_packed.default"
    assert targets["forward_fastest"] == [rows] * 6
    assert targets["forward_lite"] == [rows] * 6
    assert targets["detect"] == [rows] * 6 + [nms]
    assert targets["forward_int8"] == []


@pytest.mark.parametrize("arch", list(ZOOS))
def test_forward_pt2_matches_jax(outputs, jax_refs, arch):  # noqa: F811
    """forward.pt2 of the folded graph (both architectures), loaded back,
    against the port's ``folded_apply`` within tests/test_export.py's 1e-5
    (the same arithmetic: equal bits here), and against JAX's within
    tests/test_torch_graph.py's 1e-4 for the folded forward (fp32 sums in
    another order: up to 1.9e-5 apart on these frames)."""
    arrays = outputs[0]
    got, ours = _heads(arrays, f"forward_{arch}"), _heads(arrays, f"folded_{arch}")
    want = jax_refs[f"programs/heads/folded_{arch}"]
    assert len(got) == len(ours) == len(want) == (2 if arch == "fastest" else 1)
    for g, o, w in zip(got, ours, want):
        np.testing.assert_allclose(g, o, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_detect_pt2_matches_jax(outputs, jax_refs):  # noqa: F811
    """detect.pt2 (the folded graph, the chain and NMS operators), loaded
    back, against JAX's exported detect pipeline (``model.apply``) on the 20
    frames: equal counts and classes, boxes within 1 px, conf within 1e-4; a
    batch of another size is refused (the batch is fixed at export time)."""
    arrays, targets = outputs
    ours = {k.split("/")[1]: v for k, v in arrays.items() if k.startswith("detect/")}
    theirs = jax_refs["programs/detect"]
    assert sorted(ours) == sorted(theirs)
    np.testing.assert_array_equal(ours["count"], theirs["count"])
    np.testing.assert_array_equal(ours["valid"], theirs["valid"])
    assert ours["count"].sum() >= 10 and (ours["count"] > 1).any()
    for b in range(len(ours["count"])):
        n = int(theirs["count"][b])
        np.testing.assert_array_equal(ours["cls_idx"][b, :n], theirs["cls_idx"][b, :n])
        np.testing.assert_allclose(ours["boxes"][b, :n], theirs["boxes"][b, :n], atol=1.0)
        np.testing.assert_allclose(ours["conf"][b, :n], theirs["conf"][b, :n], atol=1e-4)
    assert targets["detect_short_batch"] != "accepted"


def test_int8_pt2_matches_jax(outputs, jax_refs):  # noqa: F811
    """forward_int8.pt2 (the port's calibration on the frames), loaded back,
    against JAX's ``export_int8_forward`` with the same scales: heads equal
    bit for bit (tests/test_torch_quant.py::test_executor_heads_match_jax's
    rule)."""
    got = _heads(outputs[0], "forward_int8")
    want = jax_refs["programs/int8"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_detect_pt2_in_a_fresh_process(programs, outputs):
    """A process that imports only ``yolofastest_torch.kernels`` (the
    operators) and no model module loads detect.pt2 and gets the rows that
    the exporter's process gets from ``load_exported``."""
    arrays, targets = outputs
    assert targets["consumer_rc"] == 0, targets["consumer_stderr"]
    with open(os.path.join(programs, "consumer.json")) as f:
        assert json.load(f)["model_modules"] == []
    theirs = np.load(os.path.join(programs, "consumer.npz"))
    ours = {k.split("/")[1]: v for k, v in arrays.items() if k.startswith("detect/")}
    assert sorted(theirs.files) == sorted(ours)
    for k, v in ours.items():
        np.testing.assert_array_equal(theirs[k], v, err_msg=k)


@pytest.mark.parametrize("source", ["model", "folded"])
def test_full_model_generic_export_64x96(programs, jax_refs, source):  # noqa: F811
    """The trainable model in eval mode (BatchNorm as a scale and shift) and
    the folded forward (its six chains the chain operator, inlined through
    the plain version) export with no per-architecture walk and give JAX's
    ``model.apply`` heads within 2e-4 through tools/onnx_check.py."""
    got, ops = _run_onnx(os.path.join(programs, f"{source}.onnx"), [net_input(FORWARD_BATCH)])
    assert ops <= ONNX_CHECK_OPS and "ConvTranspose" in ops
    want = jax_refs["programs/heads/model"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-4)
