"""The port's quantisation tools (``yolofastest_torch.quant.sensitivity``'s
sweep, ``quant/qat.py``, the int8 export writers, ``models/summary.py`` and
the ``export --calib-data/--qat-steps``, ``sensitivity`` and ``prune``
commands), on the CPU, held against the JAX package from the same numpy
inputs.

The models are the fastest and lite zoo weights at a 64x96 input (two
inputs from a seed), with the port's amax scales of those inputs handed to
both packages.  What is held, and how closely:

* the flagged applies: with every flag int8, both bit for bit against JAX's
  jitted ones (scales constants, as the JAX sweep jits them); with fp
  layers, the per-layer apply within the tolerance held for the per-layer
  mixed graph (every head value within 0.5, the mean within 1e-3, 99%
  within 0.05), because a kept fp layer is a float32 convolution summed in
  another order than XLA's.  The fused apply carries each fp layer's output
  on as int8, so an ulp of that convolution that crosses a rounding edge
  moves one int8 value by one step and the step travels: it is held layer
  by layer from JAX's own int8 input to each layer, equal to JAX's output
  but for values within 1e-4 of a step of a rounding edge, which differ
  by one step (the count is asserted small); where no value lands there,
  its heads equal JAX's bit for bit;
* the sweep's table (lite): the same layers, each row's mean and max within
  the per-layer tolerance above, the order equal wherever neighbouring rows
  differ by more than twice it;
* fake quantisation: ``fake_quant_act``/``fake_quant_weight`` values and
  gradients bit for bit against JAX jitted with the scale a constant (the
  QAT step's form), the gradient 0.5 at the +-127 ties; ``qat_apply``
  heads in fp32 within the per-layer tolerance; one fp32 step with labels,
  its loss within 1e-5 and its gradient per leaf;
* QAT in float64 (x64 JAX with its ``float32`` casts pointed at float64):
  each of three distillation steps, from JAX's own state, gives JAX's
  parameters, Adam moments and loss within 1e-9 per leaf; the label mode is
  held in the fp32 step.  Whole
  runs agree for one step only: the fake-quant gradient of a channel's
  largest weight is 0, 0.5 or 1 as ``amax * (1 / 127)`` lands an ulp above,
  on or below it, so weights an ulp apart (two summation orders) take
  different branches from the second step on;
* the writers: ``model_int8.onnx`` (the producer name aside),
  ``model.table`` and the scaled ``model_int8.yfb`` byte for byte against
  the JAX writers on the same inputs (JAX's ``quantize_weights`` of the
  shipped int8 artifact, whose scales JAX's calibration made);
* ``summarize``/``format_summary`` equal; the ``prune`` command's output
  and file equal; the ``sensitivity`` command's table and JSON within the
  sweep's tolerance, with the same cache; ``export --calib-data
  --qat-steps``'s files against the writers and its own calibration.

The JAX references that compile run in the workers of ``tests/_jax_refs.py``.
The heavy comparisons are marked ``slow``: the two QAT step comparisons
(JAX's step traced and compiled, ~15 s of a worker each) and the flagged
comparison (two dual graphs an arch, ~35 s of a worker's CPU each; the
per-layer dual executor is held against JAX's in every run through the
sweep and the ``sensitivity`` command, the flagged applies against the
port's static graphs bit for bit).  ``pytest -m slow
tests/test_torch_quant_tools.py`` runs them, and only their references.
"""

import atexit
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import shutil
import tempfile
import types

import numpy as np
import pytest
import torch

from tests._background import port_exports  # noqa: F401 (a fixture)
from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from yolofastest_torch.models import FoldedExecutor, fold_batchnorm, load_variables, zoo_path
from yolofastest_torch.quant import (calibrate, fake_quant_act, fake_quant_weight,
                                     layer_sensitivity, load_int8_zoo, qat_apply, qat_finetune,
                                     quantize_weights, quantized_apply_flagged,
                                     quantized_apply_fused_flagged)
from yolofastest_torch.quant import qat as tqat
from yolofastest_torch.quant import sensitivity as tsens
from yolofastest_torch.quant.ptq import QuantParams, _Q

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = {"fastest": "256x320", "lite": "lite_256x320"}
FLAG_SETS = ("int8", "fp", "mixed")
# the tolerance of the per-layer mixed graph (test_torch_quant.py)
MIXED_MAX, MIXED_MEAN, MIXED_SHARE = 0.5, 1e-3, 0.99
EDGE = 1e-4  # of a quantisation step: an fp layer's ulps near a rounding edge
FLOAT64_TOL = 1e-9  # relative L2 a leaf, as tests/test_torch_train.py
QAT_LR = 1e-4
LABEL_ANCHORS = [[(12.0, 18.0), (37.0, 49.0), (52.0, 132.0)]]
cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("jax_refs")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small (64x96), so
    one thread computes them about as fast as four and leaves the cores to
    the JAX reference workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the cases
def small_case(arch):
    """(folded, x): the arch's zoo weights and two 64x96 inputs from a seed."""
    folded = fold_batchnorm(load_variables(zoo_path(ZOO[arch])))
    x = (np.random.default_rng(0).standard_normal((2, 64, 96, 1)) * 0.3).astype(np.float32)
    return folded, x


_SCALES = {}


def small_scales(arch):
    """The port's amax scales of :func:`small_case` (the JAX worker is handed
    them)."""
    if arch not in _SCALES:
        folded, x = small_case(arch)
        _SCALES[arch] = calibrate(folded, [x], arch=arch, device="cpu")
    return dict(_SCALES[arch])


def flag_set(names, which):
    """int8: every layer int8; fp: none; mixed: every third layer fp."""
    return {n: {"int8": True, "fp": False, "mixed": i % 3 != 0}[which]
            for i, n in enumerate(names)}


def label_targets():
    t = np.zeros((2, 8, 6), np.float32)
    t[:, 0] = [0.5, 0.5, 0.3, 0.3, 1, 255]  # one centred box of class 1
    t[1, 1] = [0.2, 0.7, 0.2, 0.4, 2, 255]
    return t


def _flat_tree(tree, prefix=""):
    """A nested dict of arrays as ``{"layer/leaf": float64 array}``, keys sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ------------------------------------------------------------ JAX references
def _jax_flagged(arch, scales):
    """JAX's flagged applies jitted as its sweep jits them (weights and
    scales constants, the flags an argument), for each flag set: the
    per-layer heads, the fused heads, and each fused layer's int8 input and
    output (with the layer's walk arguments)."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.models.graph import walk_topology, walk_topology_lite
    from yolofastest_tpu.quant import quantize_weights as jquant
    from yolofastest_tpu.quant import sensitivity as js

    folded, x = small_case(arch)
    qp = jquant(folded)
    names = sorted(qp)
    walk = walk_topology if arch == "fastest" else walk_topology_lite
    meta = []

    class Recording(js._DualFusedExecutor):
        def __init__(self, *a):
            super().__init__(*a)
            self.rec = []

        def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
            y = super().conv(x, name, kernel, stride, depthwise, act)
            self.rec.append((name, ("conv", kernel, stride, depthwise, act), x, y.q))
            return y

        def deconv2x(self, x, name):
            y = super().deconv2x(x, name)
            self.rec.append((name, ("deconv",), x, y.q))
            return y

        def head(self, x, name):
            y = super().head(x, name)
            self.rec.append((name, ("head",), x, y))
            return y

    def as_tuple(h):
        return tuple(h) if isinstance(h, (tuple, list)) else (h,)

    def flags_of(fv):
        return {n: fv[i] for i, n in enumerate(names)}

    def layer(fv, xx):
        return as_tuple(js.quantized_apply_flagged(qp, folded, scales, xx, flags_of(fv),
                                                   arch=arch))

    def fused(fv, xx):
        ex = Recording(qp, folded, scales, flags_of(fv))
        heads = walk(ex.quantize_input(xx), ex)
        meta[:] = [(r[0], r[1], r[2].s) for r in ex.rec]
        return as_tuple(heads), [r[2].q for r in ex.rec], [r[3] for r in ex.rec]

    layer, fused = jax.jit(layer), jax.jit(fused)
    out = {}
    for which in FLAG_SETS:
        fv = jnp.asarray(np.array([flag_set(names, which)[n] for n in names]))
        out[which] = jax.tree.map(np.asarray, (layer(fv, jnp.asarray(x)),
                                               *fused(fv, jnp.asarray(x))))
    return out, list(meta)


def _jax_sensitivity(inp):
    """JAX's ``sensitivity`` command on :func:`cli_inputs` (the lite zoo at
    64x96, whose cache holds :func:`small_scales` of lite): its exit code
    and output; its table lands in ``jax.json`` there."""
    from yolofastest_tpu.cli import main as jmain

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = jmain(sensitivity_argv(inp, "jax"))
    return rc, printed.getvalue()


# The two dual graphs of one arch take ~35 s of a worker's CPU to compile:
# the flagged comparison is ``slow``, one reference an arch.
register("quant_tools/flagged_fastest", _jax_flagged,
         lambda: ("fastest", small_scales("fastest")),
         tests=("test_flagged_applies_match_jax[fastest",))
register("quant_tools/flagged_lite", _jax_flagged, lambda: ("lite", small_scales("lite")),
         tests=("test_flagged_applies_match_jax[lite",))
register("quant_tools/cli_sensitivity", _jax_sensitivity, lambda: (cli_inputs(),),
         tests=("test_layer_sensitivity_matches_jax", "test_cli_sensitivity_matches_jax"))


def _jax_qat(float64, scales):
    """JAX's QAT step on the lite case, captured from ``qat_finetune``
    (``jax.jit`` observed while it builds it) and driven from a fresh optax
    state: the states before and after each step.  float32: one step with
    labels.  float64 (x64, the module's ``float32`` pointed at float64):
    three distillation steps with ``conf_weight`` 2."""
    import importlib

    import jax
    import jax.numpy as jnp
    import optax

    jq = importlib.import_module("yolofastest_tpu.quant.qat")
    folded, x = small_case("lite")
    dt = jnp.float64 if float64 else jnp.float32
    saved = jq.jnp
    if float64:
        f64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                       if not k.startswith("__")})
        f64.float32 = jnp.float64
        jq.jnp = f64

    def states(n, **kw):
        """n steps of the captured step from optax.adam's fresh state."""
        captured, real_jit = [], jax.jit

        def spy(fn, *a, **k):
            captured.append(real_jit(fn, *a, **k))
            return captured[-1]

        jax.jit = spy
        try:
            jq.qat_finetune(folded, scales, [x], arch="lite", steps=0, lr=QAT_LR, **kw)
        finally:
            jax.jit = real_jit
        step = captured[-1]
        if "targets" in kw:
            ref = jnp.asarray(kw["targets"][0])
        else:
            ref = jax.device_get(captured[0](jnp.asarray(x)))
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), dict(folded))
        s = optax.adam(QAT_LR).init(p)
        xs = jnp.asarray(x, dt)
        seq, losses = [], []
        for i in range(n + 1):
            seq.append({"params": _flat_tree(jax.device_get(p)),
                        "mu": _flat_tree(jax.device_get(s[0].mu)),
                        "nu": _flat_tree(jax.device_get(s[0].nu)), "count": int(s[0].count)})
            if i < n:
                p, s, loss = step(p, s, xs, ref)
                losses.append(float(loss))
        return {"states": seq, "losses": losses}

    try:
        with jax.enable_x64(float64):
            if float64:
                return {"distill": states(3, conf_weight=2.0)}
            return {"labels": states(1, targets=[label_targets()], anchors=LABEL_ANCHORS,
                                     input_hw=(64, 96))}
    finally:
        jq.jnp = saved


def fake_quant_inputs(scales):
    """(x, s, weight kernel, cotangents): activations at a layer's scale
    with values on +-127 s and beyond, a kernel with a channel whose two
    largest entries tie at +-amax and an all-zero channel."""
    rng = np.random.default_rng(3)
    s = np.float32(scales["conv1_2"])
    x = (rng.standard_normal(4096) * 60 * s).astype(np.float32)
    x[:4] = [np.float32(127) * s, np.float32(-127) * s, 200 * s, -200 * s]
    k = rng.normal(0, 0.1, (3, 3, 8, 16)).astype(np.float32)
    k[0, 0, 0, 3], k[1, 1, 1, 3] = 0.4, -0.4
    k[..., 7] = 0.0
    return x, float(s), k, rng.standard_normal(4096).astype(np.float32), rng.standard_normal(
        k.shape).astype(np.float32)


def _jax_fake_quant(scales):
    """JAX's fake-quant functions on :func:`fake_quant_inputs` (values and
    gradients, jitted with the scale a constant) and ``qat_apply``'s heads
    on the lite case."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.quant.qat import fake_quant_act as jact
    from yolofastest_tpu.quant.qat import fake_quant_weight as jweight
    from yolofastest_tpu.quant.qat import qat_apply as japply

    x, s, k, cx, ck = fake_quant_inputs(scales)
    act = jax.jit(jax.value_and_grad(lambda v, c: jnp.sum(jact(v, s) * c)))
    wgt = jax.jit(jax.value_and_grad(lambda v, c: jnp.sum(jweight(v) * c)))
    folded, xb = small_case("lite")
    heads = jax.jit(lambda p, xx: japply(p, scales, xx, "lite"))(
        jax.tree_util.tree_map(jnp.asarray, dict(folded)), jnp.asarray(xb))
    return {"act": (np.asarray(jax.jit(lambda v: jact(v, s))(x)), np.asarray(act(x, cx)[1])),
            "weight": (np.asarray(jax.jit(jweight)(k)), np.asarray(wgt(k, ck)[1])),
            "heads": np.asarray(heads)}


register("quant_tools/fake_quant", _jax_fake_quant, lambda: (small_scales("lite"),),
         tests=("test_fake_quant_matches_jax", "test_qat_apply_heads_match_jax"))
# the QAT steps are the heavy comparisons (a step's trace and compile: ~15 s
# a worker), run by ``-m slow``
register("quant_tools/qat_fp32", _jax_qat, lambda: (False, small_scales("lite")),
         tests=("test_qat_step_fp32_matches_jax",))
register("quant_tools/qat_float64", _jax_qat, lambda: (True, small_scales("lite")),
         tests=("test_qat_steps_float64_match_jax",))


_CLI = {}


def cli_inputs():
    """Made once per process, in a temporary directory removed at exit: a
    64x96 lite config (JSON), two 64x96 images from a seed, and a
    calibration cache holding :func:`small_scales` of lite."""
    from yolofastest_torch.configs import get_config

    if not _CLI:
        root = tempfile.mkdtemp(prefix="yf_torch_quant_tools_")
        atexit.register(shutil.rmtree, root, True)
        cfg = get_config("lite-256x320")
        cfg = dataclasses.replace(cfg, io=dataclasses.replace(cfg.io, input_shape=(64, 96, 1)))
        cfgj = os.path.join(root, "tiny.json")
        with open(cfgj, "w") as f:
            f.write(cfg.to_json())
        data = os.path.join(root, "data")
        os.makedirs(data)
        rng = np.random.default_rng(0)
        for i in range(2):
            cv2.imwrite(os.path.join(data, f"im{i}.jpg"), rng.integers(0, 255, (64, 96, 3),
                                                                          np.uint8))
        cache = os.path.join(root, "lite.calib.json")
        with open(cache, "w") as f:
            json.dump(small_scales("lite"), f)
        _CLI.update(root=root, cfg=cfgj, data=data, cache=cache)
    return dict(_CLI)


def sensitivity_argv(inp, side):
    return ["sensitivity", "--config-json", inp["cfg"], "--arch", "lite", "--weights",
            zoo_path("lite_256x320"), "--data", inp["data"], "--images", "1", "--top", "3",
            "--calibration-cache", inp["cache"], "--json-out",
            os.path.join(inp["root"], f"{side}.json")]


# ------------------------------------------------- tests without JAX references
# (first, so that the workers' references are ready when the tests below ask)
def _qat_run(dtype, **kw):
    folded, x = small_case("lite")
    return tqat.QatRun(folded, small_scales("lite"), [x], arch="lite", anchors=kw.get(
        "anchors"), input_hw=kw.get("input_hw"), targets=kw.get("targets"), num_cls=3,
        lr=QAT_LR, conf_weight=kw.get("conf_weight", 1.0), device="cpu", dtype=dtype)


def _state_tensor(run, leaves):
    return torch.cat([torch.from_numpy(leaves[k]).reshape(-1) for k in run.layout.names]
                     ).to(run.dtype)


def test_qat_finetune_contract(monkeypatch):
    """JAX's contract: the history of every step, the lowest-loss iterate
    returned (the parameters the step of the lowest loss starts from),
    ``snapshot_every`` = K snapshots of the parameters after every K-th
    step, the 2-tuple without it, label mode, and JAX's three ValueErrors
    with its messages; the distillation teacher's chains go to the fp chain
    function (6 calls a teacher batch), the student's never."""
    from yolofastest_tpu.quant import qat_finetune as jqat

    folded, x = small_case("lite")
    scales = small_scales("lite")
    calls = []
    chain = FoldedExecutor.chain_fn

    def spy(*a):
        calls.append(a[0].shape)
        return chain(*a)

    monkeypatch.setattr(FoldedExecutor, "chain_fn", staticmethod(spy))
    batches = [x, x[::-1].copy()]
    tuned, hist, snaps = qat_finetune(folded, scales, batches, arch="lite", steps=3, lr=3e-4,
                                      conf_weight=4.0, snapshot_every=1, device="cpu")
    assert len(calls) == 12  # 6 chains for each of the two teacher batches
    assert len(hist) == 3 and np.all(np.isfinite(hist)) and len(snaps) == 3
    run = _qat_run(torch.float32)
    starts = [run.theta0] + [_state_tensor(run, _flat_tree(s)) for s in snaps[:-1]]
    assert torch.equal(_state_tensor(run, _flat_tree(tuned)), starts[int(np.argmin(hist))])
    every2 = qat_finetune(folded, scales, batches, arch="lite", steps=2, lr=3e-4,
                          conf_weight=4.0, snapshot_every=2, device="cpu")
    assert every2[1] == hist[:2] and len(every2[2]) == 1
    got, want = _flat_tree(every2[2][0]), _flat_tree(snaps[1])
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    out = qat_finetune(folded, scales, [x], arch="lite", steps=2, lr=3e-4, device="cpu",
                       targets=[label_targets()], anchors=LABEL_ANCHORS, input_hw=(64, 96))
    assert len(out) == 2 and np.all(np.isfinite(out[1]))
    cases = [({}, {}, [], {}),
             ({}, {}, [np.zeros((1, 8, 8, 1))], {"targets": [np.zeros((1, 8, 6))]}),
             ({}, {}, [np.zeros((1, 8, 8, 1))] * 2, {"targets": [np.zeros((1, 8, 6))],
                                                    "anchors": [[(1, 1)]], "input_hw": (8, 8)})]
    for f, s, b, kw in cases:
        with pytest.raises(ValueError) as want:
            jqat(f, s, b, **kw)
        with pytest.raises(ValueError) as got:
            qat_finetune(f, s, b, device="cpu", **kw)
        assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- writers
def _onnx_as_jax(data: bytes) -> bytes:
    """The port's ONNX bytes with the producer name (ModelProto field 2) put
    back to the JAX writer's; nothing else may differ."""
    ours, theirs = b"\x12\x11yolofastest_torch", b"\x12\x0fyolofastest_tpu"
    assert data.count(ours) == 1
    return data.replace(ours, theirs)


WRITER_CASES = {"fastest": ("256x320", "yolofastest"), "lite": (None, "yolofastest-lite")}


@pytest.mark.parametrize("fmt", ["onnx", "table", "yfb"])
@pytest.mark.parametrize("case", list(WRITER_CASES))
def test_int8_writers_byte_equal_jax(case, fmt, tmp_path):
    """``export_onnx_qdq``, ``export_ncnn_table`` and ``save_native_weights``
    with scales, each against its JAX writer on JAX's ``quantize_weights``
    of the same weights and the same scales (the shipped 256x320 int8
    artifact's tree and scales, made by JAX's tools; lite: its zoo at
    256x320 with the port's scales of two 64x96 inputs): byte for byte,
    ONNX's producer name aside; the table refuses a layer without scales."""
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.export import export_ncnn_table, export_onnx_qdq, save_native_weights
    from yolofastest_tpu.export import export_ncnn_table as jtable
    from yolofastest_tpu.export import export_onnx_qdq as jqdq
    from yolofastest_tpu.export import save_native_weights as jsave
    from yolofastest_tpu.quant import quantize_weights as jquant

    artifact, graph = WRITER_CASES[case]
    if artifact:
        folded, scales, _ = load_int8_zoo(os.path.join(ROOT, "weights",
                                                        f"yolofastest_int8_{artifact}.npz"))
        cfg = get_config("256x320")
    else:
        folded, scales = small_case("lite")[0], small_scales("lite")
        cfg = get_config("lite-256x320")
    q, ours_q = jquant(folded), quantize_weights(folded)
    for name in q:
        for leaf in q[name]:
            np.testing.assert_array_equal(ours_q[name][leaf], q[name][leaf])
    write = {"onnx": (lambda f, path: f(q, scales, cfg.io.input_hw, path, arch=graph),
                      export_onnx_qdq, jqdq),
             "table": (lambda f, path: f(q, scales, path, arch=graph), export_ncnn_table, jtable),
             "yfb": (lambda f, path: f(q, path, act_scales=scales, io_config=cfg.io),
                     save_native_weights, jsave)}[fmt]
    call, ours, theirs = write
    call(ours, str(tmp_path / f"port.{fmt}"))
    call(theirs, str(tmp_path / f"jax.{fmt}"))
    got = (tmp_path / f"port.{fmt}").read_bytes()
    assert (_onnx_as_jax(got) if fmt == "onnx" else got) == (tmp_path / f"jax.{fmt}").read_bytes()
    if fmt == "table":
        with pytest.raises(ValueError, match="missing int8 scales for layer 'conv0'"):
            export_ncnn_table(q, {}, str(tmp_path / "x.table"), arch=graph)


# --------------------------------------------------------- summary, commands
@pytest.mark.parametrize("tree", ["256x320", "lite_256x320", "pruned"])
def test_summary_matches_jax(tree):
    from yolofastest_torch.models.prune import prune_variables
    from yolofastest_torch.models.summary import format_summary, summarize
    from yolofastest_tpu.models.summary import format_summary as jformat
    from yolofastest_tpu.models.summary import summarize as jsummarize

    variables = load_variables(zoo_path("256x320" if tree == "pruned" else tree))
    if tree == "pruned":
        variables = prune_variables(variables, 0.4)[0]
    folded = fold_batchnorm(variables)
    graph = "yolofastest-lite" if tree.startswith("lite") else "yolofastest"
    for hw in ((256, 320), (64, 96)):
        ours, theirs = summarize(folded, hw, graph), jsummarize(folded, hw, graph)
        assert ours == theirs
        assert format_summary(ours) == jformat(theirs)
    if tree == "256x320":
        assert ours["total_params"] == 325_800
        assert summarize(folded, (256, 320))["total_macs"] == 118_221_440


PRUNE_ARGS = {"fastest": ["--ratio", "0.5"],
              "lite": ["--ratio", "0.3", "--min-keep", "8", "--round-to", "8", "--arch", "lite",
                       "--config", "lite-256x320"]}


@pytest.mark.parametrize("case", list(PRUNE_ARGS))
def test_cli_prune_matches_jax(case, tmp_path, capsys):
    """``prune`` prints what the JAX command prints and writes the same .npz
    (the 256x320 zoo at ratio 0.5; the lite zoo with every flag set)."""
    from yolofastest_torch.cli import main
    from yolofastest_tpu.cli import main as jmain

    zoo = zoo_path("lite_256x320" if case == "lite" else "256x320")
    outs = {}
    for side, fn in (("port", main), ("jax", jmain)):
        assert fn(["prune", "--weights", zoo, "--out", str(tmp_path / f"{side}.npz")]
                  + PRUNE_ARGS[case]) == 0
        outs[side] = capsys.readouterr().out
    assert outs["port"].replace("port.npz", "jax.npz") == outs["jax"]
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files and all(np.array_equal(a[n], b[n]) for n in a.files)


def test_cli_export_int8_files(tmp_path, port_exports):  # noqa: F811
    """``export --calib-data D --qat-steps 2 --device cpu`` (the tiny lite
    config, two images from a seed; the command run by
    ``tests/_background.py`` with one torch thread, and the references
    here with one): JAX's file list with its programs as .pt2 and their
    StableHLO text (none for the int8 program, as in JAX), the int8
    program written last; ``model_int8.yfb`` carries
    the command's own calibration of D and the QAT-refined weights,
    ``model_int8.onnx`` is the QDQ writer's file of those, and
    ``model.table`` is made from the fp weights with the same scales, each
    byte-equal to the JAX writer on the same inputs; ``model.yfb`` and the
    ncnn pair keep the fp weights."""
    from yolofastest_torch.cli._common import load_calibration
    from yolofastest_torch.configs import Config
    from yolofastest_tpu.export import export_ncnn_table as jtable
    from yolofastest_tpu.export import export_onnx_qdq as jqdq
    from yolofastest_tpu.export import save_native_weights as jsave
    from yolofastest_tpu.quant import quantize_weights as jquant

    rc, stdout, error = port_exports.command("qat")
    assert rc == 0, error
    argv = port_exports.argvs["qat"]
    inp = {k: argv[argv.index(flag) + 1] for k, flag in (("cfg", "--config-json"),
                                                         ("data", "--calib-data"))}
    out = pathlib.Path(argv[argv.index("--out") + 1])
    printed = stdout.splitlines()
    assert sorted(os.listdir(out)) == sorted(
        ["model.yfb", "model_int8.yfb", "model.onnx", "detect.onnx", "model.param", "model.bin",
         "model.prototxt", "model.caffemodel", "model_int8.onnx", "model.table", "model.pt",
         "forward.pt2", "detect.pt2", "forward_int8.pt2", "forward.mlir", "detect.mlir"])
    assert printed[0].startswith("QAT distillation: loss ") and "(best of 2 steps)" in printed[0]
    assert printed[-1] == f"wrote {out / 'forward_int8.pt2'}"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with open(inp["cfg"]) as f:
            cfg = Config.from_json(f.read())
        folded = fold_batchnorm(load_variables(zoo_path("lite_256x320")))
        cal = load_calibration(inp["data"], cfg.io)
        scales = calibrate(folded, [cal], arch="lite", device="cpu")
        tuned, hist = qat_finetune(folded, scales, [cal], arch="lite", steps=2, lr=1e-4,
                                   device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert printed[0] == "QAT distillation: loss %.3e -> %.3e (best of 2 steps)" % (
        hist[0], min(hist))
    jsave(jquant(tuned), str(tmp_path / "jax.yfb"), act_scales=scales, io_config=cfg.io)
    jqdq(jquant(tuned), scales, cfg.io.input_hw, str(tmp_path / "jax.onnx"),
         arch="yolofastest-lite")
    jtable(jquant(folded), scales, str(tmp_path / "jax.table"), arch="yolofastest-lite")
    assert (out / "model_int8.yfb").read_bytes() == (tmp_path / "jax.yfb").read_bytes()
    assert _onnx_as_jax((out / "model_int8.onnx").read_bytes()) == (
        tmp_path / "jax.onnx").read_bytes()
    assert (out / "model.table").read_bytes() == (tmp_path / "jax.table").read_bytes()


def test_flagged_endpoints_are_the_static_graphs(monkeypatch):
    """The flagged applies at all-fp / all-int8 equal the port's own fp and
    int8 graphs bit for bit, and the fused one equals the mixed fused graph
    keeping the same layers; no chain is handed to the fp executor."""
    from yolofastest_torch.quant import (quantized_apply, quantized_apply_fused,
                                         quantized_apply_fused_mixed, quantized_apply_mixed)

    monkeypatch.setattr(FoldedExecutor, "chain_fn", None)  # a whole chain would fail
    folded, x = small_case("fastest")
    scales = small_scales("fastest")
    q = quantize_weights(folded)
    names = sorted(q)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        for which, kept in (("int8", ()), ("mixed", tuple(n for n, f in flag_set(
                names, "mixed").items() if not f))):
            flags = flag_set(names, which)
            pairs = ((quantized_apply_flagged(q, folded, scales, xt, flags),
                      quantized_apply_mixed(q, folded, scales, xt, fp_layers=kept)
                      if kept else quantized_apply(q, scales, xt)),
                     (quantized_apply_fused_flagged(q, folded, scales, xt, flags),
                      quantized_apply_fused_mixed(q, folded, scales, xt, fp_layers=kept)
                      if kept else quantized_apply_fused(q, scales, xt)))
            for got, want in pairs:
                for g, w in zip(got, want):
                    assert torch.equal(g, w), which


# ------------------------------------------------------------ flagged applies
def _heads_tuple(h):
    return h if isinstance(h, tuple) else (h,)


def _assert_mixed_tolerance(ours, theirs):
    d = np.concatenate([np.abs(o.numpy() - t).ravel() for o, t in zip(ours, theirs)])
    assert d.max() <= MIXED_MAX and d.mean() <= MIXED_MEAN and np.mean(d <= 0.05) >= MIXED_SHARE, (
        d.max(), d.mean(), np.mean(d > 0.05))


def _fused_layer_by_layer(arch, flags, meta, xq_in, outs):
    """Each recorded fused layer of JAX's graph, run by the port's dual fused
    executor from JAX's int8 input: (values off JAX's, of which within
    ``EDGE`` of a rounding edge)."""
    folded, _ = small_case(arch)
    scales = small_scales(arch)
    ex = tsens._DualFusedExecutor(QuantParams(quantize_weights(folded), "cpu"),
                                  tsens.fp_params(folded, tuple(folded), "cpu"), scales,
                                  tsens._device_flags(flags, "cpu"))
    off = near_edge = 0
    for (name, op, s_in), q_in, want in zip(meta, xq_in, outs):
        x = _Q(torch.from_numpy(q_in.astype(np.float32)), s_in)
        with torch.inference_mode():
            if op[0] == "head":
                got = ex.head(x, name).numpy()
                assert np.allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max()), name
                continue
            y = (ex.conv(x, name, *op[1:]) if op[0] == "conv" else ex.deconv2x(x, name)).q.numpy()
        bad = y != want.astype(np.float32)
        if not bad.any():
            continue
        assert not flags[name], f"int8 layer {name} differs from JAX's"
        fp_in = ex._q.deq(x)
        yf = (ex._fp.conv(fp_in, name, *op[1:]) if op[0] == "conv"
              else ex._fp.deconv2x(fp_in, name))
        v = (yf * ex._q.p.inverse(scales[f"out/{name}"])).numpy()[bad]
        assert np.all(np.abs(y[bad] - want[bad]) == 1), name
        off += int(bad.sum())
        near_edge += int(np.sum(np.abs(np.abs(v - np.floor(v)) - 0.5) <= EDGE))
    return off, near_edge


@pytest.mark.slow
@pytest.mark.parametrize("which", FLAG_SETS)
@pytest.mark.parametrize("arch", list(ZOO))
def test_flagged_applies_match_jax(jax_refs, arch, which):  # noqa: F811
    """Both flagged applies against JAX's (module docstring): all int8 bit
    for bit; fp layers in the per-layer apply within the per-layer mixed
    tolerance; the fused apply layer by layer from JAX's int8 inputs, off
    only at rounding edges, and bit for bit in its heads where no layer is
    off."""
    refs, meta = jax_refs[f"quant_tools/flagged_{arch}"][:2]
    layer_h, fused_h, xq_in, outs = refs[which]
    folded, x = small_case(arch)
    scales = small_scales(arch)
    flags = flag_set(sorted(quantize_weights(folded)), which)
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        ours = (_heads_tuple(quantized_apply_flagged(quantize_weights(folded), folded, scales,
                                                     xt, flags, arch=arch)),
                _heads_tuple(quantized_apply_fused_flagged(quantize_weights(folded), folded,
                                                           scales, xt, flags, arch=arch)))
    assert len(ours[0]) == len(layer_h) == (2 if arch == "fastest" else 1)
    if which == "int8":
        for got, want in zip(ours[0] + ours[1], layer_h + fused_h):
            np.testing.assert_array_equal(got.numpy(), want)
        return
    _assert_mixed_tolerance(ours[0], layer_h)
    assert [m[0] for m in meta].count("head_5") == 1 and len(meta) == len(xq_in)
    off, near_edge = _fused_layer_by_layer(arch, flags, meta, xq_in, outs)
    print(f"{arch}/{which}: fused int8 values off JAX's from its own inputs: {off}, "
          f"{near_edge} of them within {EDGE} of a rounding edge")
    assert near_edge == off <= 8
    if off == 0:
        for got, want in zip(ours[1], fused_h):
            np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- the sweep
def test_layer_sensitivity_matches_jax(jax_refs, monkeypatch):  # noqa: F811
    """The lite sweep's table on the ``sensitivity`` command's batch and
    scales against JAX's (the JAX command's JSON): the same layers, each
    row's mean and max within the per-layer mixed graph's tolerance, the order
    equal wherever neighbouring rows differ by more than twice it.  It hands
    no chain to the fp executor and reads the host once."""
    jax_refs["quant_tools/cli_sensitivity"]  # the JAX command has written its table
    with open(os.path.join(cli_inputs()["root"], "jax.json")) as f:
        theirs = json.load(f)
    folded = small_case("lite")[0]
    monkeypatch.setattr(FoldedExecutor, "chain_fn", None)
    reads = []
    cpu = torch.Tensor.cpu

    def counted_cpu(t, *a, **k):
        reads.append(t.shape)
        return cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    ours = sweep_table()
    monkeypatch.undo()
    assert len(reads) == 1 and reads[0] == (len(ours), 2)
    assert sorted(r["layer"] for r in ours) == sorted(r["layer"] for r in theirs) == sorted(
        quantize_weights(folded))
    by_name = {r["layer"]: r for r in theirs}
    for r in ours:
        t = by_name[r["layer"]]
        assert abs(r["mean_abs"] - t["mean_abs"]) <= MIXED_MEAN, (r, t)
        assert abs(r["max_abs"] - t["max_abs"]) <= MIXED_MAX, (r, t)
    assert [r["mean_abs"] for r in ours] == sorted((r["mean_abs"] for r in ours), reverse=True)
    _assert_order_where_separated([r["layer"] for r in ours], theirs)


_SWEEP = []


def sweep_table():
    """The port's ``layer_sensitivity`` on the ``sensitivity`` command's
    batch (its first image) and cached scales, computed once."""
    from yolofastest_torch.cli._common import load_calibration
    from yolofastest_torch.configs import Config

    if not _SWEEP:
        inp = cli_inputs()
        with open(inp["cfg"]) as f:
            io_cfg = Config.from_json(f.read()).io
        _SWEEP.append(layer_sensitivity(small_case("lite")[0],
                                        [load_calibration(inp["data"], io_cfg, k=1)],
                                        arch="lite", act_scales=small_scales("lite"),
                                        device="cpu"))
    return _SWEEP[0]


def _assert_order_where_separated(ours, theirs_rows):
    """The names in the same order wherever JAX's neighbouring rows differ
    by more than twice the mean tolerance (ties within it may swap)."""
    names = [r["layer"] for r in theirs_rows]
    means = [r["mean_abs"] for r in theirs_rows]
    cut = [0] + [i for i in range(1, len(means)) if means[i - 1] - means[i] > 2 * MIXED_MEAN]
    for a, b in zip(cut, cut[1:] + [len(names)]):
        assert sorted(ours[a:b]) == sorted(names[a:b]), (a, b)


def test_cli_sensitivity_matches_jax(jax_refs, capsys):  # noqa: F811
    """``sensitivity`` with the same cache as the JAX command: it says it
    read the cache, its table and JSON hold JAX's within the sweep's
    tolerance (order where separated) and equal the API's table on its
    batch, and its ``--keep-fp`` line is JAX's where the top rows are
    separated; without --data images it exits 2."""
    from yolofastest_torch.cli import main

    rc, printed = jax_refs["quant_tools/cli_sensitivity"]
    assert rc == 0
    inp = cli_inputs()
    assert main(sensitivity_argv(inp, "port") + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out.splitlines()
    theirs = printed.splitlines()
    assert ours[0] == theirs[0] == f"calibration scales: {inp['cache']}"
    assert ours[1] == theirs[1] and len(ours) == len(theirs)
    with open(os.path.join(inp["root"], "port.json")) as f, open(
            os.path.join(inp["root"], "jax.json")) as g:
        mine, jrows = json.load(f), json.load(g)
    assert [tuple(r) for r in mine] == [tuple(r) for r in jrows]  # the same keys in order
    assert mine == sweep_table()  # the command is the API on its batch and cached scales
    by_name = {r["layer"]: r for r in jrows}
    for r in mine:
        assert abs(r["mean_abs"] - by_name[r["layer"]]["mean_abs"]) <= MIXED_MEAN
        assert abs(r["max_abs"] - by_name[r["layer"]]["max_abs"]) <= MIXED_MAX
    _assert_order_where_separated([r["layer"] for r in mine], jrows)
    keep = [ln for ln in ours if "--keep-fp" in ln]
    jkeep = [ln for ln in theirs if "--keep-fp" in ln]
    gaps = [jrows[i]["mean_abs"] - jrows[i + 1]["mean_abs"] for i in range(3)]
    if min(gaps) > 2 * MIXED_MEAN:
        assert keep == jkeep
    assert ours[-1] == theirs[-1].replace("jax.json", "port.json")
    empty = os.path.join(inp["root"], "empty")
    os.makedirs(empty, exist_ok=True)
    argv = sensitivity_argv(inp, "port")
    argv[argv.index("--data") + 1] = empty
    assert main(argv + ["--device", "cpu"]) == 2


# -------------------------------------------------------------------- QAT
def test_fake_quant_matches_jax(jax_refs):  # noqa: F811
    """Values and gradients of both fake-quant functions bit for bit against
    JAX's jitted ones, and the gradient 0.5 on the +-127 ties (where
    ``torch.clamp`` would give 1)."""
    ref = jax_refs["quant_tools/fake_quant"]
    x, s, k, cx, ck = fake_quant_inputs(small_scales("lite"))
    xt = torch.from_numpy(x).requires_grad_(True)
    ya = fake_quant_act(xt, s)
    (ya * torch.from_numpy(cx)).sum().backward()
    np.testing.assert_array_equal(ya.detach().numpy(), ref["act"][0])
    np.testing.assert_array_equal(xt.grad.numpy(), ref["act"][1])
    assert np.array_equal(xt.grad.numpy()[:4] / cx[:4], [0.5, 0.5, 0.0, 0.0])
    kt = torch.from_numpy(k).requires_grad_(True)
    yw = fake_quant_weight(kt)
    (yw * torch.from_numpy(ck)).sum().backward()
    np.testing.assert_array_equal(yw.detach().numpy(), ref["weight"][0])
    np.testing.assert_array_equal(kt.grad.numpy(), ref["weight"][1])
    share = kt.grad.numpy() / ck
    assert share[0, 0, 0, 3] == share[1, 1, 1, 3] == 0.5 and np.all(share[..., 7] == 1.0)
    kc = torch.from_numpy(k).requires_grad_(True)
    torch.clamp(kc * 127 / 0.4, -127, 127).sum().backward()
    assert kc.grad[0, 0, 0, 3] != 0.5 * 127 / 0.4  # the trap the port avoids


def test_qat_apply_heads_match_jax(jax_refs):  # noqa: F811
    """The fake-quant forward's fp32 heads within the per-layer mixed
    tolerance of JAX's (a product sum in another order can move a
    fake-quant value by a step); the float64 forward is held through the
    loss of the float64 steps, to 1e-9."""
    folded, x = small_case("lite")
    with torch.no_grad():
        got = qat_apply(folded, small_scales("lite"), torch.from_numpy(x), arch="lite")
    assert got.dtype == torch.float32
    _assert_mixed_tolerance((got,), (jax_refs["quant_tools/fake_quant"]["heads"],))


@pytest.mark.slow
def test_qat_step_fp32_matches_jax(jax_refs):  # noqa: F811
    """One fp32 step with labels (the YOLOv3 loss) against JAX's fp32 step
    from the same weights: the loss within 1e-5 relative, the gradient
    (JAX's first Adam moment / 0.1) within 1e-3 relative L2 of every leaf,
    and the weights after it within 1e-6 but where Adam's first step,
    ``lr * g / (|g| + eps)``, turns on a gradient entry within 1e-3 of the
    leaf's largest of zero (its sign is fp32 noise).  The fake-quant graph
    is discontinuous, so an fp32 run is held to fp32 JAX, not to float64:
    the two differ by 30% in the distillation loss (bin flips that
    travel)."""
    ref = jax_refs["quant_tools/qat_fp32"]["labels"]
    run = _qat_run(torch.float32, targets=[label_targets()], anchors=LABEL_ANCHORS,
                   input_hw=(64, 96))
    loss, g = run.loss_and_grad(run.theta0, 0)
    assert abs(float(loss) - ref["losses"][0]) <= 1e-5 * ref["losses"][0]
    mu1 = ref["states"][1]["mu"]
    new = run.step(run.theta0, torch.zeros_like(run.theta0), torch.zeros_like(run.theta0),
                   torch.zeros((), dtype=torch.int32), 0)[0]
    worst, noisy = 0.0, 0
    for key, (a, b) in run.layout.spans.items():
        want_g = mu1[key].reshape(-1) / 0.1
        if np.any(want_g):
            worst = max(worst, _rel(g[a:b].numpy(), want_g))
        off = np.abs(new[a:b].numpy() - ref["states"][1]["params"][key].reshape(-1))
        small = np.abs(want_g) <= 1e-3 * np.abs(want_g).max()
        assert np.all((off <= 1e-6) | small), key
        noisy += int(np.sum(off > 1e-6))
    print(f"fp32 step: worst gradient leaf {worst:.2e}; {noisy} of {new.numel()} weights moved "
          "the other way on a near-zero gradient")
    assert worst <= 1e-3


@pytest.mark.slow
def test_qat_steps_float64_match_jax(jax_refs):  # noqa: F811
    """float64 distillation steps (conf_weight 2) against JAX's x64 step
    from the same state (module docstring): parameters, Adam moments and
    loss within 1e-9 a leaf; and ``qat_finetune``'s first step equals JAX's
    first step (later ones may take the other branch of a clip tie).  The
    label mode is held in fp32 (test_qat_step_fp32_matches_jax)."""
    ref = jax_refs["quant_tools/qat_float64"]["distill"]
    kw = {"conf_weight": 2.0}
    run = _qat_run(torch.float64, **kw)
    worst = 0.0
    for i, loss in enumerate(ref["losses"]):
        before, after = ref["states"][i], ref["states"][i + 1]
        new, mu, nu, count, got_loss, _ = run.step(
            _state_tensor(run, before["params"]), _state_tensor(run, before["mu"]),
            _state_tensor(run, before["nu"]), torch.tensor(before["count"], dtype=torch.int32), 0)
        assert int(count) == after["count"]
        assert abs(float(got_loss) - loss) <= FLOAT64_TOL * abs(loss)
        for name, t in (("params", new), ("mu", mu), ("nu", nu)):
            for key, (a, b) in run.layout.spans.items():
                r = _rel(t[a:b].numpy(), after[name][key].reshape(-1))
                worst = max(worst, r)
                assert r <= FLOAT64_TOL, (i, name, key, r)
    print(f"float64 distillation: worst leaf {worst:.2e}")
    folded, x = small_case("lite")
    tuned, hist, snaps = qat_finetune(folded, small_scales("lite"), [x], arch="lite", steps=1,
                                      lr=QAT_LR, snapshot_every=1, device="cpu",
                                      dtype=torch.float64, **kw)
    assert abs(hist[0] - ref["losses"][0]) <= FLOAT64_TOL * abs(ref["losses"][0])
    first = _flat_tree(snaps[0])
    assert max(_rel(first[k], ref["states"][1]["params"][k]) for k in first) <= FLOAT64_TOL
    assert list(tuned) == sorted(folded) and tuned["conv0"]["kernel"].dtype == np.float64
