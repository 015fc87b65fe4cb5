"""The port's int8 quantisation (``yolofastest_torch.quant``) and the int8
backends of its Detector and commands, on the CPU, held against the JAX
package from the same numpy inputs.

What is held, and how closely:

* the threshold rules, bit for bit on the same histograms; the histogram's
  binning bit for bit on the same activations;
* ``calibrate``: the key set and its order exactly (sorted: the JAX
  recorder returns its amax dict from a jitted function), the amax scales
  within 1e-5 relative (the fp forward differs from XLA's by ulps), the
  histogram methods within one bin of 2048 plus that;
* the recording executors' key list in walk order, and the res chains run
  layer by layer in every int8 executor (the chain kernel never runs there);
* both int8 executors' heads, with the same scales, bit for bit against the
  JAX executors jitted as the JAX Detector jits them (scales as constants):
  XLA computes ``round(x * f32(1 / s))`` and a fused multiply-add epilogue,
  and so does the port (``tools/torch_int8_parity.py`` counts 0 differing
  int8 activations of 104,512,000 on the 20 golden frames); the mixed
  executors, whose fp layers are a float32 convolution in another order,
  within the tolerance stated in their test;
* the shipped artifacts: the loader, writer and ``mixed_native_tree`` equal
  to JAX's; golden recall 34/34 on both int8 backends; the pruned hybrid
  artifact's rows equal to JAX's by the strict rule;
* the calibration cache read in both directions; the Detector's misuse
  errors, message for message;
* ``detect``, ``eval``, ``serve`` and ``video`` with the int8 flags against
  the JAX commands.

The JAX references that compile run in the workers of ``tests/_jax_refs.py``.
"""

import atexit
import contextlib
import io
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from chip_smoke import golden_match, make_frames, recall_iou
from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from yolofastest_torch.configs import get_config
from yolofastest_torch.inference import Detector, detections_to_lists
from yolofastest_torch.models import FoldedExecutor, fold_batchnorm, load_variables, zoo_path
from yolofastest_torch.quant import (QuantParams, calibrate, int8_zoo_path, load_int8_zoo,
                                     mixed_native_tree, quantize_weights, quantized_apply,
                                     quantized_apply_fused, quantized_apply_fused_mixed,
                                     quantized_apply_mixed, save_int8_zoo)
from yolofastest_torch.quant import ptq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PRUNED_ART = os.path.join(ROOT, "weights", "yolofastest_int8_pruned040_256x320.npz")
ARTIFACTS = {"256x320": int8_zoo_path("256x320"), "512x640": int8_zoo_path("512x640"),
             "pruned040": PRUNED_ART}
CLI_KEEP_FP = "conv2_2,conv4_1_2"
cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("jax_refs")


def golden_x(res="256x320", n=None):
    """The first ``n`` golden frames as (n, H, W, 1) float32 net inputs."""
    pre = np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))["pre_imgs"][:n]
    return (pre.astype(np.float32)[..., None] - 128.0) / 255.0


def rows_as_reference(rows):
    """Per-image rows -> golden_match's reference array [b, x1..cls]."""
    return np.array([[b, *r] for b, img in enumerate(rows) for r in img], np.float64
                    ).reshape(-1, 8)


def assert_rows_equal(ours, theirs):
    """The strict golden rule (tests/test_detect_parity.py:145-171) with the
    JAX rows as the reference: equal counts, classes, corners within 1 px,
    conf and cls_score within 1e-3."""
    matched, notes = golden_match(ours, rows_as_reference(theirs), len(theirs))
    assert not notes and matched == sum(len(r) for r in theirs)


# ---------------------------------------------------------------- the cases
def heads_case(kind, scales=None):
    """(folded, scales, keep_fp, arch, x) of an executor comparison:
    ``fastest`` the 256x320 artifact on 2 frames; ``lite`` the lite zoo with
    the port's amax scales of 2 frames (made in the test process: the JAX
    worker gets them as ``scales``), on those frames and their mirror (the
    TTA batch); ``pruned`` the pruned hybrid artifact on 3 frames."""
    if kind == "lite":
        folded = fold_batchnorm(load_variables(zoo_path("lite_256x320")))
        x = golden_x(n=2)
        return folded, scales or lite_scales(), (), "lite", np.concatenate([x, x[:, :, ::-1]])
    folded, scales, keep = load_int8_zoo(ARTIFACTS["256x320" if kind == "fastest" else
                                                   "pruned040"])
    return folded, scales, keep, "fastest", golden_x(n=2 if kind == "fastest" else 3)


_LITE = {}


def lite_scales():
    if not _LITE:
        folded = fold_batchnorm(load_variables(zoo_path("lite_256x320")))
        _LITE.update(calibrate(folded, [golden_x(n=2)], arch="lite", device="cpu"))
    return dict(_LITE)


def _jax_heads(kind, scales=None):
    """The JAX executors on one case, jitted as the JAX Detector jits them
    (the int8 weights an argument, the scales constants): (int8 heads,
    fused heads), the mixed executors where the case keeps fp layers, and
    for those the JAX Detector's decode and NMS of both."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.ops import batched_nms, decode_heads
    from yolofastest_tpu.quant import quantize_weights as jquantize_weights
    from yolofastest_tpu.quant.ptq import quantized_apply as japply
    from yolofastest_tpu.quant.ptq import quantized_apply_fused as japply_fused
    from yolofastest_tpu.quant.sensitivity import quantized_apply_fused_mixed as jfused_mixed
    from yolofastest_tpu.quant.sensitivity import quantized_apply_mixed as jmixed

    folded, scales, keep, arch, x = heads_case(kind, scales)
    qp = jax.tree.map(jnp.asarray, jquantize_weights(folded))
    fp = jax.tree.map(jnp.asarray, {k: folded[k] for k in keep})
    io = jget_config("256x320").io

    def as_tuple(h):
        return h if isinstance(h, tuple) else (h,)

    def run(qp, fp, x):
        if keep:
            heads = (jmixed(qp, fp, scales, x, fp_layers=keep),
                     jfused_mixed(qp, fp, scales, x, fp_layers=keep))
        else:
            heads = (japply(qp, scales, x, arch=arch), japply_fused(qp, scales, x, arch=arch))
        heads = tuple(as_tuple(h) for h in heads)
        if not keep:
            return heads
        dets = tuple(batched_nms(*decode_heads(h, io.anchors, io.input_hw, io.conf_thre,
                                               io.max_decode), iou_thre=io.nms_thre,
                                 max_det=io.max_det) for h in heads)
        return heads, dets

    return jax.tree.map(np.asarray, jax.jit(run)(qp, fp, jnp.asarray(x)))


register("quant/heads_fastest", _jax_heads, lambda: ("fastest",))
register("quant/heads_lite", _jax_heads, lambda: ("lite", lite_scales()))
register("quant/heads_pruned", _jax_heads, lambda: ("pruned",))


def _calibrations():
    """``calibrate`` of the port and of the JAX package, each for the four
    methods, on the same 2 frames with the 256x320 zoo; both run here, in a
    worker, beside the tests.  The JAX calibrate jits its two recording
    walks anew in every call; with the same weights and batch (and so the
    same ranges) they are the same two programs in all four calls, so
    ``jax.jit`` is memoised by the walk's code for the duration (three
    recompiles of each saved)."""
    import jax

    from yolofastest_tpu.quant import calibrate as jcalibrate

    folded = fold_batchnorm(load_variables(zoo_path("256x320")))
    batch = [golden_x(n=2)]
    jit, compiled = jax.jit, {}
    jax.jit = lambda fn: compiled.setdefault(fn.__code__, jit(fn))
    try:
        theirs = {m: jcalibrate(folded, batch, method=m) for m in METHODS}
    finally:
        jax.jit = jit
    assert len(compiled) == 2
    ours = {m: calibrate(folded, batch, method=m, device="cpu") for m in METHODS}
    return ours, theirs


METHODS = ("amax", "mse", "percentile", "entropy")
register("quant/calibrate", _calibrations)


# ------------------------------------------------------- threshold rules
def _histograms():
    rng = np.random.default_rng(0)
    dense = np.histogram(np.abs(rng.standard_normal(200_000)), bins=2048)[0]
    heavy = np.histogram(np.abs(rng.standard_cauchy(50_000)), bins=2048, range=(0, 60))[0]
    sparse = np.zeros(2048, np.int64)
    sparse[rng.integers(0, 2048, 9)] = rng.integers(1, 50, 9)
    return {"dense": dense, "heavy": heavy, "sparse": sparse,
            "empty": np.zeros(2048, np.int64), "one_bin": np.eye(1, 2048, 0, np.int64)[0] * 7}


@pytest.mark.parametrize("rule", ["percentile", "smooth", "kl", "mse"])
def test_threshold_rules_bit_for_bit(rule):
    from yolofastest_tpu.quant import ptq as jptq

    for name, h in _histograms().items():
        if rule == "percentile":
            for pct in (50.0, 99.5, 99.99, 100.0):
                assert ptq._percentile_threshold(h, pct) == jptq._percentile_threshold(h, pct)
        elif rule == "smooth":
            np.testing.assert_array_equal(ptq._smooth(h), jptq._smooth(h))
        elif rule == "kl":
            assert ptq._kl_threshold(h) == jptq._kl_threshold(h), name
        else:
            assert ptq._mse_threshold(h, 2048) == jptq._mse_threshold(h, 2048), name


def test_histogram_binning_matches_jax():
    """The second pass's bin index, as XLA computes JAX's ``a / r * bins``
    with ``r`` a jit constant, on values at 0, at the range, above it and in
    between: the same histograms bit for bit."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.quant import ptq as jptq

    rng = np.random.default_rng(1)
    for r in (np.float32(3.7), np.float32(1e-3), np.float32(0.25)):
        a = (rng.standard_normal(4096) * float(r)).astype(np.float32)
        a[:3] = [0.0, r, np.nextafter(r, np.float32(9))]
        jex = jptq._HistRecordingExecutor({}, {"k": jnp.float32(r)}, 2048)

        def jhist(v):
            jex._rec("k", v)
            return jex.hist["k"]

        want = np.asarray(jax.jit(jhist)(jnp.asarray(a)))
        inv = {"k": torch.tensor(np.float32(1) / r)}
        tex = ptq._HistRecordingExecutor({"layers": {}, "chains": {}}, inv, 2048)
        tex._rec("k", torch.from_numpy(a))
        np.testing.assert_array_equal(tex.hist["k"].numpy(), want)


@pytest.mark.parametrize("arch", ["fastest", "lite"])
def test_recorded_keys_in_walk_order(arch, monkeypatch):
    """The recording executor's keys, in the order it records them, equal
    the JAX recorder's (traced by jax.eval_shape): every res*/conv* layer
    and out/add_N numbered over the chains' adds, so the chains ran layer by
    layer and never through the chain kernel."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.models.graph import walk_topology as jwalk
    from yolofastest_tpu.models.graph import walk_topology_lite as jwalk_lite
    from yolofastest_tpu.quant import ptq as jptq

    folded = fold_batchnorm(load_variables(zoo_path("256x320" if arch == "fastest"
                                                    else "lite_256x320")))
    jex = jptq._RecordingExecutor(folded)
    jax.eval_shape(lambda x: (jwalk if arch == "fastest" else jwalk_lite)(x, jex),
                   jax.ShapeDtypeStruct((1, 64, 96, 1), jnp.float32))
    ex = ptq._RecordingExecutor(ptq.torch_params_from_folded(folded, "cpu", chains=False))
    monkeypatch.setattr(FoldedExecutor, "chain_fn", None)  # a whole chain would fail
    ptq._WALKS[arch](torch.zeros(1, 64, 96, 1), ex)
    assert list(ex.amax) == list(jex.amax)
    assert "res5_5/conv3" in ex.amax and "out/add_17" in ex.amax
    assert len(ex.amax) == (189 if arch == "fastest" else 175)


@pytest.mark.parametrize("method", METHODS)
def test_calibrate_matches_jax(jax_refs, method):  # noqa: F811
    """The port's calibrate against JAX's (both computed in a worker, see
    :func:`_calibrations`): the keys in JAX's order (sorted), amax within
    1e-5 relative, the histogram methods within one bin of 2048 more."""
    ours, theirs = (r[method] for r in jax_refs["quant/calibrate"])
    amax = jax_refs["quant/calibrate"][0]["amax"]
    assert list(ours) == list(theirs) == sorted(theirs)
    for k, s in theirs.items():
        one_bin = 0.0 if method == "amax" else amax[k] / 2048
        assert abs(ours[k] - s) <= one_bin + 1e-5 * s, (k, ours[k], s)


# ----------------------------------------------------------- the executors
@pytest.mark.parametrize("kind", ["fastest", "lite"])
def test_executor_heads_match_jax(jax_refs, kind):  # noqa: F811
    """Int8Executor and Int8FusedExecutor with the same scales: heads equal
    to JAX's bit for bit (lite: the frames and their mirror, TTA's batch)."""
    folded, scales, _, arch, x = heads_case(kind)
    theirs = jax_refs[f"quant/heads_{kind}"]
    qp = QuantParams(quantize_weights(folded), "cpu")
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        ours = (quantized_apply(qp, scales, xt, arch=arch),
                quantized_apply_fused(qp, scales, xt, arch=arch))
    for got, want in zip(ours, theirs):
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want) == (2 if arch == "fastest" else 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_mixed_executors_match_jax(jax_refs):  # noqa: F811
    """Both mixed executors on the pruned hybrid artifact (keep_fp conv2_2,
    conv4_1_2) against JAX's.  The kept layers are float32 convolutions
    summed in another order than XLA's, so their float outputs differ by
    ulps; where the per-layer graph quantises one at a rounding edge, an
    int8 value lands one step away, and a step travels.  Measured on these
    frames: the fused mixed heads equal JAX's bit for bit (the kept layers'
    outputs are requantised at once), the per-layer mixed head_4 differs in
    0.8% of its values, by 3e-4 on average and 0.39 at most.  Held: fused
    bit for bit; per-layer 99% of the values within 0.05, the mean within
    1e-3, every value within 0.5; and the rows of the JAX Detector's
    pipeline equal by the strict rule for both."""
    folded, scales, keep, arch, x = heads_case("pruned")
    (jheads, jdets) = jax_refs["quant/heads_pruned"]
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        ours = (quantized_apply_mixed(quantize_weights(folded), folded, scales, xt,
                                      fp_layers=keep),
                quantized_apply_fused_mixed(quantize_weights(folded), folded, scales, xt,
                                            fp_layers=keep))
    for g, w in zip(ours[0], jheads[0]):
        d = np.abs(g.numpy() - w)
        assert d.max() <= 0.5 and d.mean() <= 1e-3 and np.mean(d <= 0.05) >= 0.99, (
            d.max(), d.mean(), np.mean(d > 0.05))
    for g, w in zip(ours[1], jheads[1]):
        np.testing.assert_array_equal(g.numpy(), w)
    for fused, jd in zip((False, True), jdets):
        det = Detector(get_config("256x320"), None, backend="int8-fused" if fused else "int8",
                       int8_artifact=PRUNED_ART, device="cpu")
        assert det.keep_fp == keep == ("conv2_2", "conv4_1_2")
        assert_rows_equal(detections_to_lists(det.run(x)), detections_to_lists(jd))


def test_mixed_kept_res_layer_runs_alone(monkeypatch):
    """A kept res*/conv* layer runs the fp kernel alone, the rest of its
    chain int8: the mixed executors never hand a chain to the fp executor
    (which would launch the fp chain kernel inside the int8 graph)."""
    folded, scales, _ = load_int8_zoo(ARTIFACTS["256x320"])
    seen = []
    conv = FoldedExecutor.conv

    def spy(self, x, name, *a, **k):
        seen.append(name)
        return conv(self, x, name, *a, **k)

    monkeypatch.setattr(FoldedExecutor, "conv", spy)
    monkeypatch.setattr(FoldedExecutor, "chain_fn", None)
    x = torch.from_numpy(golden_x(n=1)[:, :64, :96])
    for apply in (quantized_apply_mixed, quantized_apply_fused_mixed):
        seen.clear()
        mixed = apply(quantize_weights(folded), folded, scales, x, fp_layers=("res3_5/conv2",))
        assert seen == ["res3_5/conv2"]
        pure = (quantized_apply if apply is quantized_apply_mixed
                else quantized_apply_fused)(quantize_weights(folded), scales, x)
        assert any(not torch.equal(m, p) for m, p in zip(mixed, pure))
    with pytest.raises(ValueError, match=r"unknown --keep-fp layer\(s\): \['conv9'\]"):
        quantized_apply_mixed(quantize_weights(folded), folded, scales, x, fp_layers=("conv9",))


def test_contraction_bound():
    """The float32 accumulator is exact up to 1040 products of +-127 a
    output; a wider layer raises when the parameters are built, never
    later.  The shipped graphs' widest is 232 (conv4_1_1)."""
    assert ptq.MAX_CONTRACTION == 1040 and 1040 * 127 ** 2 <= 2 ** 24 < 1041 * 127 ** 2
    qp = QuantParams(quantize_weights(load_int8_zoo(ARTIFACTS["512x640"])[0]), "cpu")
    widest = max(qp.layers.items(), key=lambda kv: kv[1]["contraction"])
    assert (widest[0], widest[1]["contraction"]) == ("conv4_1_1", 232)
    rng = np.random.default_rng(2)
    for cin, k, ok in ((1040, 1, True), (1041, 1, False), (116, 3, False), (115, 3, True)):
        layer = {"kernel_q": rng.integers(-127, 128, (k, k, cin, 2)).astype(np.int8),
                 "w_scale": np.ones(2, np.float32), "bias": np.zeros(2, np.float32)}
        if ok:
            QuantParams({"conv_wide": layer}, "cpu")
        else:
            with pytest.raises(ValueError, match="conv_wide"):
                QuantParams({"conv_wide": layer}, "cpu")


# ---------------------------------------------------------------- the zoo
@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_load_int8_zoo_matches_jax(name):
    from yolofastest_tpu.quant import load_int8_zoo as jload

    (f, s, k), (jf, js, jk) = load_int8_zoo(ARTIFACTS[name]), jload(ARTIFACTS[name])
    assert list(f) == list(jf) and list(s) == list(js) and s == js and k == jk
    for layer in jf:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(f[layer][leaf], jf[layer][leaf])
    # the pruned artifact embeds two kept layers (the JAX module's docstring names one)
    assert k == (("conv2_2", "conv4_1_2") if name == "pruned040" else ())
    assert load_int8_zoo("nope.npz") is None and jload("nope.npz") is None


def test_save_int8_zoo_both_ways(tmp_path):
    from yolofastest_tpu.quant import load_int8_zoo as jload
    from yolofastest_tpu.quant import save_int8_zoo as jsave

    folded, scales, keep = load_int8_zoo(PRUNED_ART)
    save_int8_zoo(folded, scales, str(tmp_path / "port.npz"), keep_fp=keep)
    jsave(folded, scales, str(tmp_path / "jax.npz"), keep_fp=keep)
    pairs = ((load_int8_zoo(str(tmp_path / "jax.npz")), jload(str(tmp_path / "port.npz"))),
             (load_int8_zoo(str(tmp_path / "port.npz")), (folded, scales, keep)))
    for mine, theirs in pairs:
        assert mine[1] == theirs[1] and mine[2] == theirs[2] and list(mine[0]) == list(theirs[0])
        for layer in theirs[0]:
            np.testing.assert_array_equal(mine[0][layer]["kernel"], theirs[0][layer]["kernel"])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        assert all(np.array_equal(a[n], b[n]) for n in a.files)
    np.savez(tmp_path / "bad.npz", x=np.zeros(1))
    with pytest.raises(ValueError, match="not an int8 zoo artifact"):
        load_int8_zoo(str(tmp_path / "bad.npz"))


def test_mixed_native_tree_matches_jax():
    from yolofastest_tpu.quant import mixed_native_tree as jtree

    folded, scales, keep = load_int8_zoo(PRUNED_ART)
    for kept in (keep, ()):
        (t, s), (jt, js) = mixed_native_tree(folded, scales, kept), jtree(folded, scales, kept)
        assert s == js and list(t) == list(jt)
        for layer in jt:
            assert sorted(t[layer]) == sorted(jt[layer])
            for leaf in jt[layer]:
                np.testing.assert_array_equal(t[layer][leaf], jt[layer][leaf])
    for fn in (mixed_native_tree, jtree):
        with pytest.raises(ValueError, match="keep_fp layers not in the folded tree"):
            fn(folded, scales, ("conv9",))


# ------------------------------------------------------------ the Detector
@pytest.mark.parametrize("backend", ["int8", "int8-fused"])
@pytest.mark.parametrize("artifact", ["256x320", "pruned040"])
def test_shipped_artifacts_golden_recall(artifact, backend):
    """All 34 golden boxes by class and IoU > 0.5 (tools/run_golden_suite.py:
    37-47), as docs/golden_suite_summary.json records for JAX; the 512x640
    artifact's 33/33 runs on the card (chip_smoke.py)."""
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    det = Detector(get_config("256x320"), None, backend=backend,
                   int8_artifact=ARTIFACTS[artifact], device="cpu")
    rows = detections_to_lists(det.run(golden_x()))
    assert recall_iou(rows, fx["boxes"]) == len(fx["boxes"]) == 34


def test_detector_lite_tta_calibrated(jax_refs, tmp_path):  # noqa: F811
    """Detector(arch='lite', tta=True, backend='int8-fused') calibrating on
    two frames: the scales it writes to its cache are the lite scales of the
    JAX comparison, its doubled TTA forward gives JAX's fused heads bit for
    bit, and run, run_packed, run_raw and warmup agree."""
    from yolofastest_torch.ops import unpack_detections

    x = golden_x(n=2)
    cache = str(tmp_path / "lite.calib.json")
    det = Detector(get_config("lite-256x320"), load_variables(zoo_path("lite_256x320")),
                   backend="int8-fused", arch="lite", tta=True, calibration=x,
                   calibration_cache=cache, device="cpu")
    assert det.act_scales == lite_scales()
    with open(cache) as f:
        assert json.load(f) == det.act_scales
    heads = det.forward_heads(x)
    np.testing.assert_array_equal(heads[0].numpy(), jax_refs["quant/heads_lite"][1][0])
    d = det.run(x)
    u = unpack_detections(det.run_packed(x))
    np.testing.assert_array_equal(u["count"], d["count"].numpy())
    np.testing.assert_array_equal(u["boxes"], d["boxes"].numpy())
    raw = det.run_raw(make_frames(np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
                                  ["pre_imgs"][:2]))
    np.testing.assert_array_equal(raw["count"].numpy(), d["count"].numpy())
    det.warmup(2)
    assert 2 in det._warm and d["count"].sum() > 0


@pytest.mark.parametrize("threaded", [False, True])
def test_consumers_take_an_int8_detector(threaded):
    """The consumers of ``run_packed`` take an int8 Detector as JAX's take
    one: the streaming detector over it (uint8 batches) gives its
    run_packed results, and sliced detection over its tiles finds the
    golden boxes of a 2x2 mosaic of golden frames (the batcher, video and
    evaluator run in test_cli_int8_matches_jax_command)."""
    from yolofastest_torch.inference import StreamingDetector, sliced_detect
    from yolofastest_torch.ops import unpack_detections

    det = Detector(get_config("256x320"), None, backend="int8-fused",
                   int8_artifact=ARTIFACTS["256x320"], device="cpu")
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    batches = [fx["pre_imgs"][i:i + 2] for i in (0, 2)]
    got = list(StreamingDetector.over(det, depth=2, threaded=threaded)(iter(batches)))
    assert len(got) == 2
    for i, g in zip((0, 2), got):
        want = unpack_detections(det.run_packed(golden_x(n=4)[i:i + 2]))
        np.testing.assert_array_equal(g["boxes"], want["boxes"])
        np.testing.assert_array_equal(g["count"], want["count"])
    if threaded:
        return
    big = np.concatenate([np.concatenate(list(make_frames(fx["pre_imgs"][i:i + 2])), 1)
                          for i in (0, 2)], 0)
    out = sliced_detect(det, big, (2, 2), 0.2)
    golden = fx["boxes"][fx["boxes"][:, 0] < 4]
    assert out["count"] >= len(golden) > 0


def test_calibration_cache_both_directions(tmp_path):
    """The cache is JAX's JSON: the port's file is JAX's file for the same
    scales, byte for byte; the JAX Detector's reader takes the port's file
    and the port's Detector takes the JAX writer's."""
    from yolofastest_tpu.inference import Detector as JDetector

    folded = fold_batchnorm(load_variables(zoo_path("256x320")))
    scales = calibrate(folded, [golden_x(n=1)], device="cpu")
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    Detector._load_or_calibrate(folded, golden_x(n=1), ours,
                                lambda f, b: calibrate(f, b, device="cpu"))
    JDetector._load_or_calibrate(folded, golden_x(n=1), theirs, lambda f, b: scales)
    assert open(ours).read() == open(theirs).read()
    assert list(JDetector._load_or_calibrate(None, None, ours, None).items()) == list(
        scales.items())
    det = Detector(get_config("256x320"), load_variables(zoo_path("256x320")), backend="int8",
                   calibration_cache=theirs, device="cpu")
    assert list(det.act_scales.items()) == list(scales.items())


MISUSES = {
    "artifact_on_fp": dict(int8_artifact="256x320"),
    "keep_fp_with_artifact": dict(backend="int8", int8_artifact="256x320",
                                  keep_fp=("conv2_2",)),
    "missing_artifact": dict(backend="int8", int8_artifact="nope.npz"),
    "keep_fp_on_fp": dict(keep_fp=("conv2_2",)),
    "unknown_keep_fp": dict(backend="int8-fused", keep_fp=("conv9",)),
    "no_calibration": dict(backend="int8"),
    "unknown_backend": dict(backend="int4"),
}


@pytest.mark.parametrize("case", list(MISUSES))
def test_detector_misuse_raises_as_jax(case, tmp_path):
    """Each misuse raises the JAX Detector's ValueError, with its message
    (an unknown keep-fp layer once the scales are read from a cache)."""
    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.inference import Detector as JDetector

    kwargs = dict(MISUSES[case])
    if case == "unknown_keep_fp":
        kwargs["calibration_cache"] = str(tmp_path / "c.json")
        with open(kwargs["calibration_cache"], "w") as f:
            json.dump(load_int8_zoo("256x320")[1], f)
    variables = load_variables(zoo_path("256x320"))
    with pytest.raises(ValueError) as want:
        JDetector(jget_config("256x320"), variables=variables, fold_bn=True, **kwargs)
    with pytest.raises(ValueError) as got:
        Detector(get_config("256x320"), variables, device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- commands
_CLI = {}


def cli_inputs():
    """Made once per process, in a temporary directory removed at exit: two
    512x640 golden frames as .jpg, four 256x320 frames as .jpg and as a VOC
    set with golden_map targets, and a 4-frame video of them."""
    from yolofastest_torch.data import write_voc_xml

    if not _CLI:
        root = tempfile.mkdtemp(prefix="yf_torch_quant_")
        atexit.register(shutil.rmtree, root, True)
        d512, d256 = os.path.join(root, "d512"), os.path.join(root, "voc", "img")
        os.makedirs(d512)
        os.makedirs(d256)
        os.makedirs(os.path.join(root, "voc", "xml"))
        pre512 = np.load(os.path.join(FIXTURES, "golden_512x640.npz"))["pre_imgs"][:2]
        for i, f in enumerate(make_frames(pre512)):
            cv2.imwrite(os.path.join(d512, f"g{i}.jpg"), f)
        pre = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))["pre_imgs"][:4]
        targets = np.load(os.path.join(FIXTURES, "golden_map.npz"))["targets"]
        names = get_config("256x320").io.class_names
        frames = make_frames(pre)
        for i, frame in enumerate(frames):
            cv2.imwrite(os.path.join(d256, f"g{i}.jpg"), frame)
            rows = targets[i][targets[i][:, 5] > 1]
            write_voc_xml(os.path.join(root, "voc", "xml", f"g{i}.xml"), f"g{i}.jpg",
                          (512, 640, 3),
                          [(names[int(c)], (xc - w / 2) * 640, (yc - h / 2) * 512,
                            (xc + w / 2) * 640, (yc + h / 2) * 512)
                           for c, xc, yc, w, h, _ in rows])
        clip = os.path.join(root, "clip.avi")
        writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (640, 512))
        for frame in frames:
            writer.write(frame)
        writer.release()
        _CLI.update(root=root, d512=d512, d256=d256, voc=os.path.join(root, "voc"), clip=clip)
    return _CLI


class _Drawn:
    """Within the block, record every box that ``modules``' ``plot_one_box``
    draws (corners and label)."""

    def __init__(self, *modules):
        self.modules, self.plot, self.boxes = modules, modules[0].plot_one_box, []

    def __enter__(self):
        def record(xyxy, img, color=None, label=None, line_thickness=None):
            self.boxes.append(([float(v) for v in xyxy], label))
            return self.plot(xyxy, img, color=color, label=label, line_thickness=line_thickness)

        for m in self.modules:
            m.plot_one_box = record
        return self.boxes

    def __exit__(self, *exc):
        for m in self.modules:
            m.plot_one_box = self.plot


def _cli_command(name, inp):
    """The command line of a CLI comparison, by side: paths from
    :func:`cli_inputs` (made in the test process and handed to the JAX
    worker), outputs under ``<root>/<side>_<name>``."""

    def line(side):
        out = os.path.join(inp["root"], f"{side}_{name}")
        cache = os.path.join(inp["root"], f"jax_{name}.calib.json")
        return {
            "detect": ["detect", "--config", "512x640", "--weights", zoo_path("512x640"),
                       "--data", inp["d512"], "--out", out, "--backend", "int8",
                       "--int8-zoo"],
            "eval": ["eval", "--weights", zoo_path("256x320"), "--val-dir", inp["voc"],
                     "--log-dir", out, "--json-out", os.path.join(inp["root"], f"{side}.json"),
                     "--backend", "int8-fused", "--keep-fp", CLI_KEEP_FP, "--calib-data",
                     inp["d256"], "--calibration-cache", cache],
            "video": ["video", "--weights", zoo_path("256x320"), "--video", inp["clip"],
                      "--out", out, "--batch", "2", "--backend", "int8", "--calib-data",
                      inp["d256"], "--calibration-cache", cache],
            "serve": ["serve", "--weights", zoo_path("256x320"), "--port", "0",
                      "--max-batch", "2", "--backend", "int8-fused", "--calib-data",
                      inp["d256"], "--calibration-cache", cache],
        }[name]

    return line


def _jax_cli(name, inp):
    """The JAX command: its exit code, what it printed, the boxes it drew,
    and (eval) its metrics or (serve) its engine's replies to two frames."""
    from yolofastest_tpu.cli import main as jmain
    from yolofastest_tpu.inference import detector as jdetector
    from yolofastest_tpu.inference import video as jvideo
    from yolofastest_tpu.utils import visualize as jvisualize

    argv = _cli_command(name, inp)("jax")
    if name == "serve":
        from yolofastest_tpu.cli._common import _build_engine
        from yolofastest_tpu.cli._common import _get_config as jget_config
        from yolofastest_tpu.cli.parser import build_parser as jbuild_parser
        from yolofastest_tpu.inference import make_batch_fn as jmake_batch_fn

        args = jbuild_parser().parse_args(argv)
        cfg = jget_config(args)
        engine = _build_engine(args, cfg, args.backend, args.calib_data)
        batch = golden_x(n=2)
        return 0, "", [], jmake_batch_fn(engine, max_det=cfg.io.max_det)(batch, 2)
    out = io.StringIO()
    with _Drawn(jvisualize, jdetector, jvideo) as drawn, contextlib.redirect_stdout(out):
        rc = jmain(argv)
    metrics = None
    if name == "eval":
        with open(os.path.join(inp["root"], "jax.json")) as f:
            metrics = json.load(f)
    return rc, out.getvalue(), drawn, metrics


for _name in ("detect", "eval", "video", "serve"):
    register(f"quant/cli_{_name}", _jax_cli, lambda n=_name: (n, cli_inputs()))


@pytest.mark.parametrize("name", ["detect", "eval", "video", "serve"])
def test_cli_int8_matches_jax_command(jax_refs, name, capsys):  # noqa: F811
    """The port's commands with the int8 flags against the JAX commands on
    the same files: ``detect --config 512x640 --backend int8 --int8-zoo``
    (the 512x640 artifact), ``eval --backend int8-fused --keep-fp ...
    --calib-data``, ``video --backend int8 --calib-data`` and the ``serve``
    engine of ``--backend int8-fused --calib-data``.  Where JAX calibrated,
    the port reads the cache the JAX command wrote (the same scales) after
    its own calibration has written one within the calibration tolerance of
    JAX's.  Boxes within 1 px and labels equal, mAP within 1e-6, replies
    equal by the strict rule."""
    from yolofastest_torch.cli import build_parser, main
    from yolofastest_torch.cli.serve import build_server
    from yolofastest_torch.inference import detector as tdetector
    from yolofastest_torch.inference import video as tvideo
    from yolofastest_torch.utils import visualize as tvisualize

    rc, printed, jdrawn, extra = jax_refs[f"quant/cli_{name}"]
    assert rc == 0
    argv = _cli_command(name, cli_inputs())("port") + ["--device", "cpu"]
    if "--calibration-cache" in argv:  # our own calibration first, into our own cache
        jcache = argv[argv.index("--calibration-cache") + 1]
        own = jcache.replace("jax_", "port_")
        argv[argv.index("--calibration-cache") + 1] = own
        args = build_parser().parse_args(argv)
        from yolofastest_torch.cli._common import build_detector

        det = build_detector(args, calib_data=args.calib_data)[1]
        with open(jcache) as f:
            jscales = json.load(f)
        assert list(det.act_scales) == list(jscales)
        assert all(abs(det.act_scales[k] - v) <= 1e-5 * v for k, v in jscales.items())
        argv[argv.index("--calibration-cache") + 1] = jcache
    if name == "serve":
        server = build_server(build_parser().parse_args(argv))
        server.start()  # close() shuts the HTTP loop down, so it must run
        try:
            assert server.backend == "int8-fused"
            replies = [server.batcher.submit(x) for x in golden_x(n=2)]
        finally:
            server.close()
        assert_rows_equal(replies, extra)
        return
    capsys.readouterr()
    with _Drawn(tvisualize, tdetector, tvideo) as drawn:
        assert main(argv) == 0
    printed_ours = capsys.readouterr().out
    assert len(drawn) == len(jdrawn) and (name == "eval") == (not drawn)
    for (box, label), (jbox, jlabel) in zip(drawn, jdrawn):
        assert label == jlabel
        np.testing.assert_allclose(box, jbox, atol=1.0)
    if name == "eval":
        with open(os.path.join(cli_inputs()["root"], "port.json")) as f:
            metrics = json.load(f)
        assert abs(metrics["mAP"] - extra["mAP"]) <= 1e-6 and metrics["backend"] == "int8-fused"
        assert [ln for ln in printed_ours.splitlines() if ln.startswith("mAP")] == [
            ln for ln in printed.splitlines() if ln.startswith("mAP")]
    if name == "video":
        ours, theirs = json.loads(printed_ours.splitlines()[-1]), json.loads(
            printed.splitlines()[-1])
        assert ours["frames"] == theirs["frames"] == 4
        assert ours["detections"] == theirs["detections"]


def test_cli_int8_misuse_exits_as_jax(tmp_path, capsys):
    """Misused int8 flags exit 2 with the JAX command's message, before any
    calibration or compile."""
    from yolofastest_tpu.cli import main as jmain
    from yolofastest_torch.cli import main

    inp = cli_inputs()
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    base = ["--weights", zoo_path("256x320"), "--calibration-cache", str(tmp_path / "c.json")]
    det = ["detect", "--data", inp["d256"], "--out", str(tmp_path / "o")]
    ev = ["eval", "--val-dir", inp["voc"], "--log-dir", str(tmp_path / "l")]
    for argv in (det + ["--keep-fp", "conv2_2"], det + ["--int8-zoo"],
                 det + ["--backend", "int8", "--int8-zoo", "--keep-fp", "conv2_2"],
                 det + ["--backend", "int8", "--int8-zoo", str(tmp_path / "nope.npz")],
                 ["detect", "--data", empty, "--out", str(tmp_path / "o"), "--backend", "int8"],
                 ev + ["--int8-zoo"], ev + ["--tta"], ev + ["--backend", "int8"]):
        assert jmain(argv + base) == 2, argv
        want = capsys.readouterr()
        assert main(argv + base + ["--device", "cpu"]) == 2, argv
        got = capsys.readouterr()
        # the last lines (JAX's eval logs its dataset before it checks)
        assert got.err.splitlines()[-1:] == want.err.splitlines()[-1:], argv
        assert got.out.splitlines()[-1:] == want.out.splitlines()[-1:], argv
    assert not os.path.exists(tmp_path / "c.json")
