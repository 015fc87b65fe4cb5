"""The port's StableHLO text programs (``yolofastest_torch.export.mlir``) run
by the unchanged native consumer ``cpp/runner/shlo_runner.cpp``
(``yf_shlo``, built by ``yolofastest_torch.native.find_shlo_runner``), held
against the port's own functions and the JAX package on the same inputs.

* ``forward.mlir`` of both architectures at 64x96 (weights drawn from a
  numpy seed, the same tree in both packages) within 2e-4 of the port's
  CPU folded forward and of JAX's ``folded_apply`` (JAX's rule for its own
  text, ``tests/test_shlo_native.py``); NHWC throughout, so no transpose
  but the deconv's.
* An NMS-only program on dense hand-made candidates (ties, same-class
  overlaps, an IOU exactly at the threshold, more survivors than
  ``max_det``, ``pixel_offset`` 0 and 1): every result bit for bit equal to
  the port's ``batched_nms`` and to JAX's.
* The ``export`` command's ``forward.mlir`` and ``detect.mlir`` (256x320,
  the zoo): JAX's folded logits within 2e-4; detections equal to JAX's own
  exported ``detect`` by ``tests/test_shlo_native.py``'s rules.
* ``yf_shlo``'s sort keeps ties in input order (the port's stable sort);
  an operator with no lowering raises, naming it; every text parses and
  verifies as StableHLO in JAX's MLIR context.

The seeded programs are written and run in a process of their own
(``tests/_torch_mlir.py``, started early by ``tests/_background.py``); the
JAX references run in the workers of ``tests/_jax_refs.py``.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from tests._background import mlir_programs, port_exports  # noqa: F401 (fixtures)
from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from tests._torch_mlir import (NMS_IOU_THRE, NMS_MAX_DET, PIXEL_OFFSETS, REFUSED,
                               nms_candidates, random_folded, sort_input)
from tests._torch_programs import FORWARD_BATCH, ZOOS, net_input
from yolofastest_torch.models import folded_apply, folded_apply_lite, torch_params_from_folded
from yolofastest_torch.native import run_shlo
from yolofastest_torch.ops import batched_nms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
pytestmark = pytest.mark.usefixtures("jax_refs")
DETECT_KEYS = ("boxes", "cls_idx", "cls_score", "conf", "count", "valid")  # JAX's flat order
CLI_FRAMES = 2  # detect.mlir's frames (forward.mlir: the first)


def _golden(n):
    return np.load(os.path.join(FIXTURES, "golden_256x320.npz"))["pre_imgs"][:n]


# ---------------------------------------------------------- JAX references
def _jax_forward(arch):
    """JAX's ``folded_apply`` (or the lite one) on the seeded tree, 64x96."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.models.graph import folded_apply as jfolded
    from yolofastest_tpu.models.graph import folded_apply_lite as jfolded_lite

    apply = jfolded if arch == "fastest" else jfolded_lite
    heads = jax.jit(apply)(jax.tree.map(jnp.asarray, random_folded(arch)),
                           jnp.asarray(net_input(FORWARD_BATCH)))
    return [np.asarray(h) for h in (heads if isinstance(heads, (tuple, list)) else (heads,))]


def _jax_nms(pixel_offset):
    """JAX's ``batched_nms`` on the hand-made candidates."""
    import jax

    from yolofastest_tpu.ops import batched_nms as jbatched_nms

    out = jax.jit(lambda *a: jbatched_nms(*a, iou_thre=NMS_IOU_THRE, max_det=NMS_MAX_DET,
                                          pixel_offset=float(pixel_offset)))(
        *nms_candidates(pixel_offset))
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_zoo(kind):
    """256x320 zoo: ``detect``, JAX's exported detect program's dict on the
    first CLI_FRAMES golden frames; ``forward``, its folded logits on the
    first."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.configs import get_config
    from yolofastest_tpu.export import export_detect_pipeline
    from yolofastest_tpu.models import fold_batchnorm, load_variables, zoo_path
    from yolofastest_tpu.models.graph import folded_apply as jfolded

    variables = load_variables(zoo_path("256x320"))
    frames = _golden(CLI_FRAMES)
    if kind == "detect":
        exp = export_detect_pipeline(variables, get_config("256x320"), batch=CLI_FRAMES)
        return {k: np.asarray(v) for k, v in exp.call(jnp.asarray(frames)).items()}
    x = (frames[:1].astype(np.float32)[..., None] - 128.0) / 255.0
    heads = jax.jit(jfolded)(jax.tree.map(jnp.asarray, fold_batchnorm(variables)), jnp.asarray(x))
    return [np.asarray(h) for h in heads]


for _arch in ZOOS:
    register(f"mlir/forward/{_arch}", _jax_forward, lambda a=_arch: (a,),
             tests=[f"test_forward_mlir_matches_port_and_jax[{_arch}"])
for _po in PIXEL_OFFSETS:
    register(f"mlir/nms/{_po}", _jax_nms, lambda p=_po: (p,),
             tests=[f"test_nms_mlir_matches_port_and_jax[{_po}"])
register("mlir/zoo/forward", _jax_zoo, lambda: ("forward",),
         tests=["test_cli_forward_mlir_matches_jax"])
register("mlir/zoo/detect", _jax_zoo, lambda: ("detect",),
         tests=["test_cli_detect_mlir_matches_jax"])


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def mlir_run(mlir_programs):  # noqa: F811
    """What ``tests/_torch_mlir.py`` wrote: ``yf_shlo``'s results, each
    program's operator counts and what the refused lowerings raised."""
    proc, root = mlir_programs
    proc.join(timeout=600)
    error = root / "error.txt"
    assert proc.exitcode == 0, error.read_text() if error.exists() else "no traceback written"
    with open(root / "texts.json") as f:
        texts = json.load(f)
    return np.load(root / "outputs.npz"), texts["texts"], texts["refused"], root


@pytest.fixture(scope="module")
def cli_mlir(port_exports):  # noqa: F811
    """The ``export`` command's output directory (256x320 zoo, batch 1)."""
    rc, printed, error = port_exports.command("fastest")
    assert rc == 0, error
    argv = port_exports.argvs["fastest"]
    return pathlib.Path(argv[argv.index("--out") + 1]), printed


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("arch", list(ZOOS))
def test_forward_mlir_matches_port_and_jax(mlir_run, jax_refs, arch):
    """forward.mlir of the seeded tree through yf_shlo: the port's CPU
    folded forward and JAX's folded_apply within 2e-4; convolutions NHWC
    with no transpose around them (only the deconv's reshuffle)."""
    outputs, texts, _, _ = mlir_run
    folded = random_folded(arch)
    apply = folded_apply if arch == "fastest" else folded_apply_lite
    with torch.no_grad():
        heads = apply(torch_params_from_folded(folded, "cpu"),
                      torch.from_numpy(net_input(FORWARD_BATCH)))
    heads = heads if isinstance(heads, tuple) else (heads,)
    theirs = jax_refs[f"mlir/forward/{arch}"]
    assert len(heads) == len(theirs) == (2 if arch == "fastest" else 1)
    for i, (ours, jax_head) in enumerate(zip(heads, theirs)):
        got = outputs[f"forward_{arch}/{i}"]
        assert got.shape == tuple(ours.shape) == jax_head.shape
        np.testing.assert_allclose(got, ours.numpy(), rtol=0, atol=2e-4)
        np.testing.assert_allclose(got, jax_head, rtol=0, atol=2e-4)
    counts = texts[f"forward_{arch}"]
    assert counts["convolution"] == sum(not n.startswith("deconv") for n in folded)
    assert counts.get("transpose", 0) == (1 if arch == "fastest" else 0)
    assert counts.get("dot_general", 0) == (1 if arch == "fastest" else 0)


@pytest.mark.parametrize("pixel_offset", PIXEL_OFFSETS)
def test_nms_mlir_matches_port_and_jax(mlir_run, jax_refs, pixel_offset):
    """The NMS fragment (a while loop for the keep mask, a stable sort and a
    gather for the compaction) gives every result of the port's and JAX's
    batched_nms bit for bit: keep, order and count; the pair at exactly the
    threshold is kept, the duplicate suppressed, and more rows survive than
    max_det."""
    outputs, texts, _, _ = mlir_run
    cand = nms_candidates(pixel_offset)
    ours = batched_nms(*(torch.from_numpy(a) for a in cand), iou_thre=NMS_IOU_THRE,
                       max_det=NMS_MAX_DET, pixel_offset=float(pixel_offset))
    theirs = jax_refs[f"mlir/nms/{pixel_offset}"]
    assert sorted(ours) == sorted(theirs) == list(DETECT_KEYS)
    got = {k: outputs[f"nms_{pixel_offset}/{i}"] for i, k in enumerate(DETECT_KEYS)}
    for k in DETECT_KEYS:
        np.testing.assert_array_equal(got[k], ours[k].numpy().astype(np.float32), err_msg=k)
        np.testing.assert_array_equal(got[k], theirs[k].astype(np.float32), err_msg=k)
    boxes = cand[0]
    for b in range(len(boxes)):  # rows 0, 1, 3 kept in order; row 2 (a duplicate) not
        np.testing.assert_array_equal(got["boxes"][b, :3], boxes[b, [0, 1, 3]])
    assert (got["count"] == NMS_MAX_DET).all()
    assert texts[f"nms_{pixel_offset}"]["while"] == 1


def test_sort_keeps_ties_in_input_order(mlir_run):
    """torch.sort (stable, descending) lowered to stablehlo.sort: yf_shlo's
    order of equal keys is their input order, as the port's."""
    outputs, texts, _, _ = mlir_run
    want = torch.sort(torch.from_numpy(sort_input()), dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(outputs["sort/0"], want.values.numpy())
    np.testing.assert_array_equal(outputs["sort/1"], want.indices.numpy().astype(np.float32))
    assert texts["sort"]["sort"] == 1


@pytest.mark.parametrize("name", list(REFUSED))
def test_lowering_refuses_unsupported_ops(mlir_run, name):
    """An operator yf_shlo cannot run (a cumsum; a slice with a step) makes
    save_exported_mlir raise NotImplementedError naming it, and no file is
    written (the lowering runs in tests/_torch_mlir.py's process)."""
    _, _, refused, _ = mlir_run
    assert refused[name]["type"] == "NotImplementedError"
    assert REFUSED[name] in refused[name]["message"]
    assert not refused[name]["written"]


def test_texts_are_valid_stablehlo(mlir_run, cli_mlir):
    """Every text the port wrote (the seeded forwards, the NMS and sort
    programs, the export command's forward.mlir and detect.mlir) parses and
    verifies as StableHLO in JAX's MLIR context, the dialects XLA reads."""
    from jax.extend.mlir import ir
    from jax.interpreters import mlir as jmlir

    _, texts, _, root = mlir_run
    paths = [root / f"{name}.mlir" for name in texts]
    paths += [cli_mlir[0] / name for name in ("forward.mlir", "detect.mlir")]
    context = jmlir.make_ir_context()
    for path in paths:
        module = ir.Module.parse(path.read_text(), context=context)
        assert module.operation.verify(), path.name


def test_cli_forward_mlir_matches_jax(cli_mlir, jax_refs):
    """The export command's forward.mlir (256x320 zoo) on the first golden
    frame: JAX's fp32 folded logits within 2e-4 (tests/test_shlo_native.py)."""
    out, printed = cli_mlir
    assert f"wrote {out / 'forward.mlir'}" in printed
    theirs = jax_refs["mlir/zoo/forward"]
    x = (_golden(1).astype(np.float32)[..., None] - 128.0) / 255.0  # the command's batch, 1
    heads, ms = run_shlo(str(out / "forward.mlir"), x)
    assert len(heads) == 2 and ms > 0
    for got, want in zip(heads, theirs):
        np.testing.assert_allclose(got, want[:1], rtol=0, atol=2e-4)


def test_cli_detect_mlir_matches_jax(cli_mlir, jax_refs):
    """The export command's detect.mlir (uint8 frames in, detections out)
    against JAX's exported detect program, by tests/test_shlo_native.py's
    rules: counts and classes equal, boxes within 1 px, conf and cls_score
    within 1e-3."""
    out, printed = cli_mlir
    assert f"wrote {out / 'detect.mlir'}" in printed
    want = jax_refs["mlir/zoo/detect"]
    frames = _golden(CLI_FRAMES)
    for i in range(CLI_FRAMES):
        res, _ = run_shlo(str(out / "detect.mlir"), frames[i:i + 1])
        got = dict(zip(DETECT_KEYS, res))
        n = int(want["count"][i])
        assert n > 0
        np.testing.assert_array_equal(got["count"].astype(np.int32), want["count"][i:i + 1])
        np.testing.assert_allclose(got["boxes"][0, :n], want["boxes"][i, :n], atol=1.0)
        np.testing.assert_array_equal(got["cls_idx"][0, :n].astype(np.int32),
                                      want["cls_idx"][i, :n])
        np.testing.assert_allclose(got["conf"][0, :n], want["conf"][i, :n], atol=1e-3)
        np.testing.assert_allclose(got["cls_score"][0, :n], want["cls_score"][i, :n], atol=1e-3)
        np.testing.assert_array_equal(got["valid"][0].astype(bool), want["valid"][i])
