"""The port's Detector (``yolofastest_torch.inference``) on the CPU: golden
boxes by the strict rules, detections equal to the JAX ``Detector``, the
device rule, package hygiene, and the ``detect`` CLI."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import box_iou, golden_match, make_frames
from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from yolofastest_torch.configs import get_config
from yolofastest_torch.inference import Detector, detections_to_lists
from yolofastest_torch.models import load_variables, zoo_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
# the JAX references of the training and eval tests compile from here on (tests/_jax_refs.py),
# and the module's two fresh processes run beside its first tests
pytestmark = pytest.mark.usefixtures("jax_refs", "fresh_processes")


@pytest.fixture(scope="module")
def setup():
    variables = load_variables(zoo_path("256x320"))
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    det = Detector(get_config("256x320"), variables=variables, device="cpu")
    return variables, fx, det


def test_golden_boxes_strict(setup):
    """All 34 golden boxes through run_raw: per-image counts equal, class
    equal, corners within 1 px, conf and cls_score within 1e-3
    (tests/test_detect_parity.py:145-171)."""
    _, fx, det = setup
    rows = detections_to_lists(det.run_raw(make_frames(fx["pre_imgs"])))
    matched, notes = golden_match(rows, fx["boxes"], fx["pre_imgs"].shape[0])
    assert not notes
    assert matched == len(fx["boxes"]) == 34
    # the rule itself: a box 2 px off, or one extra detection, is caught
    rows[0][0][0] += 2.0
    rows[1].append(list(rows[1][0]))
    matched, notes = golden_match(rows, fx["boxes"], fx["pre_imgs"].shape[0])
    assert matched == 33 and len(notes) == 2


def test_run_packed_and_run_agree(setup):
    from yolofastest_torch.ops import unpack_detections

    _, fx, det = setup
    x = (fx["pre_imgs"][:3].astype(np.float32)[..., None] - 128.0) / 255.0
    packed = det.run_packed(x)
    assert tuple(packed.shape) == (3, 64, 8)
    d = det.run(x)
    u = unpack_detections(packed)
    np.testing.assert_array_equal(u["count"], d["count"].numpy())
    np.testing.assert_array_equal(u["boxes"], d["boxes"].numpy())
    det.warmup(2)
    assert 2 in det._warm


def test_no_device_without_card_raises(monkeypatch, setup):
    """Without a card and without device='cpu' the Detector raises; it never
    moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(get_config("256x320"), variables=setup[0])


@pytest.mark.parametrize("kwargs", [{"fold_bn": False, "backend": "int8"}, {"backend": "int8"},
                                    {"backend": "int8-fused"},
                                    {"backend": "int8-fused", "arch": "lite", "tta": True}])
def test_unported_options_raise(kwargs, setup):
    """The int8 backends are ported (tests/test_torch_quant.py): without
    calibration batches or a cache they raise the JAX Detector's ValueError;
    with them they build (``fold_bn`` does not apply) and detect."""
    lite = kwargs.get("arch") == "lite"
    cfg = get_config("lite-256x320" if lite else "256x320")
    variables = load_variables(zoo_path("lite_256x320")) if lite else setup[0]
    with pytest.raises(ValueError, match="int8 backends need calibration= batches"):
        Detector(cfg, variables=variables, device="cpu", **kwargs)
    x = (setup[1]["pre_imgs"][:1].astype(np.float32)[..., None] - 128.0) / 255.0
    det = Detector(cfg, variables=variables, device="cpu", calibration=x, **kwargs)
    assert det.backend == kwargs["backend"] and det.params is None and det.model is None
    assert int(det.run(x)["count"].sum()) > 0


@pytest.fixture(scope="module")
def fresh_processes():
    """The module's two fresh-process checks, started together at its first
    test so that they run beside the tests in between: the port imported
    alone, and chip_smoke.py without a card."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = {"imports": subprocess.Popen([sys.executable, "-c", IMPORTS_CODE], cwd=ROOT, env=env,
                                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True)}
    if not torch.cuda.is_available():
        procs["chip_smoke"] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


IMPORTS_CODE = (
    "import sys\n"
    "import yolofastest_torch, yolofastest_torch.inference, yolofastest_torch.kernels\n"
    "import yolofastest_torch.cli, yolofastest_torch.cli.detect, yolofastest_torch.ops\n"
    "import yolofastest_torch.cli.serve, yolofastest_torch.kernels.nms\n"
    "import yolofastest_torch.models, yolofastest_torch.models.prune\n"
    "import yolofastest_torch.inference.streaming, yolofastest_torch.inference.server\n"
    "import yolofastest_torch.inference.sliced, yolofastest_torch.inference.track\n"
    "import yolofastest_torch.inference.video, yolofastest_torch.utils.logging\n"
    "import yolofastest_torch.utils.visualize\n"
    "import yolofastest_torch.train, yolofastest_torch.eval, yolofastest_torch.data\n"
    "import yolofastest_torch.losses, yolofastest_torch.models.yolo_fastest\n"
    "import yolofastest_torch.cli.train, yolofastest_torch.cli.evaluate\n"
    "import yolofastest_torch.utils.metrics\n"
    "import yolofastest_torch.export, yolofastest_torch.quant, yolofastest_torch.cli.export\n"
    "import yolofastest_torch.quant.ptq, yolofastest_torch.quant.sensitivity\n"
    "import yolofastest_torch.quant.zoo, yolofastest_torch.quant.qat\n"
    "import yolofastest_torch.models.summary, yolofastest_torch.cli.quantize\n"
    "import yolofastest_torch.models.torch_io, yolofastest_torch.export.torchscript\n"
    "import yolofastest_torch.native, yolofastest_torch.native.engine\n"
    "import yolofastest_torch.data.anchors, yolofastest_torch.data.txt2xml\n"
    "import yolofastest_torch.data.lmdb_reader, yolofastest_torch.cli.datatools\n"
    "import yolofastest_torch.cli.info\n"
    "import yolofastest_torch.parallel, yolofastest_torch.parallel.distributed\n"
    "import yolofastest_torch.parallel.mesh, yolofastest_torch.parallel.dryrun\n"
    "import yolofastest_torch.parallel.worker, yolofastest_torch.utils.profiling\n"
    "import yolofastest_torch.parallel.halo\n"
    "import yolofastest_torch.export.pt2, yolofastest_torch.export.generic_onnx\n"
    "import yolofastest_torch.utils\n"
    "import yolofastest_torch.eval.golden, yolofastest_torch.eval.golden_suite\n"
    "import yolofastest_torch.quant.recipes\n"
    "sys.path.insert(0, 'tools')\n"
    "import torch_golden_suite, torch_make_int8_zoo, torch_make_lite_seed\n"
    "import torch_search_int8_recipe2, torch_search_pruned_int8\n"
    "import torch_make_finetune_set, torch_determinism_check\n"
    "bad = [m for m in sys.modules if 'flax' in m or 'yolofastest_tpu' in m]\n"
    "bad += [m for m in ('jax', 'jaxlib') if m in sys.modules]\n"
    "print(bad)\n"
    "sys.exit(1 if bad else 0)\n")


def test_package_imports_no_jax_package(fresh_processes):
    """A fresh process that imports the port, and the deployment and training
    tools of ``tools/torch_*.py``, loads no yolofastest_tpu, flax, jax or jaxlib
    module (as tests/test_export_torch.py:83-89 checks the exporter)."""
    out, err = fresh_processes["imports"].communicate(timeout=300)
    assert fresh_processes["imports"].returncode == 0, out + err


def test_sources_import_no_jax():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|yolofastest_tpu)\b", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "tools", f"torch_{t}.py") for t in (
            "golden_suite", "make_int8_zoo", "make_lite_seed", "search_int8_recipe2",
            "search_pruned_int8", "make_finetune_set", "determinism_check")]
    for d, _, files in os.walk(os.path.join(ROOT, "yolofastest_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    for module in ("export/onnx.py", "export/ncnn.py", "export/caffe.py", "export/native.py",
                   "export/torchscript.py", "quant/ptq.py", "quant/sensitivity.py",
                   "quant/zoo.py", "quant/qat.py", "models/torch_io.py",
                   "models/summary.py", "cli/export.py", "cli/quantize.py", "native/__init__.py",
                   "native/engine.py", "data/anchors.py", "data/txt2xml.py",
                   "data/lmdb_reader.py", "cli/datatools.py", "cli/info.py",
                   "parallel/halo.py", "export/pt2.py", "export/generic_onnx.py",
                   "eval/golden.py", "eval/golden_suite.py", "quant/recipes.py"):
        assert os.path.join(ROOT, "yolofastest_torch", module) in paths, module
    for p in paths:
        with open(p) as f:
            assert not banned.search(f.read()), p


def test_chip_smoke_fails_without_card(fresh_processes):
    """chip_smoke.py exits non-zero and prints no ok line when there is no
    CUDA card (here: the CPU host)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run in full")
    out, _ = fresh_processes["chip_smoke"].communicate(timeout=300)
    assert fresh_processes["chip_smoke"].returncode != 0
    assert '"ok": true' not in out


def test_cli_detect_cpu(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from yolofastest_torch.cli import main

    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    data = tmp_path / "data"
    data.mkdir()
    frames = make_frames(fx["pre_imgs"][:3])
    for i, f in enumerate(frames):
        cv2.imwrite(str(data / f"im{i}.png"), f)
    out = tmp_path / "out"
    rc = main(["detect", "--config", "256x320", "--weights", zoo_path("256x320"),
               "--data", str(data), "--out", str(out), "--batch", "2", "--device", "cpu"])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["detect_info.log", "result_im0.png",
                                       "result_im1.png", "result_im2.png"]
    log = (out / "detect_info.log").read_text().splitlines()
    per_image = [ln for ln in log if "image_name:" in ln]
    assert len(per_image) == 3
    assert all("detect finished, infer time:" in ln and "total time:" in ln
               for ln in per_image)
    assert re.search(r"——detect avg_time: [0-9.]+ms$", log[-1])
    # a missing .pth fails in torch.load, as in the JAX package's loader
    with pytest.raises(FileNotFoundError):
        main(["detect", "--weights", "w.pth", "--data", str(data), "--out", str(out),
              "--device", "cpu"])


# ------------------------------------- against the JAX Detector (the pool), last

def _jax_detector(weights, raw):
    """The JAX Detector's detections (numpy) from the golden frames (a worker
    of tests/_jax_refs.py): ``run_raw`` on the first two as uint8 frames, or
    ``run`` on all 20 net inputs."""
    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.inference import Detector as JDetector

    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    jdet = JDetector(jget_config("256x320"), fold_bn=True, variables=load_variables(
        os.path.join(ROOT, "weights", f"yolofastest_{weights}.npz")))
    if raw:
        out = jdet.run_raw(jnp.asarray(make_frames(fx["pre_imgs"][:2])))
    else:
        out = jdet.run(jnp.asarray((fx["pre_imgs"].astype(np.float32)[..., None] - 128.0) / 255.0))
    return {k: np.asarray(v) for k, v in out.items()}


register("detector/run_raw", _jax_detector, lambda: ("256x320", True),
         tests=("test_run_raw_matches_jax_detector",))
register("detector/pruned040", _jax_detector, lambda: ("pruned040_256x320", False),
         tests=("test_pruned040_matches_jax_detector",))


def test_run_raw_matches_jax_detector(setup, jax_refs):  # noqa: F811
    """Same numpy weights, same frames, fp32 on both sides: equal counts and
    classes, boxes within 1 px (summation order only)."""
    _, fx, det = setup
    frames = make_frames(fx["pre_imgs"][:2])
    theirs = jax_refs["detector/run_raw"]
    ours = {k: v.numpy() for k, v in det.run_raw(frames).items()}
    np.testing.assert_array_equal(ours["count"], theirs["count"])
    np.testing.assert_array_equal(ours["valid"], theirs["valid"])
    assert ours["count"].sum() == 4  # both frames hold golden boxes
    for b in range(2):
        n = int(theirs["count"][b])
        np.testing.assert_array_equal(ours["cls_idx"][b, :n], theirs["cls_idx"][b, :n])
        np.testing.assert_allclose(ours["boxes"][b, :n], theirs["boxes"][b, :n], atol=1.0)
        np.testing.assert_allclose(ours["conf"][b, :n], theirs["conf"][b, :n], atol=1e-4)


def test_pruned040_matches_jax_detector(jax_refs):  # noqa: F811
    """The pruned checkpoint (inner widths 8..136) on all 20 frames: the same
    detections as the JAX Detector (counts, classes, boxes within 1 px), and
    the same golden recall by both rules: 34/34 by the golden suite's IoU >
    0.5 (tools/run_golden_suite.py:37-47), 27/34 within 3 px."""
    variables = load_variables(os.path.join(ROOT, "weights",
                                            "yolofastest_pruned040_256x320.npz"))
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    x = (fx["pre_imgs"].astype(np.float32)[..., None] - 128.0) / 255.0
    ours = Detector(get_config("256x320"), variables=variables, device="cpu").run(x)
    theirs = jax_refs["detector/pruned040"]
    np.testing.assert_array_equal(ours["count"].numpy(), theirs["count"])
    rows, jrows = detections_to_lists(ours), detections_to_lists(theirs)
    for mine, ref in zip(rows, jrows):
        assert [r[6] for r in mine] == [r[6] for r in ref]
        np.testing.assert_allclose([r[:4] for r in mine], [r[:4] for r in ref], atol=1.0)

    g = fx["boxes"]
    by_iou = sum(any(int(r[6]) == int(b[7]) and box_iou(r[:4], b[1:5]) > 0.5
                     for r in rows[int(b[0])]) for b in g)
    by_px = sum(any(int(r[6]) == int(b[7]) and max(abs(np.array(r[:4]) - b[1:5])) <= 3.0
                    for r in rows[int(b[0])]) for b in g)
    assert (by_iou, by_px) == (34, 27)
