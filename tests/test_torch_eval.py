"""The port's mAP evaluator against the JAX package's, on the CPU: the golden
frames with the golden_map targets through the training model and through
the deployed Detector, strict pycocotools mode against the canonical
cocoeval numbers, padded tail batches, and the backend adapter.

The JAX references run in the worker processes of ``tests/_jax_refs.py``,
so that their compiles overlap the port tests in between.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from yolofastest_torch.configs import get_config
from yolofastest_torch.data import ListLoader
from yolofastest_torch.eval import (COCO_IOU_GRID, MAPEvaluator, average_precision,
                                    make_backend_eval_fn)
from yolofastest_torch.inference import Detector
from yolofastest_torch.models import load_variables, zoo_path
from yolofastest_torch.utils.logging import LineLog

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _golden_batch():
    g = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    m = np.load(os.path.join(FIXTURES, "golden_map.npz"))
    return (g["pre_imgs"].astype(np.float32)[..., None] - 128.0) / 255.0, m["targets"]


def _golden_loader(batch_size=8):
    """The 20 golden frames in batches of 8, 8 and a short 4 (padded)."""
    imgs, targets = _golden_batch()
    return ListLoader([(imgs[i:i + batch_size], targets[i:i + batch_size])
                       for i in range(0, len(imgs), batch_size)], batch_size)


def _jax_golden_map(backend):
    """The JAX MAPEvaluator on the golden loader with the zoo 256x320 weights:
    the training-path evaluator, or make_backend_eval_fn over the JAX
    Detector (fold_bn=True)."""
    import jax
    import jax.numpy as jnp

    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.eval import MAPEvaluator as JMAPEvaluator
    from yolofastest_tpu.eval import make_backend_eval_fn as jmake_backend_eval_fn
    from yolofastest_tpu.inference import Detector as JDetector

    cfg = jget_config("256x320")
    v = load_variables(zoo_path("256x320"))
    if backend == "train":
        ev = JMAPEvaluator(cfg, _golden_loader())
        ev(jax.tree.map(jnp.asarray, v), epoch=0)
    else:
        det = JDetector(cfg, variables=v, fold_bn=True)
        ev = JMAPEvaluator(cfg, _golden_loader(), eval_fn=jmake_backend_eval_fn(det))
        ev(None, epoch=0)
    return ev.last_metrics


register("eval/train", _jax_golden_map, lambda: ("train",))
register("eval/fp", _jax_golden_map, lambda: ("fp",))
pytestmark = pytest.mark.usefixtures("jax_refs")  # the workers run from the first test on


@pytest.fixture(scope="module")
def zoo():
    return load_variables(zoo_path("256x320"))


def test_coco_grid_runs_on_the_model(zoo):
    """--coco-map through the training model: the grid mean, size ranges and
    AR budgets are reported; the headline stays mAP@0.5."""
    ev = MAPEvaluator(get_config("256x320"), _golden_loader(), logger=LineLog(),
                      iou_thresholds=COCO_IOU_GRID, device="cpu")
    m = ev(zoo, epoch=0)
    lm = ev.last_metrics
    assert 0.0 <= lm["mAP_grid"] <= m and set(lm["AR_maxdets"]) == {1, 10, 64}
    assert all(k in lm for k in ("AP_small", "AP_medium", "AP_large", "AR_small"))


class _StubLoader:
    def __init__(self, targets, input_hw, batch):
        self.targets, self.input_hw, self.batch_size = targets, input_hw, batch

    def __iter__(self):
        n = len(self.targets)
        for i in range(0, n, self.batch_size):
            yield (np.zeros((min(self.batch_size, n - i), *self.input_hw, 1), np.float32),
                   self.targets[i:i + self.batch_size])


def _mean_not_neg1(x):
    v = x[x > -1]
    return float(v.mean()) if v.size else -1.0


def test_strict_coco_matches_canonical_cocoeval():
    """Strict mode (standard IOU, 101-point AP) reproduces the vendored
    pycocotools numbers of cocoeval_ref.npz at 1e-9
    (tests/test_map_cocoeval.py)."""
    fx = np.load(os.path.join(FIXTURES, "cocoeval_ref.npz"))
    cfg = get_config("256x320")
    cfg = dataclasses.replace(cfg, io=dataclasses.replace(cfg.io, max_det=int(fx["max_dets"][-1])))
    batch = 4
    calls = iter([{"boxes": fx["det_boxes"][i:i + batch], "conf": fx["det_conf"][i:i + batch],
                   "cls_idx": fx["det_cls"][i:i + batch], "count": fx["det_count"][i:i + batch]}
                  for i in range(0, len(fx["det_count"]), batch)])
    ev = MAPEvaluator(cfg, _StubLoader(fx["targets"], cfg.io.input_hw, batch),
                      eval_fn=lambda *_: next(calls), iou_thresholds=COCO_IOU_GRID,
                      iou_convention="coco", ap_interpolation="coco101", logger=LineLog())
    ev(None, epoch=0)
    m = ev.last_metrics
    k = int(fx["max_dets"][-1])
    ap_all = fx[f"ap_all_{k}"]
    np.testing.assert_allclose(m["mAP_grid"], ap_all.mean(), atol=1e-9)
    np.testing.assert_allclose([m["mAP_per_iou"][float(t)] for t in fx["iou_thrs"]],
                               ap_all.mean(axis=1), atol=1e-9)
    np.testing.assert_allclose(m["per_class_ap"], ap_all[0], atol=1e-9)
    for area in ("small", "medium", "large"):
        np.testing.assert_allclose(m[f"AP_{area}"], _mean_not_neg1(fx[f"ap_{area}_{k}"]),
                                   atol=1e-9)
        np.testing.assert_allclose(m[f"AR_{area}"], _mean_not_neg1(fx[f"ar_{area}_{k}"]),
                                   atol=1e-9)
    for kk in fx["max_dets"]:
        np.testing.assert_allclose(m["AR_maxdets"][int(kk)],
                                   _mean_not_neg1(fx[f"ar_all_{int(kk)}"]), atol=1e-9)
    assert m["AR_maxdets"][10] < m["AR_maxdets"][k]


def test_strict_boundary_semantics_vs_default():
    """IOU exactly at the threshold matches and a tie keeps the LAST GT in
    strict mode; the default keeps strict > and the first maximum
    (tests/test_map_cocoeval.py:117-166)."""
    cfg = get_config("256x320")
    h, w = cfg.io.input_hw

    def row(x1, y1, x2, y2, cls):
        return [(x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h, cls, 255.0]

    targets = np.asarray([[row(0, 0, 10, 10, 0), row(0, 10, 10, 20, 0)]], np.float32)
    det = {"boxes": np.asarray([[[0, 0, 10, 20], [0, 10, 10, 20]]], np.float64),
           "conf": np.asarray([[0.9, 0.8]]), "cls_idx": np.zeros((1, 2), np.int32),
           "count": np.asarray([2], np.int32)}

    def run(**kw):
        ev = MAPEvaluator(cfg, ListLoader([(np.zeros((1, h, w, 1), np.float32), targets)], 1),
                          eval_fn=lambda *_: det, iou_thresholds=(0.5,), logger=LineLog(), **kw)
        ev(None, epoch=0)
        return ev.last_metrics["per_class_ap"][0]

    np.testing.assert_allclose(run(iou_convention="coco"), 0.5)
    np.testing.assert_allclose(run(), 1.0)
    with pytest.raises(ValueError, match="iou_convention"):
        MAPEvaluator(cfg, None, eval_fn=lambda *a: None, iou_convention="bogus")


def test_padded_tail_counts_every_target():
    """A short last batch is padded to the loader's batch shape (the eval_fn
    sees 8 images) and only its own images are matched."""
    imgs, targets = _golden_batch()
    seen = []

    def eval_fn(_v, x):
        seen.append(x.shape[0])
        return torch.zeros((x.shape[0], 64, 8))

    ev = MAPEvaluator(get_config("256x320"), _golden_loader(), eval_fn=eval_fn, logger=LineLog())
    assert ev(None) == 0.0
    assert seen == [8, 8, 8]
    assert ev.last_metrics["target_num"] == [10, 3, 20]


def test_average_precision_known_values():
    confs, is_tp = np.array([0.9, 0.8, 0.7]), np.array([True, False, True])
    np.testing.assert_allclose(average_precision(confs, is_tp, 3), 1 / 3 + (1 / 3) * (2 / 3))
    assert average_precision(confs, is_tp, 0) == 0.0
    assert average_precision(np.array([]), np.array([], bool), 3) == 0.0


def test_backend_adapter_native_raises():
    class Native:
        def detect(self, img, max_det=64):
            return []

    with pytest.raises(TypeError, match="Native engine"):
        make_backend_eval_fn(Native())
    with pytest.raises(TypeError, match="cannot adapt"):
        make_backend_eval_fn(object())


# ------------------------------------------------------- against JAX, last
def test_golden_map_matches_jax(zoo, jax_refs):
    """The training-path evaluator on the golden frames (batches of 8, a
    padded tail of 4): target_num equal to JAX's, mAP and per-class AP
    within 1e-6, the detection rate equal, and the reference's log lines."""
    log = LineLog()
    ev = MAPEvaluator(get_config("256x320"), _golden_loader(), logger=log, device="cpu")
    m = ev(zoo, epoch=3)
    ref = jax_refs["eval/train"]
    assert ev.last_metrics["target_num"] == ref["target_num"] == [10, 3, 20]
    assert abs(m - ref["mAP"]) <= 1e-6 and m > 0.3
    np.testing.assert_allclose(ev.last_metrics["per_class_ap"], ref["per_class_ap"], atol=1e-6)
    assert ev.last_metrics["detection_rate"] == ref["detection_rate"]
    assert log.lines[0] == "—————— epoch: 3 validation results —————"
    assert re.fullmatch(r"class: carrier, target_num = 10, AP = [0-9.]+", log.lines[1])
    assert re.fullmatch(r"mean AP: [0-9.]+", log.lines[4])
    assert re.fullmatch(r"detection rate: [0-9.]+ \(\d+/33 targets\)", log.lines[5])


def test_fp_backend_map_matches_jax(zoo, jax_refs):
    """The deployed Detector through make_backend_eval_fn (one packed result
    a batch) gives JAX's make_backend_eval_fn(Detector) mAP on the same
    loader."""
    det = Detector(get_config("256x320"), variables=zoo, device="cpu")
    ev = MAPEvaluator(get_config("256x320"), _golden_loader(),
                      eval_fn=make_backend_eval_fn(det), logger=LineLog())
    m = ev(None, epoch=0)
    ref = jax_refs["eval/fp"]
    assert ev.last_metrics["target_num"] == ref["target_num"]
    assert abs(m - ref["mAP"]) <= 1e-6
    np.testing.assert_allclose(ev.last_metrics["per_class_ap"], ref["per_class_ap"], atol=1e-6)
