"""The golden deployment rules: the inputs, the matching rule, the
post-processing and the three int8 recalls of one deployment.

The shared part of ``tools/run_golden_suite.py``,
``tools/search_int8_recipe2.py`` and ``tools/search_pruned_int8.py``, which
the port's deployment matrix (:mod:`yolofastest_torch.eval.golden_suite`)
and int8 recipes (:mod:`yolofastest_torch.quant.recipes`) share:

* :func:`golden_inputs`: the 20 golden frames of a resolution as net inputs,
  ``(pre_imgs - 128) / 255``, and the golden boxes (``tests/fixtures``);
* :func:`recall_vs_golden` (a batch's detections) and :func:`recall_rows`
  (the native engine's rows, image by image): a golden row is found by a
  detection of the same class with IoU > 0.5;
* :func:`post`: decode and class-aware NMS at the config's ``io``
  thresholds (on the card, the NMS kernel);
* :func:`fp_recall`: a checkpoint's fp32 recall through the folded graph
  (the training recipes' golden check);
* :func:`score_int8`: the per-layer, fused and native recalls of one int8
  deployment (folded weights, activation scales, the layers kept in fp).

Weights reach every forward as arguments (tensors made from the numpy
tree), never as constants of a compiled program: in JAX, closed-over
weights were constant-folded with another bf16 rounding and flipped one
detection (``tools/run_golden_suite.py:133-137``).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolofastest_torch.configs import Config
from yolofastest_torch.ops import batched_nms, decode_heads

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")


def golden_inputs(res: str, frames: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """``(imgs, golden)``: the first ``frames`` golden frames (all 20 when
    None) as (N, H, W, 1) float32 net inputs and the golden rows of those
    frames, ``[b, x1, y1, x2, y2, conf, cls_score, cls]``."""
    fx = np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
    imgs = (fx["pre_imgs"][:frames].astype(np.float32)[..., None] - 128.0) / 255.0
    golden = fx["boxes"]
    return imgs, golden[golden[:, 0] < len(imgs)]


def iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def _found(row, boxes, classes) -> bool:
    return any(int(c) == int(row[7]) and iou(bx, row[1:5]) > 0.5
               for bx, c in zip(boxes, classes))


def matched_rows(det: Dict[str, Any], golden: np.ndarray) -> np.ndarray:
    """One bool a golden row: found among the first ``count`` detections of
    its image (``det``: numpy ``boxes``, ``cls_idx``, ``count``)."""
    found = []
    for row in golden:
        b = int(row[0])
        n = int(det["count"][b])
        found.append(_found(row, det["boxes"][b, :n], det["cls_idx"][b, :n]))
    return np.array(found, bool)


def recall_vs_golden(det: Dict[str, Any], golden: np.ndarray) -> Tuple[int, int]:
    """``(matched, len(golden))`` over a batch's fetched detections."""
    return int(matched_rows(det, golden).sum()), len(golden)


def recall_rows(rows: Sequence[Sequence[Sequence[float]]], golden: np.ndarray) -> Tuple[int, int]:
    """``(matched, len(golden))`` over per-image rows ``[x1, y1, x2, y2,
    conf, cls_score, cls]``, as :meth:`NativeEngine.detect` returns them."""
    m = sum(_found(row, [r[:4] for r in rows[int(row[0])]], [r[6] for r in rows[int(row[0])]])
            for row in golden)
    return int(m), len(golden)


def post(heads, io) -> Dict[str, torch.Tensor]:
    """Decode and class-aware NMS at ``io``'s thresholds."""
    b, c, s, ci, v = decode_heads(heads, io.anchors, io.input_hw, io.conf_thre, io.max_decode)
    return batched_nms(b, c, s, ci, v, iou_thre=io.nms_thre, max_det=io.max_det)


def fetch(det: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in det.items()}


def fp_recall(variables, res_or_cfg, device=None) -> Tuple[int, int]:
    """``(matched, rows)``: the fp32 golden recall of a trainable-layout
    ``variables`` tree through the folded graph on ``device`` (the card
    unless the caller asks for the CPU), as the deployed :class:`Detector`
    runs it: on the card its six chains are the chain kernel and its NMS
    the NMS kernel."""
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector

    cfg = get_config(res_or_cfg) if isinstance(res_or_cfg, str) else res_or_cfg
    imgs, golden = golden_inputs(f"{cfg.io.input_hw[0]}x{cfg.io.input_hw[1]}")
    det = Detector(cfg, variables=variables, device=device)
    with torch.inference_mode():
        return recall_vs_golden(fetch(post(det.forward_heads(imgs), cfg.io)), golden)


def native_rows(engine, imgs: np.ndarray) -> List[List[List[float]]]:
    return [engine.detect(img) for img in imgs]


def native_int8_recall(folded, scales: Dict[str, float], keep_fp: Sequence[str], cfg: Config,
                       imgs: np.ndarray, golden: np.ndarray) -> Tuple[int, int]:
    """The native engine's recall of an int8 deployment: its hybrid tree
    (:func:`mixed_native_tree`) written as a ``.yfb`` in a temporary
    directory and run image by image on the host CPU."""
    from yolofastest_torch.export import save_native_weights
    from yolofastest_torch.native import NativeEngine
    from yolofastest_torch.quant import mixed_native_tree

    tree, nscales = mixed_native_tree(folded, scales, tuple(keep_fp))
    with tempfile.TemporaryDirectory(prefix="yf_golden_") as td:
        yfb = os.path.join(td, "m.yfb")
        save_native_weights(tree, yfb, act_scales=nscales, io_config=cfg.io)
        engine = NativeEngine(yfb, cfg)
        return recall_rows(native_rows(engine, imgs), golden)


def int8_recalls(folded, scales: Dict[str, float], keep_fp: Sequence[str], cfg: Config,
                 imgs: np.ndarray, golden: np.ndarray, device) -> Tuple[int, int]:
    """The per-layer and fused int8 recalls (``quantized_apply`` and
    ``quantized_apply_fused``, or their ``_mixed`` forms with ``keep_fp``)
    on ``device``."""
    from yolofastest_torch.quant import QuantParams, quantize_weights, sensitivity
    from yolofastest_torch.quant.ptq import quantized_apply, quantized_apply_fused

    qp = QuantParams(quantize_weights(folded), device)
    x = torch.from_numpy(np.ascontiguousarray(imgs)).to(device)
    out = []
    with torch.inference_mode():
        if keep_fp:
            fp = sensitivity.fp_params(folded, keep_fp, device)
            for fn in (sensitivity.quantized_apply_mixed, sensitivity.quantized_apply_fused_mixed):
                out.append(fn(qp, fp, scales, x, fp_layers=tuple(keep_fp)))
        else:
            out = [fn(qp, scales, x) for fn in (quantized_apply, quantized_apply_fused)]
        dets = [fetch(post(heads, cfg.io)) for heads in out]
    return tuple(recall_vs_golden(d, golden)[0] for d in dets)


def score_int8(folded, scales: Dict[str, float], keep_fp: Sequence[str], res_or_cfg,
               device=None, imgs: Optional[np.ndarray] = None,
               golden: Optional[np.ndarray] = None) -> Tuple[int, int, int]:
    """``(per-layer, fused, native)`` golden recalls of one int8 deployment
    on ``device`` (the card unless the caller asks for the CPU; the native
    engine runs on the host CPU).  ``res_or_cfg``: a resolution preset or a
    :class:`Config`; ``imgs`` and ``golden`` default to its 20 golden
    frames."""
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.utils.device import resolve_device

    cfg = get_config(res_or_cfg) if isinstance(res_or_cfg, str) else res_or_cfg
    if imgs is None:
        imgs, golden = golden_inputs(f"{cfg.io.input_hw[0]}x{cfg.io.input_hw[1]}")
    r_pl, r_fu = int8_recalls(folded, scales, keep_fp, cfg, imgs, golden, resolve_device(device))
    r_na, _ = native_int8_recall(folded, scales, keep_fp, cfg, imgs, golden)
    return r_pl, r_fu, r_na
