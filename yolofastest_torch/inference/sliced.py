"""Sliced (tiled) inference for images larger than the net input.

The port of ``yolofastest_tpu/inference/sliced.py``.  A frame squeezed to
one 256x320 input loses small objects; SAHI-style slicing runs the detector
over a grid of overlapping crops, each at full net resolution:

* the tile grid is fixed per (image size, grid, overlap), and all R*C tiles
  run as ONE batch through :meth:`Detector.run_packed`: one dispatch, one
  packed fetch;
* mapping boxes back to origin pixels and the cross-tile merge are host
  numpy; duplicates in the overlap bands resolve in one global class-aware
  greedy NMS with the +1 px IOU convention of the JAX package's merge.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def tile_grid(origin_hw: Tuple[int, int], grid: Tuple[int, int],
              overlap: float = 0.2) -> List[Tuple[int, int, int, int]]:
    """(y0, x0, y1, x1) origin-pixel windows for an R x C grid.

    Tile size is chosen so neighbouring tiles share ``overlap`` of their
    extent and the grid exactly covers the image (first tile starts at 0,
    last ends at the image edge; interior starts are evenly spaced and
    rounded to integers).
    """
    if not (0.0 <= overlap < 1.0):
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    rows, cols = grid
    if rows < 1 or cols < 1:
        raise ValueError(f"grid must be >= 1x1, got {grid}")
    h0, w0 = origin_hw

    def axis(n: int, size: int) -> List[Tuple[int, int]]:
        if n == 1:
            return [(0, size)]
        # n tiles of extent t with stride t*(1-overlap) spanning `size`:
        # (n-1)*stride + t = size
        t = size / (n - (n - 1) * overlap)
        stride = (size - t) / (n - 1)
        spans = []
        for i in range(n):
            a = int(round(i * stride))
            b = size if i == n - 1 else min(size, int(round(i * stride + t)))
            spans.append((a, b))
        return spans

    return [(y0, x0, y1, x1)
            for y0, y1 in axis(rows, h0)
            for x0, x1 in axis(cols, w0)]


def _greedy_nms(boxes: np.ndarray, scores: np.ndarray, cls_idx: np.ndarray,
                iou_thre: float) -> np.ndarray:
    """Class-aware greedy NMS with the +1 px IOU convention; returns kept
    indices, highest score first."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    alive = np.ones(len(boxes), bool)
    for i in order:
        if not alive[i]:
            continue
        keep.append(i)
        iw = np.minimum(x2, x2[i]) - np.maximum(x1, x1[i]) + 1.0
        ih = np.minimum(y2, y2[i]) - np.maximum(y1, y1[i]) + 1.0
        inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
        iou = inter / (area + area[i] - inter + 1e-16)
        alive &= ~((iou > iou_thre) & (cls_idx == cls_idx[i]))
    return np.asarray(keep, np.int64)


def sliced_detect(detector, ori: np.ndarray,
                  grid: Tuple[int, int] = (2, 2),
                  overlap: float = 0.2) -> Dict[str, np.ndarray]:
    """Detect on ONE origin-resolution BGR image via overlapping tiles.

    Args:
      detector: anything with ``config`` and ``run_packed`` (the port's
        :class:`Detector`); the tile batch is a (R*C, H, W, 1) input.
      ori: (H0, W0, 3) uint8 BGR image at any resolution.
      grid: (rows, cols) tile grid; (1, 1) degrades to plain detection.
      overlap: fraction of tile extent shared by neighbours (duplicates in
        the bands are merged by the global NMS).

    Returns the standard single-image detection dict (numpy): ``boxes``
    (N, 4) origin pixels, ``conf``, ``cls_score``, ``cls_idx``, ``count``.
    """
    from yolofastest_torch.inference.detector import image_to_net_input
    from yolofastest_torch.ops import unpack_detections

    io = detector.config.io
    windows = tile_grid(ori.shape[:2], grid, overlap)
    batch = np.stack([
        image_to_net_input(ori[y0:y1, x0:x1], io) for y0, x0, y1, x1 in windows
    ])

    det = unpack_detections(detector.run_packed(batch))

    net_h, net_w = io.input_hw
    all_boxes, all_conf, all_cls_score, all_cls = [], [], [], []
    for k, (y0, x0, y1, x1) in enumerate(windows):
        n = int(det["count"][k])
        if n == 0:
            continue
        v = det["valid"][k]
        b = det["boxes"][k][v].astype(np.float64)
        # net-input pixels -> this tile's origin pixels (same rounding as
        # Detector.adjust_coords, per tile)
        b[:, [0, 2]] = np.round(b[:, [0, 2]] * ((x1 - x0) / net_w)) + x0
        b[:, [1, 3]] = np.round(b[:, [1, 3]] * ((y1 - y0) / net_h)) + y0
        all_boxes.append(b)
        all_conf.append(det["conf"][k][v])
        all_cls_score.append(det["cls_score"][k][v])
        all_cls.append(det["cls_idx"][k][v])

    if not all_boxes:
        z = np.zeros((0,), np.float32)
        return {"boxes": np.zeros((0, 4), np.float64), "conf": z,
                "cls_score": z, "cls_idx": np.zeros((0,), np.int32),
                "count": 0}

    boxes = np.concatenate(all_boxes)
    conf = np.concatenate(all_conf)
    cls_score = np.concatenate(all_cls_score)
    cls_idx = np.concatenate(all_cls)
    keep = _greedy_nms(boxes, conf * cls_score, cls_idx, io.nms_thre)
    return {"boxes": boxes[keep], "conf": conf[keep],
            "cls_score": cls_score[keep], "cls_idx": cls_idx[keep],
            "count": len(keep)}
