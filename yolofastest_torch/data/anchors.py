"""Auto-anchor: IoU k-means over a dataset's ground-truth box shapes.

The port's copy of ``yolofastest_tpu/data/anchors.py`` (numpy only; the
k-means draws from ``default_rng(seed)`` in the same order, so one seed
gives the same anchors in both packages).

The reference ships three hand-picked anchor groups and a comment saying
which resolutions use which (``src/model_training/_config.py:5-9``) — there
is no tool to derive anchors for a NEW dataset, even though anchor fit
directly bounds recall (a GT whose shape matches no anchor is assigned a
poor regression target).  This module closes that gap:

* :func:`collect_wh` — every GT (w, h) in net-input pixels,
* :func:`kmeans_anchors` — deterministic IoU-distance k-means (the classic
  darknet/YOLOv2 recipe: distance = 1 - IoU of the two shapes anchored at a
  common center),
* :func:`mean_best_iou` — the fit metric (mean over GTs of the best anchor
  IoU): the number that says whether new anchors beat the shipped ones,
* :func:`anchor_groups` — split k anchors into per-scale groups, smallest
  first, matching ``IOConfig.anchors`` / ``IOConfig.strides`` order
  (finest stride pairs with the smallest anchors).

Everything is plain numpy: anchor search is a one-shot host tool.  CLI:
``python -m yolofastest_torch anchors --data DIR``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Array = np.ndarray


def collect_wh(index, config) -> Array:
    """(N, 2) float32 GT box shapes in NET-INPUT pixels.

    ``index`` is any sequence of ``(img_path, labels)`` with labels rows
    ``(cls, x1, y1, x2, y2)`` in original-image pixels (VOCIndex/COCOIndex).
    Degenerate (non-positive) boxes are dropped.
    """
    h0, w0 = config.io.origin_img_shape[0], config.io.origin_img_shape[1]
    h, w = config.io.input_hw
    sx, sy = w / float(w0), h / float(h0)
    out = []
    for _, labels in index:
        if len(labels) == 0:
            continue
        b = np.asarray(labels, np.float32).reshape(-1, 5)
        bw = (b[:, 3] - b[:, 1]) * sx
        bh = (b[:, 4] - b[:, 2]) * sy
        keep = (bw > 0) & (bh > 0)
        out.append(np.stack([bw[keep], bh[keep]], axis=1))
    if not out:
        raise ValueError("dataset contains no ground-truth boxes")
    return np.concatenate(out).astype(np.float32)


def shape_iou(wh: Array, anchors: Array) -> Array:
    """(N, K) IoU of each GT shape against each anchor shape, both anchored
    at a common center — the same shape-only IOU the loss's target
    assignment uses (reference ``yolo_loss.py:176-182``)."""
    wh = np.asarray(wh, np.float32)[:, None, :]  # (N, 1, 2)
    an = np.asarray(anchors, np.float32)[None, :, :]  # (1, K, 2)
    inter = np.minimum(wh[..., 0], an[..., 0]) * np.minimum(wh[..., 1], an[..., 1])
    union = wh[..., 0] * wh[..., 1] + an[..., 0] * an[..., 1] - inter
    return inter / np.maximum(union, 1e-9)


def mean_best_iou(wh: Array, anchors) -> float:
    """Mean over GTs of the best-anchor shape IoU (higher = better fit)."""
    an = np.asarray(anchors, np.float32).reshape(-1, 2)
    return float(shape_iou(wh, an).max(axis=1).mean())


def kmeans_anchors(wh: Array, k: int, seed: int = 0,
                   iters: int = 300) -> Array:
    """IoU-distance k-means; returns (k, 2) anchors sorted by area ascending.

    Deterministic: k-means++ style farthest-point seeding from ``seed``,
    mean-shape cluster updates, converges when assignments stop changing.
    Empty clusters are re-seeded to the worst-fitting GT shape.
    """
    wh = np.asarray(wh, np.float32).reshape(-1, 2)
    n = len(wh)
    if n < k:
        raise ValueError(f"need at least k={k} boxes, got {n}")
    rng = np.random.default_rng(seed)

    # k-means++ seeding on 1-IoU distance.
    centers = [wh[rng.integers(n)]]
    for _ in range(1, k):
        d = 1.0 - shape_iou(wh, np.stack(centers)).max(axis=1)
        p = d / max(d.sum(), 1e-9)
        centers.append(wh[rng.choice(n, p=p)])
    anchors = np.stack(centers)

    assign = np.full(n, -1)
    for _ in range(iters):
        new_assign = shape_iou(wh, anchors).argmax(axis=1)
        if np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            members = wh[assign == j]
            if len(members):
                anchors[j] = members.mean(axis=0)
            else:  # re-seed an empty cluster to the worst-fitting shape
                worst = (1.0 - shape_iou(wh, anchors).max(axis=1)).argmax()
                anchors[j] = wh[worst]
    order = np.argsort(anchors[:, 0] * anchors[:, 1])
    return anchors[order]


def anchor_groups(anchors: Array, num_scales: int) -> Tuple[Tuple[Tuple[float, float], ...], ...]:
    """Split (k, 2) area-sorted anchors into ``num_scales`` equal groups in
    ``IOConfig.anchors`` layout: group 0 (smallest shapes) pairs with the
    finest stride, exactly how the presets lay out the reference's groups
    (``configs/config.py``)."""
    anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    k = len(anchors)
    if k % num_scales:
        raise ValueError(f"{k} anchors do not split into {num_scales} scales")
    per = k // num_scales
    return tuple(
        tuple((round(float(w), 2), round(float(h), 2))
              for w, h in anchors[s * per:(s + 1) * per])
        for s in range(num_scales)
    )
