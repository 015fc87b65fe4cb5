"""Class-aware greedy NMS with fixed output shapes, batched.

The port of ``yolofastest_tpu/ops/nms.py``.  Candidates come in
conf-descending order; ``iou > iou_thre`` within the same class suppresses
(strict, ``pixel_offset=0`` for the detect path).  The greedy chain ("a box
suppresses only if it survived itself") is a plain loop over rows, batched
over images.  Rows after the last valid candidate of every image can suppress
nothing, so the loop stops there: one host read of that row count, instead of
the JAX package's fixed K steps, with the same result.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from yolofastest_torch.ops.boxes import box_iou_matrix


def _keep_mask(boxes, cls_idx, valid, iou_thre: float, pixel_offset: float):
    """Greedy keep mask for a batch: (B, K, 4), (B, K), (B, K) -> (B, K)."""
    k = boxes.shape[1]
    iou = box_iou_matrix(boxes, boxes, pixel_offset=pixel_offset)  # (B, K, K)
    same_class = cls_idx[:, :, None] == cls_idx[:, None, :]
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool, device=boxes.device), 1)
    suppress = (iou > iou_thre) & same_class & upper & valid[:, :, None]
    keep = valid.clone()
    rows = torch.nonzero(valid.any(dim=0)).flatten()
    n = int(rows[-1]) + 1 if rows.numel() else 0
    for i in range(n):
        # candidate i removes later ones only if it itself survived
        keep &= ~(suppress[:, i] & keep[:, i:i + 1])
    return keep


def nms_keep_mask(boxes, conf, cls_idx, valid, iou_thre: float,
                  pixel_offset: float = 0.0):
    """Greedy class-aware keep mask for one image (K candidates)."""
    return _keep_mask(boxes[None], cls_idx[None], valid[None], iou_thre,
                      pixel_offset)[0]


def batched_nms(boxes, conf, cls_score, cls_idx, valid, iou_thre: float,
                max_det: int = 64, pixel_offset: float = 0.0,
                packed: bool = False):
    """Batched class-aware NMS.

    Args:
      boxes: (B, K, 4) xyxy, conf-descending per image.
      conf: (B, K) objectness; cls_score: (B, K); cls_idx: (B, K) int32.
      valid: (B, K) bool candidate mask.
      iou_thre: suppression threshold.
      max_det: output size per image.
      pixel_offset: IOU convention (0 = detect NMS, 1 = training utils).
      packed: return ONE (B, max_det, 8) float32 tensor
        ``(x1, y1, x2, y2, conf, cls_score, cls_idx, valid)`` instead of a
        dict (see :func:`unpack_detections`).

    Returns:
      dict with ``boxes`` (B,max_det,4), ``conf``, ``cls_score``, ``cls_idx``,
      ``valid`` (B,max_det) and ``count`` (B,), conf-descending, kept rows
      first; or the packed tensor when ``packed=True``.
    """
    keep = _keep_mask(boxes, cls_idx, valid, iou_thre, pixel_offset)

    # Compact kept-first; the stable sort keeps the conf-descending order.
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :max_det]
    stacked = torch.cat(
        [
            boxes,
            conf[..., None],
            cls_score[..., None],
            cls_idx.to(torch.float32)[..., None],
            keep.to(torch.float32)[..., None],
        ],
        dim=-1,
    )  # (B, K, 8)
    picked = torch.gather(stacked, 1, order[..., None].expand(-1, -1, 8))
    if packed:
        return picked  # (B, max_det, 8)
    return {
        "boxes": picked[..., 0:4],
        "conf": picked[..., 4],
        "cls_score": picked[..., 5],
        "cls_idx": picked[..., 6].to(torch.int32),
        "valid": picked[..., 7] > 0.5,
        "count": keep.to(torch.int32).sum(dim=1).clamp(0, max_det),
    }


def unpack_detections(packed) -> Dict:
    """Host-side inverse of ``batched_nms(..., packed=True)``: one fetched
    (B, max_det, 8) array or tensor -> the standard detection dict (numpy)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    valid = packed[..., 7] > 0.5
    return {
        "boxes": packed[..., 0:4],
        "conf": packed[..., 4],
        "cls_score": packed[..., 5],
        "cls_idx": packed[..., 6].astype(np.int32),
        "valid": valid,
        "count": valid.sum(axis=-1).astype(np.int32),
    }
