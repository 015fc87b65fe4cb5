"""Class-aware greedy NMS with fixed output shapes, batched.

The port of ``yolofastest_tpu/ops/nms.py``.  Candidates come in
conf-descending order; ``iou > iou_thre`` within the same class suppresses
(strict, ``pixel_offset=0`` for the detect path).  The keep mask and the
kept-first compaction are one call,
:func:`yolofastest_torch.kernels.nms.nms_packed`: one CUDA kernel launch on
the card, with no host read, so a detect call returns before the card is
done; its plain version on the CPU.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# the module, not its function: kernels.nms imports ops.boxes, so either
# package may be imported first
from yolofastest_torch.kernels import nms as nms_kernel


def nms_keep_mask(boxes, conf, cls_idx, valid, iou_thre: float,
                  pixel_offset: float = 0.0):
    """Greedy class-aware keep mask for one image (K candidates)."""
    return nms_kernel.nms_keep(boxes[None], cls_idx[None], valid[None], iou_thre,
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
    rows, keep = nms_kernel.nms_packed(boxes, conf, cls_score, cls_idx, valid, iou_thre,
                                       max_det, pixel_offset)
    if packed:
        return rows  # (B, min(K, max_det), 8)
    return {
        "boxes": rows[..., 0:4],
        "conf": rows[..., 4],
        "cls_score": rows[..., 5],
        "cls_idx": rows[..., 6].to(torch.int32),
        "valid": rows[..., 7] > 0.5,
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
