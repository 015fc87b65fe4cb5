"""Class-aware greedy NMS with fixed output shapes, batched.

The port of ``yolofastest_tpu/ops/nms.py``.  Candidates come in
conf-descending order; ``iou > iou_thre`` within the same class suppresses
(strict, ``pixel_offset=0`` for the detect path).  The greedy keep mask is
:func:`yolofastest_torch.kernels.nms.nms_keep`: a CUDA kernel on the
card, with no host read, and its plain loop on the CPU.  The compaction that
follows (a stable argsort and a gather) is plain torch and reads nothing back
either, so a detect call returns before the card is done.
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
    keep = nms_kernel.nms_keep(boxes, cls_idx, valid, iou_thre, pixel_offset)

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
