"""Box coordinate utilities and IOU on tensors.

The port of ``yolofastest_tpu/ops/boxes.py``.  Two IOU conventions:
``pixel_offset=0`` is the postprocess NMS (plain ``(x2-x1)`` areas), and
``pixel_offset=1`` the training/validation ``+1`` pixel convention.
"""

from __future__ import annotations

import torch


def xyxy2xywh(x):
    """(x1,y1,x2,y2) -> (cx,cy,w,h) along the last axis."""
    x1, y1, x2, y2 = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    return torch.cat([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def xywh2xyxy(x):
    """(cx,cy,w,h) -> (x1,y1,x2,y2) along the last axis."""
    cx, cy, w, h = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def iou_pairwise(a, b, pixel_offset: float = 0.0, eps: float = 0.0):
    """Element-wise IOU of two broadcast-compatible xyxy box tensors."""
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    iw = torch.clamp(ix2 - ix1 + pixel_offset, min=0.0)
    ih = torch.clamp(iy2 - iy1 + pixel_offset, min=0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0] + pixel_offset) * (a[..., 3] - a[..., 1] + pixel_offset)
    area_b = (b[..., 2] - b[..., 0] + pixel_offset) * (b[..., 3] - b[..., 1] + pixel_offset)
    return inter / (area_a + area_b - inter + eps)


def box_iou_matrix(a, b, pixel_offset: float = 0.0, eps: float = 0.0):
    """Full IOU matrix between ``a`` (..., N, 4) and ``b`` (..., M, 4) ->
    (..., N, M)."""
    return iou_pairwise(a[..., :, None, :], b[..., None, :, :],
                        pixel_offset=pixel_offset, eps=eps)
