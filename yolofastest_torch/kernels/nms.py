"""Greedy class-aware NMS keep mask: the CUDA kernel and its plain version.

The JAX package computes this mask (``yolofastest_tpu/ops/nms.py``,
``nms_keep_mask``) as a ``lax.fori_loop`` on the device; no Pallas kernel
stands behind it.  The plain version here is a Python loop over rows, batched
over images, that first reads the last valid row back to the host.  On the
card that read made every detect call wait for the card, so
:func:`nms_keep` launches ``csrc/nms.cu`` instead: one thread block per
image, no host read.

Both give the same bits: the kernel computes the IOU of
``ops/boxes.py::iou_pairwise`` with the same float32 operations in the same
order and compares it against the float32 threshold, as torch compares a
float32 tensor against a Python float.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from yolofastest_torch.kernels._build import LAUNCHES
from yolofastest_torch.ops.boxes import box_iou_matrix


def nms_keep_plain(boxes, cls_idx, valid, iou_thre: float, pixel_offset: float = 0.0):
    """Plain PyTorch version (any device): (B, K, 4), (B, K), (B, K) -> (B, K)
    bool.  Rows after the last valid candidate of every image can suppress
    nothing, so the loop stops there, after one host read of that row."""
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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    from yolofastest_torch.kernels import _build

    lib = _build.load("nms")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.yf_nms_keep.argtypes = [vp, vp, vp, vp, ci, ci, cf, cf, vp]
    lib.yf_nms_keep.restype = ci
    lib.yf_nms_max_rows.argtypes = []
    lib.yf_nms_max_rows.restype = ci
    lib.yf_nms_error_string.argtypes = [ci]
    lib.yf_nms_error_string.restype = ctypes.c_char_p
    return lib


def _launch(boxes, cls_idx, valid, iou_thre: float, pixel_offset: float):
    b, k = valid.shape
    lib = _lib()
    if k > lib.yf_nms_max_rows():
        raise ValueError(f"the NMS kernel takes at most {lib.yf_nms_max_rows()} "
                         f"candidates an image, not {k}")
    boxes = boxes.to(torch.float32).contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads one box as a float4
        boxes = boxes.clone()
    cls_idx = cls_idx.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=valid.device)
    rc = lib.yf_nms_keep(boxes.data_ptr(), cls_idx.data_ptr(), valid.data_ptr(),
                         keep.data_ptr(), b, k, float(np.float32(iou_thre)),
                         float(pixel_offset),
                         torch.cuda.current_stream(valid.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: "
                           f"{lib.yf_nms_error_string(rc).decode()} (code {rc})")
    LAUNCHES["nms_keep"] += 1
    return keep


def nms_keep(boxes, cls_idx, valid, iou_thre: float, pixel_offset: float = 0.0):
    """Greedy class-aware keep mask for a batch.

    Args:
      boxes: (B, K, 4) xyxy, conf-descending per image.
      cls_idx: (B, K) class indices; valid: (B, K) bool candidate mask.
      iou_thre: a later box of the same class is dropped where ``iou >
        iou_thre`` (compared in float32).
      pixel_offset: IOU convention (0 = detect NMS, 1 = training utils).

    Returns (B, K) bool.  Launches the CUDA kernel for tensors on the card and
    takes :func:`nms_keep_plain` only for tensors on the CPU.
    """
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or tuple(valid.shape) != tuple(boxes.shape[:2]) \
            or tuple(cls_idx.shape) != tuple(valid.shape):
        raise ValueError(f"want boxes (B, K, 4), cls_idx and valid (B, K); got "
                         f"{tuple(boxes.shape)}, {tuple(cls_idx.shape)}, {tuple(valid.shape)}")
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, cls_idx, valid, iou_thre, pixel_offset)
    if boxes.device.type != "cuda":
        raise RuntimeError(f"nms_keep runs on cuda (kernel) or cpu (plain version), "
                           f"not {boxes.device}")
    return _launch(boxes, cls_idx, valid, iou_thre, pixel_offset)
