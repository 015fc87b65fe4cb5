"""Image preprocessing on the device, bit-exact to the JAX package.

The port of ``yolofastest_tpu/ops/preprocess.py``:

* :func:`bgr_to_gray`: OpenCV's fixed-point BT.601 BGR->gray.
* :func:`downsample2x`: the exact factor-2 bilinear resize (mean of each
  2x2 block, rounded to nearest).
* :func:`resize_bilinear`: any other size; uint8 goes through OpenCV's
  fixed-point INTER_LINEAR scheme, floats through antialiased bilinear.
* :func:`normalize`: ``(x - 128) / 255``.

The integer paths run in int32 with arithmetic right shifts, exactly as the
JAX functions do, so both give the same bits.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# OpenCV CV_BGR2GRAY fixed-point coefficients: round(c * 2^14)
_CV_B = 1868  # 0.114
_CV_G = 9617  # 0.587
_CV_R = 4899  # 0.299
_CV_SHIFT = 14


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 BGR -> (..., H, W) uint8 gray, cv2-exact."""
    img = img.to(torch.int32)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    acc = b * _CV_B + g * _CV_G + r * _CV_R + (1 << (_CV_SHIFT - 1))
    return (acc >> _CV_SHIFT).to(torch.uint8)


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear downsample of (..., H, W) uint8/float -> uint8.

    With half-pixel centres, destination pixel (i, j) samples source position
    (2i + 0.5, 2j + 0.5): the average of the 2x2 block, rounded to nearest
    like OpenCV's fixed-point path.
    """
    x = img.to(torch.int32)
    h, w = x.shape[-2], x.shape[-1]
    x = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
    s = x.sum(dim=(-3, -1))
    return ((s + 2) >> 2).to(torch.uint8)


def _cv2_linear_taps(src: int, dst: int):
    """cv2 INTER_LINEAR tap indices + fixed-point coefficients for one axis.

    Half-pixel centres ``f = (d+0.5)*src/dst-0.5``, floor split, boundary
    clamp, coefficients rounded to the ``INTER_RESIZE_COEF_SCALE`` (2048)
    fixed-point grid.
    """
    d = np.arange(dst, dtype=np.float64)
    f = (d + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    s0 = np.clip(s, 0, max(src - 2, 0))
    frac = np.clip(f - s0, 0.0, 1.0)  # boundary: duplicate edge pixel
    a1 = np.rint(frac * 2048.0).astype(np.int32)
    a0 = np.rint((1.0 - frac) * 2048.0).astype(np.int32)
    return s0.astype(np.int32), a0, a1


@functools.lru_cache(maxsize=None)
def _device_taps(src: int, dst: int, device: torch.device):
    """:func:`_cv2_linear_taps` on ``device``, made once per size: a fresh
    host -> device copy on every call would wait for the card."""
    s0, a0, a1 = (torch.from_numpy(a).to(device) for a in _cv2_linear_taps(src, dst))
    return s0.long(), a0, a1


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """General bilinear resize (half-pixel centres) of (..., H, W).

    uint8 inputs go through the cv2 fixed-point scheme: 2048-scale separable
    coefficients and the SIMD vertical cast
    ``(((b0*(t0>>4))>>16) + ((b1*(t1>>4))>>16) + 2) >> 2``.  Float inputs use
    antialiased bilinear interpolation in float32, the same geometry as
    ``jax.image.resize(..., method="linear")``.
    """
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_hw
    if img.dtype.is_floating_point:
        lead = img.shape[:-2]
        x = img.to(torch.float32).reshape(-1, 1, h, w)
        y = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False,
                          antialias=True)
        return y.reshape(*lead, oh, ow)

    sx, ax0, ax1 = _device_taps(w, ow, img.device)
    sy, ay0, ay1 = _device_taps(h, oh, img.device)
    x = img.to(torch.int32)
    # horizontal pass: int32 rows at coefficient scale 2048
    t = (x.index_select(-1, sx) * ax0
         + x.index_select(-1, torch.clamp(sx + 1, max=w - 1)) * ax1)
    # vertical pass + cv2's SIMD fixed-point cast (VResizeLinearVec_32s8u)
    t0 = t.index_select(-2, sy)
    t1 = t.index_select(-2, torch.clamp(sy + 1, max=h - 1))
    b0 = ay0[:, None]
    b1 = ay1[:, None]
    out = (((b0 * (t0 >> 4)) >> 16) + ((b1 * (t1 >> 4)) >> 16) + 2) >> 2
    return torch.clamp(out, 0, 255).to(img.dtype)


def normalize(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (..., H, W[, C]) -> normalised float ``(x - 128) / 255``."""
    return (img.to(dtype) - 128.0) / 255.0


def preprocess_device(bgr_batch: torch.Tensor, input_hw: Tuple[int, int],
                      dtype=torch.float32) -> torch.Tensor:
    """Full preprocess on the batch's device: (B, H0, W0, 3) uint8 BGR ->
    (B, H, W, 1).  The exact 2x kernel when the ratio is exactly 2, the
    general cv2 bilinear otherwise."""
    gray = bgr_to_gray(bgr_batch)  # (B, H0, W0)
    h0, w0 = gray.shape[-2], gray.shape[-1]
    h, w = input_hw
    if (h0, w0) == (h, w):
        pass
    elif h0 == 2 * h and w0 == 2 * w:
        gray = downsample2x(gray)
    else:
        gray = resize_bilinear(gray, (h, w))
    return normalize(gray, dtype)[..., None]
