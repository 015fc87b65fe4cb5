"""Result drawing (equivalent of ``utils/general.py:56-67`` plot_one_box)."""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence

CLASS_COLORS = [[106, 90, 205], [199, 97, 20], [112, 128, 105]]  # detect.py:105


def _px(v: float, limit: int) -> int:
    # Untrained/heavily-quantised models can decode exp() overflows into box
    # coords; cv2 rejects non-finite or out-of-int32 points, so clamp to a
    # margin around the image instead of crashing the drawing pass.
    if math.isnan(v):
        return 0
    return int(min(max(v, -limit), 2 * limit))


def plot_one_box(xyxy: Sequence[float], img, color=None, label: Optional[str] = None,
                 line_thickness: Optional[int] = None):
    import cv2  # host-side tooling only

    tl = line_thickness or round(0.002 * (img.shape[0] + img.shape[1]) / 2) + 1
    color = color or [random.randint(0, 255) for _ in range(3)]
    c1 = (_px(xyxy[0], img.shape[1]), _px(xyxy[1], img.shape[0]))
    c2 = (_px(xyxy[2], img.shape[1]), _px(xyxy[3], img.shape[0]))
    cv2.rectangle(img, c1, c2, color, thickness=tl, lineType=cv2.LINE_AA)
    if label:
        tf = min(tl - 1, 2)
        t_size = cv2.getTextSize(label, fontFace=0, fontScale=tl / 5, thickness=tf)[0]
        c2 = c1[0] + t_size[0], c1[1] - t_size[1] - 3
        cv2.rectangle(img, c1, c2, color, thickness=-1, lineType=cv2.LINE_AA)
        cv2.putText(img, label, (c1[0], c1[1] - 2), 0, tl / 5, [225, 255, 255],
                    thickness=tf, lineType=cv2.LINE_AA)
    return img
