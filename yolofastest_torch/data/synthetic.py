"""A synthetic detection set and an in-memory loader, for smoke runs and
tests where no real dataset is at hand.

:func:`write_synthetic_voc` writes a VOC directory (``<root>/img/*.jpg`` and
``<root>/xml/*.xml``) of bright rectangles, one shade per class, on dark
noise, from a seed.  :class:`ListLoader` is a list of ``(images, targets)``
batches that carries the batch size :class:`~yolofastest_torch.eval.
MAPEvaluator` pads a short last batch to.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from yolofastest_torch.data.voc import write_voc_xml


def write_synthetic_voc(root: str, n_images: int, origin_hw: Tuple[int, int],
                        class_names: Sequence[str], seed: int = 0) -> None:
    """``n_images`` images of ``origin_hw`` under ``root``, each with 1-3
    boxes whose sides are a tenth to a third of the image's."""
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    os.makedirs(os.path.join(root, "xml"), exist_ok=True)
    h0, w0 = origin_hw
    for i in range(n_images):
        img = rng.integers(0, 40, (h0, w0, 3), np.uint8)
        boxes = []
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(0, len(class_names)))
            bw, bh = int(rng.integers(w0 // 10, w0 // 3)), int(rng.integers(h0 // 10, h0 // 3))
            x1, y1 = int(rng.integers(0, w0 - bw)), int(rng.integers(0, h0 - bh))
            img[y1:y1 + bh, x1:x1 + bw] = 120 + 60 * cls
            boxes.append((class_names[cls], x1, y1, x1 + bw, y1 + bh))
        stem = f"im_{i:04d}"
        cv2.imwrite(os.path.join(root, "img", stem + ".jpg"), img)
        write_voc_xml(os.path.join(root, "xml", stem + ".xml"), stem + ".jpg", (h0, w0), boxes)


class ListLoader(list):
    """A list of ``(images, targets)`` batches with the loader's batch size."""

    def __init__(self, batches, batch_size: int):
        super().__init__(batches)
        self.batch_size = batch_size
