"""VOC-XML detection dataset index.

The port's own copy of ``yolofastest_tpu/data/voc.py`` (numpy only).

Replaces the reference's in-constructor XML sweep
(``src/model_training/dataloader/detect_dataset.py:63-84``): parse every
label file under ``<root>/xml`` once into an in-memory index mapping image
paths to ``(cls, x1, y1, x2, y2)`` rows.  Also provides an XML *writer* so
tests can fabricate datasets (the reference ships no labels), covering the
capability of the one-shot ``txt2xml`` tool (``utils/txt2xml.py:8-120``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np


def parse_voc_xml(path: str, class_names: Sequence[str]) -> np.ndarray:
    """One label file -> (N, 5) float32 rows ``(cls_idx, x1, y1, x2, y2)``
    (reference parse, ``detect_dataset.py:68-80``)."""
    tree = ET.parse(path)
    rows: List[List[float]] = []
    for obj in tree.findall("object"):
        bb = obj.find("bndbox")
        name = obj.find("name").text
        rows.append(
            [
                float(class_names.index(name)),
                float(bb.find("xmin").text),
                float(bb.find("ymin").text),
                float(bb.find("xmax").text),
                float(bb.find("ymax").text),
            ]
        )
    return np.asarray(rows, np.float32).reshape(-1, 5)


def write_voc_xml(
    path: str,
    img_name: str,
    img_hw: Tuple[int, int],
    boxes: Sequence[Tuple[str, float, float, float, float]],
) -> None:
    """Write a minimal VOC label file (``name, x1, y1, x2, y2`` per object) —
    the test-fixture / txt2xml-equivalent direction."""
    root = ET.Element("annotation")
    ET.SubElement(root, "filename").text = img_name
    size = ET.SubElement(root, "size")
    ET.SubElement(size, "height").text = str(img_hw[0])
    ET.SubElement(size, "width").text = str(img_hw[1])
    ET.SubElement(size, "depth").text = "3"
    for name, x1, y1, x2, y2 in boxes:
        obj = ET.SubElement(root, "object")
        ET.SubElement(obj, "name").text = name
        bb = ET.SubElement(obj, "bndbox")
        ET.SubElement(bb, "xmin").text = str(x1)
        ET.SubElement(bb, "ymin").text = str(y1)
        ET.SubElement(bb, "xmax").text = str(x2)
        ET.SubElement(bb, "ymax").text = str(y2)
    ET.ElementTree(root).write(path)


class VOCIndex:
    """Directory layout (reference convention): ``<root>/img/*.jpg`` +
    ``<root>/xml/*.xml`` with matching stems."""

    def __init__(self, root: str, class_names: Sequence[str], logger=None):
        self.root = root
        self.class_names = tuple(class_names)
        xml_dir = os.path.join(root, "xml")
        img_dir = os.path.join(root, "img")
        self.items: List[Tuple[str, np.ndarray]] = []
        names = sorted(os.listdir(xml_dir))
        for i, fn in enumerate(names):
            if logger and i % 1000 == 0:
                logger.info("Loading:%d/%d" % (i, len(names)))
            labels = parse_voc_xml(os.path.join(xml_dir, fn), self.class_names)
            img_path = os.path.join(img_dir, os.path.splitext(fn)[0] + ".jpg")
            self.items.append((img_path, labels))
        if logger:
            logger.info("Loading finish! dataset contains %d items" % len(self.items))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Tuple[str, np.ndarray]:
        return self.items[i]
