"""COCO-JSON detection dataset index.

The port's own copy of ``yolofastest_tpu/data/coco.py`` (numpy only).

The reference trains exclusively on its VOC-XML layout (plus a one-shot
``txt2xml.py`` converter); COCO's single-JSON annotation format is the other
lingua franca of detection datasets, so the framework accepts it natively.
Layout convention mirrors our VOC one (``<root>/img/*.jpg``):

    <root>/annotations.json   # COCO instances: images/annotations/categories
    <root>/img/<file_name>    # file_name entries resolve under img/

The index presents the exact :class:`~yolofastest_torch.data.voc.VOCIndex`
contract — ``items`` of ``(img_path, (N, 5) float32 labels)`` rows
``(cls_idx, x1, y1, x2, y2)`` — so :class:`DetectionLoader`, the trainer and
the evaluator work unchanged.

Category mapping is BY NAME against the config's ``class_names`` (COCO ids
are arbitrary and dataset-specific); categories absent from ``class_names``
raise, exactly like VOC parsing does for an unknown ``<name>``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def parse_coco_json(
    path: str, class_names: Sequence[str]
) -> List[Tuple[str, np.ndarray]]:
    """COCO instances JSON -> ``[(file_name, (N, 5) labels), ...]`` in the
    JSON's image order.  ``bbox`` is COCO ``[x, y, w, h]``; rows come out as
    ``(cls_idx, x1, y1, x2, y2)`` to match :func:`parse_voc_xml`.  Images
    with no annotations yield ``(0, 5)`` label arrays (negatives are part of
    the dataset, same as an empty VOC file)."""
    with open(path) as f:
        doc = json.load(f)
    for key in ("images", "annotations", "categories"):
        if key not in doc:
            raise ValueError(f"{path}: not a COCO instances file "
                             f"(missing {key!r})")
    cat_to_cls: Dict[int, float] = {}
    for cat in doc["categories"]:
        name = cat["name"]
        if name not in class_names:
            raise ValueError(
                f"{path}: category {name!r} not in class_names "
                f"{tuple(class_names)}")
        cat_to_cls[cat["id"]] = float(class_names.index(name))

    per_image: Dict[int, List[List[float]]] = {
        img["id"]: [] for img in doc["images"]}
    for ann in doc["annotations"]:
        img_id = ann["image_id"]
        if img_id not in per_image:
            raise ValueError(
                f"{path}: annotation {ann.get('id')} references unknown "
                f"image_id {img_id}")
        x, y, w, h = ann["bbox"]
        per_image[img_id].append(
            [cat_to_cls[ann["category_id"]], x, y, x + w, y + h])

    out: List[Tuple[str, np.ndarray]] = []
    for img in doc["images"]:
        labels = np.asarray(per_image[img["id"]], np.float32).reshape(-1, 5)
        out.append((img["file_name"], labels))
    return out


def write_coco_json(
    path: str,
    entries: Sequence[Tuple[str, Tuple[int, int],
                            Sequence[Tuple[str, float, float, float, float]]]],
    class_names: Sequence[str],
) -> None:
    """Write a minimal COCO instances file.  ``entries`` rows are
    ``(file_name, (height, width), [(cls_name, x1, y1, x2, y2), ...])`` —
    the :func:`~yolofastest_torch.data.voc.write_voc_xml` counterpart for
    fixtures and VOC→COCO conversion."""
    images, annotations = [], []
    for img_id, (file_name, (h, w), boxes) in enumerate(entries, start=1):
        images.append({"id": img_id, "file_name": file_name,
                       "height": int(h), "width": int(w)})
        for name, x1, y1, x2, y2 in boxes:
            annotations.append({
                "id": len(annotations) + 1,
                "image_id": img_id,
                "category_id": class_names.index(name) + 1,
                "bbox": [float(x1), float(y1),
                         float(x2) - float(x1), float(y2) - float(y1)],
                "area": (float(x2) - float(x1)) * (float(y2) - float(y1)),
                "iscrowd": 0,
            })
    doc = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(class_names)],
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def voc_to_coco(voc_root: str, coco_root: str,
                class_names: Sequence[str]) -> int:
    """Convert a VOC-layout dataset (``<root>/img`` + ``<root>/xml``) to the
    COCO layout (``<root>/img`` + ``<root>/annotations.json``).  The txt2xml
    sibling for the other direction of the format matrix; returns the number
    of images converted.  Images are copied, not moved."""
    import shutil
    import xml.etree.ElementTree as ET

    os.makedirs(coco_root, exist_ok=True)
    dst_img = os.path.join(coco_root, "img")
    if not os.path.exists(dst_img):
        shutil.copytree(os.path.join(voc_root, "img"), dst_img)
    entries = []
    for fn in sorted(os.listdir(os.path.join(voc_root, "xml"))):
        tree = ET.parse(os.path.join(voc_root, "xml", fn))
        size = tree.find("size")
        hw = (int(size.find("height").text), int(size.find("width").text))
        boxes = []
        for obj in tree.findall("object"):
            bb = obj.find("bndbox")
            boxes.append((obj.find("name").text,
                          float(bb.find("xmin").text),
                          float(bb.find("ymin").text),
                          float(bb.find("xmax").text),
                          float(bb.find("ymax").text)))
        entries.append((os.path.splitext(fn)[0] + ".jpg", hw, boxes))
    write_coco_json(os.path.join(coco_root, "annotations.json"),
                    entries, class_names)
    return len(entries)


class COCOIndex:
    """``<root>/annotations.json`` + ``<root>/img/<file_name>``; presents
    the :class:`VOCIndex` contract so every consumer works unchanged."""

    def __init__(self, root: str, class_names: Sequence[str], logger=None,
                 ann_file: Optional[str] = None):
        self.root = root
        self.class_names = tuple(class_names)
        ann = ann_file or os.path.join(root, "annotations.json")
        img_dir = os.path.join(root, "img")
        parsed = parse_coco_json(ann, self.class_names)
        self.items: List[Tuple[str, np.ndarray]] = [
            (os.path.join(img_dir, fn), labels) for fn, labels in parsed]
        if logger:
            logger.info("Loading finish! dataset contains %d items"
                        % len(self.items))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Tuple[str, np.ndarray]:
        return self.items[i]
