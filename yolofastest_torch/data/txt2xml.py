"""txt -> VOC-XML label conversion (dataset prep tool).

The port's copy of ``yolofastest_tpu/data/txt2xml.py`` over the port's
:func:`~yolofastest_torch.data.voc.write_voc_xml`.

Capability-equivalent of the reference's one-shot ``utils/txt2xml.py:8-120``.
Two input dialects (auto-detected, or forced via ``dialect=``):

* ``"yolo"`` — standard YOLO txt: one object per line,
  ``cls_id xc yc w h`` normalised to [0, 1].
* ``"ref-dump"`` — the reference's bespoke punctuated annotation dump
  (``utils/txt2xml.py:53-60``): the first 3 lines are headers; each object
  line is tokenised by mapping ``:`` ``{`` ``,`` to spaces and deleting
  ``}``, then indexed positionally — token 1 is the class NAME, tokens
  2..5 are ``ymin xmin ymax xmax`` in ABSOLUTE pixels (the reference's
  comment notes label coords are [row, col] = [y, x]).  This module
  replicates that exact tokenisation, so any file the reference script
  accepted converts identically (e.g. ``0 carrier{12,34,56,78}``).

Both emit the ``img/`` + ``xml/`` VOC layout
:class:`yolofastest_torch.data.VOCIndex` reads.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Sequence, Tuple

from yolofastest_torch.data.voc import write_voc_xml

DEFAULT_CLASSES = ("carrier", "defender", "destroyer")

REF_DUMP_HEADER_LINES = 3  # reference skips txtList[:3] (txt2xml.py:53)


def detect_dialect(path: str) -> str:
    """``"ref-dump"`` when any line carries the reference dump's
    punctuation (``{``/``:``/``,``), else ``"yolo"`` (whose rows are pure
    space-separated numbers)."""
    with open(path) as f:
        for line in f:
            if any(c in line for c in "{:,"):
                return "ref-dump"
    return "yolo"


def parse_ref_dump(path: str) -> List[Tuple[str, float, float, float, float]]:
    """Parse one reference-dialect annotation dump into
    ``[(class_name, x1, y1, x2, y2), ...]`` in absolute pixels.

    Faithful to the reference's parsing (``utils/txt2xml.py:53-60``,
    including its exact punctuation-to-space tokenisation and positional
    indexing); malformed rows raise ``ValueError`` naming the file (the
    reference would IndexError opaquely).
    """
    with open(path) as f:
        lines = f.readlines()
    out = []
    for ln, raw in enumerate(lines[REF_DUMP_HEADER_LINES:],
                             REF_DUMP_HEADER_LINES + 1):
        if not raw.strip():
            continue
        toks = (raw.strip().replace(":", " ").replace("{", " ")
                .replace(",", " ").replace("}", "").split(" "))
        try:
            name = toks[1]
            ymin, xmin, ymax, xmax = (float(toks[k]) for k in (2, 3, 4, 5))
        except (IndexError, ValueError) as e:
            raise ValueError(
                f"{path}:{ln}: malformed reference-dump row {raw!r} ({e})"
            ) from None
        out.append((name, xmin, ymin, xmax, ymax))
    return out


def convert_txt_dataset(
    src: str,
    dst: str,
    class_names: Sequence[str] = DEFAULT_CLASSES,
    class_id_base: int = 0,
    dialect: str = "auto",
) -> int:
    """``src`` holds paired ``<stem>.jpg`` + ``<stem>.txt``; writes
    ``dst/img/*.jpg`` and ``dst/xml/*.xml``.  Returns files converted.

    ``dialect``: ``"yolo"`` (normalised ``cls xc yc w h`` rows),
    ``"ref-dump"`` (the reference's punctuated pixel dump), or ``"auto"``
    (per-file detection — mixed directories convert correctly).
    """
    import cv2

    if dialect not in ("auto", "yolo", "ref-dump"):
        raise ValueError(f"unknown txt dialect {dialect!r}")
    os.makedirs(os.path.join(dst, "img"), exist_ok=True)
    os.makedirs(os.path.join(dst, "xml"), exist_ok=True)
    count = 0
    for fn in sorted(os.listdir(src)):
        if not fn.endswith(".txt"):
            continue
        stem = fn[:-4]
        img_path = os.path.join(src, stem + ".jpg")
        if not os.path.exists(img_path):
            continue
        img = cv2.imread(img_path)
        if img is None:  # corrupt/unreadable image: fail with a clear message
            raise FileNotFoundError(
                f"cannot decode image {img_path!r} (cv2.imread returned None)"
            )
        h, w = img.shape[:2]
        txt_path = os.path.join(src, fn)
        d = detect_dialect(txt_path) if dialect == "auto" else dialect
        boxes = []
        if d == "ref-dump":
            boxes = list(parse_ref_dump(txt_path))
        else:
            with open(txt_path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 5:
                        continue
                    cls = int(float(parts[0])) - class_id_base
                    xc, yc, bw, bh = (float(v) for v in parts[1:])
                    boxes.append(
                        (
                            class_names[cls],
                            (xc - bw / 2) * w,
                            (yc - bh / 2) * h,
                            (xc + bw / 2) * w,
                            (yc + bh / 2) * h,
                        )
                    )
        shutil.copy(img_path, os.path.join(dst, "img", stem + ".jpg"))
        write_voc_xml(os.path.join(dst, "xml", stem + ".xml"), stem + ".jpg", (h, w), boxes)
        count += 1
    return count
