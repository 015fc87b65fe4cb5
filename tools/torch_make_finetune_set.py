"""Build the pseudo-GT fine-tune set from the repository's own frames.

The port of ``tools/make_finetune_set.py``: the 20 golden frames, each with
the reference detector's golden detections as its VOC labels (a standard
self-training set), replicated ``--copies`` times for ``<out>/train`` and
once for ``<out>/val``, in JAX's layout: ``<split>/img/<stem>_cNN.jpg`` and
``<split>/xml/<stem>_cNN.xml``.  A frame with no golden row is left out
(19 frames at 512x640), and the box coordinates are ``row * 512 / net_h``
in the 512x640 originals, as JAX's tool writes them.

The images are not the reference's JPEG bytes, which are not in the
repository.  Each frame is ``tests/fixtures/golden_512x640.npz``
``pre_imgs[i]``, the original's gray at its own 512x640 size, encoded
losslessly as PNG under the ``.jpg`` name (cv2 reads a file by its
content).  The port's loader turns an image gray and then resizes it, so
it sees the same net inputs at either size as it would from the
originals.  Each frame is one file on disk: every copy, and the val entry,
is a hard link to it (a copy where the file system refuses a link), so
``--copies 400`` holds 20 images, not 8,000.

Usage: python tools/torch_make_finetune_set.py --out DIR [--copies 16]
       [--res 256x320|512x640]
"""

import argparse
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXTURES = os.path.join(REPO, "tests", "fixtures")
CLASS_NAMES = ("carrier", "defender", "destroyer")


def _place(src, dst):
    """``dst`` as a hard link to ``src``, or a copy where linking fails."""
    if os.path.lexists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def write_set(out, copies=16, res="256x320", log=print):
    """Write the set under ``out``; returns ``{split: entries}``."""
    import cv2

    from yolofastest_torch.data import write_voc_xml

    fx = np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
    names = [str(n) for n in fx["image_names"]]
    boxes = fx["boxes"]  # [img_idx, x1, y1, x2, y2, conf, cls_score, cls] @net-input
    frames = np.load(os.path.join(FIXTURES, "golden_512x640.npz"))
    pre = dict(zip((str(n) for n in frames["image_names"]), frames["pre_imgs"]))

    # golden boxes are in net-input coords; originals are 512x640
    net_h = int(res.split("x")[0])
    sh = sw = 512 / net_h
    written = {}  # frame name -> its one file on disk
    counts = {}
    for split, n_copies in (("train", copies), ("val", 1)):
        img_dir = os.path.join(out, split, "img")
        xml_dir = os.path.join(out, split, "xml")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(xml_dir, exist_ok=True)
        n = 0
        for idx, name in enumerate(names):
            rows = boxes[boxes[:, 0] == idx]
            objs = [
                (CLASS_NAMES[int(r[7])],
                 r[1] * sw, r[2] * sh, r[3] * sw, r[4] * sh)
                for r in rows
            ]
            if not objs:
                continue
            for c in range(n_copies):
                stem = f"{os.path.splitext(name)[0]}_c{c:02d}"
                dst = os.path.join(img_dir, stem + ".jpg")
                if name in written:
                    _place(written[name], dst)
                else:
                    if os.path.lexists(dst):  # never write through an old link
                        os.remove(dst)
                    ok, png = cv2.imencode(".png", pre[name])
                    if not ok:
                        raise RuntimeError(f"cv2 could not encode {name}")
                    with open(dst, "wb") as f:
                        f.write(png.tobytes())
                    written[name] = dst
                write_voc_xml(os.path.join(xml_dir, stem + ".xml"),
                              stem + ".jpg", (512, 640), objs)
                n += 1
        counts[split] = n
        log(f"{split}: {n} entries")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--copies", type=int, default=16)
    ap.add_argument("--res", default="256x320", choices=["256x320", "512x640"])
    args = ap.parse_args(argv)
    write_set(args.out, args.copies, args.res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
