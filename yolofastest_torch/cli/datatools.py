"""`voc2coco`, `txt2xml` and `anchors` commands: the JAX package's data
tools (``yolofastest_tpu/cli/datatools.py``) with its flags and printed
lines.  All three run on the host (numpy and cv2)."""

from __future__ import annotations

from yolofastest_torch.cli._common import CONFIGS, get_config, make_index


def add_datatools_parsers(sub) -> None:
    vc = sub.add_parser("voc2coco", help="VOC-layout dataset -> COCO layout "
                                         "(img/ + annotations.json)")
    vc.add_argument("--config", default="256x320", choices=CONFIGS,
                    help="supplies the class-name list for category ids")
    vc.add_argument("--src", required=True, help="VOC root (img/ + xml/)")
    vc.add_argument("--dst", required=True, help="output COCO root")
    vc.set_defaults(fn=cmd_voc2coco)

    tx = sub.add_parser("txt2xml", help="custom txt labels -> VOC XML dataset")
    tx.add_argument("--src", required=True)
    tx.add_argument("--dst", required=True)
    tx.add_argument("--class-id-base", type=int, default=0)
    tx.add_argument("--dialect", default="auto", choices=["auto", "yolo", "ref-dump"],
                    help="input txt flavor: standard YOLO rows or the reference's "
                         "punctuated pixel dump (utils/txt2xml.py:53-60); auto detects "
                         "per file")
    tx.set_defaults(fn=cmd_txt2xml)

    an = sub.add_parser("anchors", help="k-means auto-anchors from a dataset's GT boxes")
    an.add_argument("--config", default="256x320", choices=CONFIGS,
                    help="supplies net-input size, strides and the preset anchors to "
                         "compare against")
    an.add_argument("--data", required=True, help="VOC or COCO dataset root")
    an.add_argument("--format", default="auto", choices=["auto", "voc", "coco"])
    an.add_argument("--num", type=int, default=None,
                    help="total anchor count (default: scales * anchors-per-scale from "
                         "the config)")
    an.add_argument("--seed", type=int, default=0)
    an.add_argument("--out", default=None,
                    help="write a full config JSON carrying the new anchors (consumable "
                         "via train/eval --config-json)")
    an.set_defaults(fn=cmd_anchors)


def cmd_voc2coco(args) -> int:
    from yolofastest_torch.data import voc_to_coco

    n = voc_to_coco(args.src, args.dst, get_config(args).io.class_names)
    print(f"converted {n} images -> {args.dst} (COCO layout)")
    return 0


def cmd_txt2xml(args) -> int:
    from yolofastest_torch.data.txt2xml import convert_txt_dataset

    n = convert_txt_dataset(args.src, args.dst, class_id_base=args.class_id_base,
                            dialect=args.dialect)
    print(f"converted {n} label files -> {args.dst}")
    return 0


def cmd_anchors(args) -> int:
    """K-means auto-anchors from a dataset (the reference hand-picks its
    anchor groups, ``_config.py:5-9``; this derives them for any dataset)."""
    import dataclasses

    import numpy as np

    from yolofastest_torch.data import anchor_groups, collect_wh, kmeans_anchors, mean_best_iou

    cfg = get_config(args)
    idx = make_index(args.data, cfg.io.class_names, fmt=args.format)
    wh = collect_wh(idx, cfg)
    num_scales = len(cfg.io.strides)
    k = args.num or num_scales * cfg.io.num_anchors
    anchors = kmeans_anchors(wh, k, seed=args.seed)
    groups = anchor_groups(anchors, num_scales)

    old_fit = mean_best_iou(wh, np.array(cfg.io.anchors).reshape(-1, 2))
    new_fit = mean_best_iou(wh, anchors)
    print(f"{len(wh)} GT boxes from {len(idx)} images "
          f"({args.data}, net input {cfg.io.input_hw})")
    for s, (g, stride) in enumerate(zip(groups, cfg.io.strides)):
        print(f"scale {s} (stride {stride}): " + ", ".join(f"({w:g}, {h:g})" for w, h in g))
    print(f"mean best-IoU: {new_fit:.4f} (preset anchors: {old_fit:.4f})")

    if args.out:
        new_cfg = dataclasses.replace(cfg, io=dataclasses.replace(cfg.io, anchors=groups))
        with open(args.out, "w") as f:
            f.write(new_cfg.to_json())
        print(f"wrote config with the new anchors -> {args.out}")
    return 0
