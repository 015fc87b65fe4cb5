"""`detect` command: batch image detection through the port's Detector.

Flags are those of ``python -m yolofastest_tpu detect`` plus ``--device``
and ``--calib-data``.  As there, the trainable graph runs unless
``--fold-bn`` asks for the BN-folded deployment graph, whose res chains are
the chain kernel; ``--backend jax`` is the JAX package's alias for ``fp``;
``--backend int8|int8-fused`` runs the int8 graph (``--int8-zoo`` for the
shipped artifact, else scales from the cache or calibrated on the first 8
images of ``--calib-data``, by default ``--data``; ``--keep-fp``); the
native backends exit 2.  Writes ``result_<image>`` files and
``detect_info.log`` (reference log format) into ``--out``; ``--sliced RxC``
detects each ``.jpg`` over an RxC grid of overlapping tiles.
"""

from __future__ import annotations

import os

from yolofastest_torch.cli._common import add_model_args, build_detector


def add_detect_parser(sub) -> None:
    d = sub.add_parser("detect", help="batch-detect a directory of images")
    add_model_args(d)
    d.add_argument("--fold-bn", action="store_true",
                   help="run the BN-folded deployment graph (the chain kernel on the card) "
                        "instead of the trainable graph")
    d.add_argument("--data", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--batch", type=int, default=1,
                   help="device batch size (>1 = throughput mode, amortised "
                        "per-image timing)")
    d.add_argument("--sliced", default=None, metavar="RxC",
                   help="tiled detection for large frames: split each image "
                        "into an RxC grid of overlapping crops, run all tiles "
                        "as one batch, merge in one global NMS")
    d.add_argument("--slice-overlap", type=float, default=0.2,
                   help="fraction of tile extent shared by neighbouring "
                        "tiles (default 0.2)")
    d.set_defaults(fn=cmd_detect)


def cmd_detect(args) -> int:
    from yolofastest_torch.utils.logging import config_logger

    grid = None
    if args.sliced:
        try:
            grid = tuple(int(v) for v in args.sliced.lower().split("x"))
        except ValueError:
            grid = ()
        if len(grid) != 2:
            print(f"--sliced expects RxC (e.g. 2x3), got {args.sliced!r}")
            return 2
    logger = config_logger(args.out, "detect_info.log")
    os.makedirs(args.out, exist_ok=True)
    built = build_detector(args, logger, fold_bn=args.fold_bn,
                           calib_data=args.calib_data or args.data)
    if built is None:
        return 2
    cfg, detector = built
    if grid:
        return _sliced_detect_dir(args, cfg, detector, grid, logger)
    detector.batch_detect(args.data, args.out, batch_size=args.batch)
    return 0


def _sliced_detect_dir(args, cfg, detector, grid, logger) -> int:
    """detect --sliced RxC: tiled detection over every .jpg in --data; the
    R*C tiles of an image run as ONE batch, and its boxes come out in origin
    pixels after the global NMS."""
    import time

    import cv2

    from yolofastest_torch.inference.sliced import sliced_detect
    from yolofastest_torch.utils.visualize import CLASS_COLORS, plot_one_box

    rows, cols = grid
    io = cfg.io
    names = sorted(f for f in os.listdir(args.data) if f.lower().endswith(".jpg"))
    avg = 0.0
    for fn in names:
        ori = cv2.imread(os.path.join(args.data, fn))
        t0 = time.time()
        det = sliced_detect(detector, ori, grid, args.slice_overlap)
        total = (time.time() - t0) * 1e3
        avg += total
        for b, conf, cs, cls in zip(det["boxes"], det["conf"],
                                    det["cls_score"], det["cls_idx"]):
            plot_one_box(list(b), ori, color=CLASS_COLORS[int(cls) % len(CLASS_COLORS)],
                         label="%s %.2f" % (io.class_names[int(cls)], conf * cs),
                         line_thickness=3)
        cv2.imwrite(os.path.join(args.out, "result_" + fn), ori)
        logger.info("image_name:%s -> total time:%.2fms (%d dets, %dx%d tiles)"
                    % (fn, total, det["count"], rows, cols))
    logger.info("detect avg_time: %.2fms" % (avg / max(len(names), 1)))
    return 0
