"""`detect` command: batch image detection through the port's Detector.

Flags are those of ``python -m yolofastest_tpu detect`` plus ``--device``
and ``--calib-data``.  As there, the trainable graph runs unless
``--fold-bn`` asks for the BN-folded deployment graph, whose res chains are
the chain kernel; ``--backend jax`` is the JAX package's alias for ``fp``;
``--backend int8|int8-fused`` runs the int8 graph (``--int8-zoo`` for the
shipped artifact, else scales from the cache or calibrated on the first 8
images of ``--calib-data``, by default ``--data``; ``--keep-fp``);
``--backend native|native-int8`` writes ``model.yfb`` into ``--out`` and
runs the C++ engine on the host CPU, one ``.jpg`` at a time (the int8 one
with the same scales: ``--int8-zoo``, the cache, or calibration on the
first 8 images).  Writes ``result_<image>`` files and ``detect_info.log``
(reference log format) into ``--out``; ``--sliced RxC`` detects each
``.jpg`` over an RxC grid of overlapping tiles.
"""

from __future__ import annotations

import os

from yolofastest_torch.cli._common import (NATIVE_BACKENDS, NATIVE_TTA, add_model_args,
                                           add_tta_arg,
                                           build_detector, check_arch_config, get_config,
                                           resolve_int8_zoo, write_native_weights)


def add_detect_parser(sub) -> None:
    d = sub.add_parser("detect", help="batch-detect a directory of images")
    add_model_args(d)
    add_tta_arg(d)
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
    if args.backend in NATIVE_BACKENDS:
        return _native_detect_dir(args, logger)
    built = build_detector(args, logger, fold_bn=args.fold_bn,
                           calib_data=args.calib_data or args.data)
    if built is None:
        return 2
    cfg, detector = built
    if grid:
        return _sliced_detect_dir(args, cfg, detector, grid, logger)
    detector.batch_detect(args.data, args.out, batch_size=args.batch)
    return 0


def _native_detect_dir(args, logger) -> int:
    """detect --backend native|native-int8: ``model.yfb`` into --out, then
    each .jpg of --data through the C++ engine, per-image times logged."""
    import time

    import cv2

    from yolofastest_torch.inference.detector import image_to_net_input
    from yolofastest_torch.native import NativeEngine
    from yolofastest_torch.utils.visualize import CLASS_COLORS, plot_one_box

    cfg = get_config(args)
    check_arch_config(cfg, args.arch)
    zoo8 = resolve_int8_zoo(args, args.backend)
    if zoo8 == "error":
        return 2
    if args.tta:
        print(NATIVE_TTA)
        return 2
    if args.sliced:
        print("--sliced batches all tiles through one device program; "
              "it applies to the jax backends, not the C++ engine")
        return 2
    yfb = os.path.join(args.out, "model.yfb")
    if not write_native_weights(args, cfg, args.backend, zoo8, args.calib_data or args.data,
                                yfb):
        return 2
    eng = NativeEngine(yfb, cfg)
    io = cfg.io
    names = sorted(f for f in os.listdir(args.data) if f.lower().endswith(".jpg"))
    avg = 0.0
    for fn in names:
        ori = cv2.imread(os.path.join(args.data, fn))
        img = image_to_net_input(ori, io)[..., 0]
        t0 = time.time()
        rows = eng.detect(img)
        total = (time.time() - t0) * 1e3
        avg += total
        sh = ori.shape[0] / io.input_hw[0]
        sw = ori.shape[1] / io.input_hw[1]
        for x1, y1, x2, y2, conf, cls_score, cls in rows:
            plot_one_box([x1 * sw, y1 * sh, x2 * sw, y2 * sh], ori,
                         color=CLASS_COLORS[int(cls) % len(CLASS_COLORS)],
                         label="%s %.2f" % (io.class_names[int(cls)], conf * cls_score),
                         line_thickness=3)
        cv2.imwrite(os.path.join(args.out, "result_" + fn), ori)
        logger.info("image_name:%s -> total time:%.2fms" % (fn, total))
    logger.info("detect avg_time: %.2fms" % (avg / max(len(names), 1)))
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
