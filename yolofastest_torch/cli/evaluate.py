"""`eval` command: mAP on a VOC-XML or COCO val set.

The flags of ``python -m yolofastest_tpu eval`` that the port supports, plus
``--device``.  ``--backend train`` (the default) scores the trainable model
through the training-loop evaluator (float boxes, the reference's
``validate.py`` conventions); ``--backend fp`` scores the deployed pipeline,
the port's :class:`~yolofastest_torch.inference.Detector` (BN-folded graph,
detect-path rounding and NMS).  The int8 and native backends answer with
exit code 2 (ROADMAP: 'Quantisation', 'Native engine').
"""

from __future__ import annotations

import json
import sys

from yolofastest_torch.cli._common import (UnportedWeights, add_config_args, check_arch_config,
                                           get_config, load_weights, make_index)

_UNPORTED_BACKENDS = {"int8": "Quantisation", "int8-fused": "Quantisation",
                      "native": "Native engine", "native-int8": "Native engine"}


def add_eval_parser(sub) -> None:
    e = sub.add_parser("eval", help="mAP on a VOC-XML or COCO val set")
    e.add_argument("--format", default="auto", choices=["auto", "voc", "coco"],
                   help="dataset layout (see train --format)")
    add_config_args(e)
    e.add_argument("--weights", required=True,
                   help=".npz zoo-layout weights or a port checkpoint directory")
    e.add_argument("--val-dir", required=True)
    e.add_argument("--arch", default="fastest", choices=["fastest", "lite"])
    e.add_argument("--backend", default="train",
                   choices=["train", "fp", "jax", *_UNPORTED_BACKENDS],
                   help="train (default) = the training-loop evaluator; fp (or its alias "
                        "jax) scores the deployed pipeline (BN-folded, detect-path NMS)")
    e.add_argument("--max-det", type=int, default=None,
                   help="override the per-image detection budget (config default 64); the "
                        "decode pool grows to at least 2x this")
    e.add_argument("--coco-map", action="store_true",
                   help="also report COCO-style mAP@[.50:.95] (headline mAP stays @0.5)")
    e.add_argument("--coco-strict", action="store_true",
                   help="with --coco-map: pycocotools' exact conventions (standard IOU, "
                        "101-point AP)")
    e.add_argument("--tta", action="store_true",
                   help="horizontal-flip test-time augmentation (deployed fp backend)")
    e.add_argument("--json-out", default=None,
                   help="also write the full metrics dict as JSON to this path")
    e.add_argument("--log-dir", default="logs")
    e.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    e.set_defaults(fn=cmd_eval)


def cmd_eval(args) -> int:
    import dataclasses

    from yolofastest_torch.data import DetectionLoader
    from yolofastest_torch.eval import COCO_IOU_GRID, MAPEvaluator, make_backend_eval_fn
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.utils.logging import config_logger

    backend = "fp" if args.backend == "jax" else args.backend
    if backend in _UNPORTED_BACKENDS:
        print(f"--backend {backend} is not ported yet (ROADMAP: "
              f"'{_UNPORTED_BACKENDS[backend]}'); use train or fp", file=sys.stderr)
        return 2
    if backend == "train" and args.tta:
        print("--tta scores the DEPLOYED pipeline; pick --backend fp", file=sys.stderr)
        return 2
    strict_kw = {}
    if args.coco_strict:
        if not args.coco_map:
            print("--coco-strict needs --coco-map", file=sys.stderr)
            return 2
        strict_kw = dict(iou_convention="coco", ap_interpolation="coco101")
    cfg = get_config(args)
    check_arch_config(cfg, args.arch)
    if args.max_det is not None:
        if args.max_det < 1:
            raise SystemExit(f"--max-det must be >= 1, got {args.max_det}")
        cfg = dataclasses.replace(cfg, io=dataclasses.replace(
            cfg.io, max_det=args.max_det, max_decode=max(cfg.io.max_decode, 2 * args.max_det)))
    try:
        variables = load_weights(args.weights, args.arch)
    except UnportedWeights as e:
        print(e, file=sys.stderr)
        return 2
    logger = config_logger(args.log_dir, "eval_info.log")
    idx = make_index(args.val_dir, cfg.io.class_names, logger, fmt=args.format)
    loader = DetectionLoader(idx, cfg, augment=False, shuffle=False, drop_last=False)
    iou_thresholds = COCO_IOU_GRID if args.coco_map else None
    if backend == "train":
        evaluator = MAPEvaluator(cfg, loader, logger=logger, arch=args.arch,
                                 iou_thresholds=iou_thresholds, device=args.device, **strict_kw)
    else:
        engine = Detector(cfg, variables=variables, fold_bn=True, arch=args.arch, tta=args.tta,
                          device=args.device)
        evaluator = MAPEvaluator(cfg, loader, logger=logger, arch=args.arch,
                                 eval_fn=make_backend_eval_fn(engine, max_det=cfg.io.max_det),
                                 iou_thresholds=iou_thresholds, **strict_kw)
        variables = None
    mAP = evaluator(variables, epoch=0)
    print(f"mAP: {mAP:.4f}")
    if "mAP_grid" in evaluator.last_metrics:
        print(f"mAP@[.50:.95]: {evaluator.last_metrics['mAP_grid']:.4f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"config": args.config, "arch": args.arch, "backend": backend,
                       "weights": args.weights, **evaluator.last_metrics}, f, indent=1)
        print("wrote", args.json_out)
    return 0
