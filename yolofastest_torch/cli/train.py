"""`train` command: the port's Trainer on a VOC-XML or COCO dataset.

The flags of ``python -m yolofastest_tpu train`` plus ``--device`` and
``--float64``.  Writes ``train_info.log`` (the reference's log lines) and
``metrics.jsonl`` into ``--log-dir`` and ``epoch_<n>/`` checkpoints into
``--checkpoint-dir``; ``--resume latest`` picks up at the epoch after the
newest one, with the loader's stream drawn past the epochs before it, so
that a resumed run equals an uninterrupted one bit for bit where the steps
are deterministic.
"""

from __future__ import annotations

import dataclasses
import os
import re

from yolofastest_torch.cli._common import (UnportedWeights, add_config_args, check_arch_config,
                                           get_config, load_weights, make_index)


def add_train_parser(sub) -> None:
    t = sub.add_parser("train", help="train on a VOC-XML or COCO dataset")
    t.add_argument("--format", default="auto", choices=["auto", "voc", "coco"],
                   help="dataset layout: voc = <dir>/img + <dir>/xml, coco = <dir>/img + "
                        "<dir>/annotations.json; auto picks by the annotations.json presence")
    add_config_args(t)
    t.add_argument("--train-dir", required=True)
    t.add_argument("--val-dir", default=None)
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--pretrained", default=None,
                   help=".npz zoo file, reference .pth, .onnx or a port checkpoint directory")
    t.add_argument("--resume", default=None,
                   help="checkpoint directory to resume, or 'latest' for the newest epoch "
                        "in --checkpoint-dir")
    t.add_argument("--checkpoint-dir", default="checkpoints")
    t.add_argument("--arch", default="fastest", choices=["fastest", "lite"])
    t.add_argument("--max-to-keep", type=int, default=None,
                   help="rotate old epoch checkpoints, keeping the newest N (0 keeps all; "
                        "default from config)")
    t.add_argument("--lr", type=float, default=None,
                   help="initial learning rate (default from config)")
    t.add_argument("--cache-images", action="store_true",
                   help="keep decoded net-input images in RAM after first use")
    t.add_argument("--coco-map", action="store_true",
                   help="validation also reports COCO-style mAP@[.50:.95]")
    t.add_argument("--mosaic", type=float, default=None,
                   help="probability of 4-image mosaic augmentation per example")
    t.add_argument("--multiscale", type=int, nargs="?", const=2, default=None,
                   metavar="STEPS",
                   help="multi-scale training: every train.multiscale_every batches draw "
                        "the input (H, W) from input_hw +/- k*32, k <= STEPS")
    t.add_argument("--freeze", default=None, metavar="SPEC",
                   help="pin modules: 'backbone' (all but the heads) or comma-separated "
                        "module-name prefixes; frozen weights and statistics stay bit for "
                        "bit, and checkpoints keep one layout")
    t.add_argument("--ema", type=float, nargs="?", const=0.9995, default=None,
                   metavar="DECAY",
                   help="keep an exponential moving average of the model; validation and "
                        "checkpointed deployment weights use it (bare --ema: 0.9995)")
    t.add_argument("--ema-ramp", type=int, default=None,
                   help="EMA decay ramp-in length in steps (default 2000)")
    t.add_argument("--warmup-min-iters", type=int, default=None,
                   help="linear LR warmup lower bound in iterations")
    precision = t.add_mutually_exclusive_group()
    precision.add_argument("--bf16", action="store_true",
                           help="bfloat16 convolutions in the train step (autocast; weights, "
                                "loss and BatchNorm statistics stay fp32)")
    precision.add_argument("--float64", action="store_true",
                           help="train in float64 (weights, state and step; validation in "
                                "fp32): rounding far below fp32's, the arbiter of an fp32 run")
    t.add_argument("--distill-teacher", default=None,
                   help="weights whose head logits supervise the student beside the labels")
    t.add_argument("--distill-arch", default="fastest", choices=["fastest", "lite"],
                   help="architecture of --distill-teacher")
    t.add_argument("--distill-weight", type=float, default=1.0,
                   help="weight of the teacher-MSE term in the total loss")
    t.add_argument("--log-dir", default="logs")
    t.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    t.set_defaults(fn=cmd_train)


def latest_checkpoint(directory: str):
    """The newest ``epoch_<n>`` directory under ``directory``, or None."""
    cands = sorted((int(m.group(1)), d)
                   for d in (os.listdir(directory) if os.path.isdir(directory) else [])
                   if (m := re.fullmatch(r"epoch_(\d+)", d)))
    return os.path.join(directory, cands[-1][1]) if cands else None


def cmd_train(args) -> int:
    import torch

    from yolofastest_torch.data import DetectionLoader, multiscale_buckets
    from yolofastest_torch.eval import COCO_IOU_GRID, MAPEvaluator
    from yolofastest_torch.train import Trainer, make_teacher_fn
    from yolofastest_torch.utils.logging import config_logger
    from yolofastest_torch.utils.metrics import MetricsWriter

    cfg = get_config(args)
    check_arch_config(cfg, args.arch)
    tr = cfg.train
    tr = dataclasses.replace(
        tr,
        total_epochs=args.epochs or tr.total_epochs,
        batch_size=args.batch_size or tr.batch_size,
        max_to_keep=tr.max_to_keep if args.max_to_keep is None else args.max_to_keep,
        lr0=tr.lr0 if args.lr is None else args.lr,
        warmup_min_iters=(tr.warmup_min_iters if args.warmup_min_iters is None
                          else args.warmup_min_iters),
        ema_decay=tr.ema_decay if args.ema is None else args.ema,
        ema_ramp=tr.ema_ramp if args.ema_ramp is None else args.ema_ramp,
        multiscale_steps=tr.multiscale_steps if args.multiscale is None else args.multiscale)
    cfg = dataclasses.replace(cfg, train=tr)
    if args.mosaic:
        cfg = dataclasses.replace(cfg, augment=dataclasses.replace(cfg.augment,
                                                                  mosaic=args.mosaic))
    try:
        variables = load_weights(args.pretrained, args.arch) if args.pretrained else None
        teacher = (load_weights(args.distill_teacher, args.distill_arch)
                   if args.distill_teacher else None)
    except UnportedWeights as e:
        print(e)
        return 2

    logger = config_logger(args.log_dir, "train_info.log")
    logger.info("Start....")
    if cfg.train.multiscale_steps > 0:
        logger.info("multi-scale training: buckets %s, redrawn every %d batches"
                    % (list(multiscale_buckets(cfg)), cfg.train.multiscale_every))
    train_idx = make_index(args.train_dir, cfg.io.class_names, logger, fmt=args.format)
    loader = DetectionLoader(train_idx, cfg, seed=cfg.train.seed, cache=args.cache_images)

    validator = None
    if args.val_dir:
        val_idx = make_index(args.val_dir, cfg.io.class_names, logger, fmt=args.format)
        val_loader = DetectionLoader(val_idx, cfg, augment=False, shuffle=False,
                                     drop_last=False)
        validator = MAPEvaluator(cfg, val_loader, logger=logger, arch=args.arch,
                                 iou_thresholds=COCO_IOU_GRID if args.coco_map else None,
                                 device=args.device)

    if variables is not None:
        logger.info("Load pretrained model %s" % args.pretrained)
    else:
        logger.info("initialize model")
    distill_fn = None
    if teacher is not None:
        distill_fn = make_teacher_fn(teacher, arch=args.distill_arch, device=args.device)
        logger.info("Distilling from %s (%s) with weight %g"
                    % (args.distill_teacher, args.distill_arch, args.distill_weight))
    try:
        trainer = Trainer(cfg, batch_per_epoch=len(loader), variables=variables, logger=logger,
                          arch=args.arch, distill_fn=distill_fn,
                          distill_weight=args.distill_weight, freeze=args.freeze,
                          compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                          device=args.device)
    except ValueError as e:
        if args.freeze and "--freeze" in str(e):
            raise SystemExit(str(e))
        raise
    start_epoch = 0
    if args.resume:
        path = latest_checkpoint(args.checkpoint_dir) if args.resume == "latest" else args.resume
        if path:
            trainer.restore_checkpoint(path)
            start_epoch = trainer.state.step // max(len(loader), 1)
            loader.skip_epochs(start_epoch)  # the batches of an uninterrupted run
            logger.info("Resumed full state from %s (epoch %d)" % (path, start_epoch))
        else:
            logger.info("No checkpoint to resume; starting fresh")

    if args.float64:
        trainer.to_float64()
    metrics = MetricsWriter(args.log_dir)
    try:
        trainer.fit(loader, validator=validator, checkpoint_dir=args.checkpoint_dir,
                    metrics_writer=metrics, start_epoch=start_epoch)
    finally:
        metrics.close()
    return 0
