"""Command-line interface: ``python -m yolofastest_torch <command>``.

Every command of the JAX package's CLI (``python -m yolofastest_tpu``):

  detect    batch-detect a directory of images (also --fold-bn, --tta, --sliced RxC)
  serve     HTTP detection server with dynamic batching
  video     detect over a video file -> annotated video (optionally tracked)
  train     train on a VOC-XML or COCO dataset (checkpoints, validation)
  eval      mAP on a VOC-XML or COCO val set (--backend train | fp | native | native-int8
            | int8 | int8-fused)
  export    weights -> .yfb, ONNX, ncnn, Caffe and TorchScript artifacts, and with
            --calib-data the int8 QDQ ONNX, ncnn table and scaled .yfb (--qat-steps)
  convert   reference .pth, ncnn pair or .onnx -> zoo .npz
  prune     structured channel pruning of the res blocks -> smaller .npz
  sensitivity  per-layer int8 sensitivity table and a --keep-fp suggestion
  info      model summary: per-layer shapes, params, MACs (--device-cost: the port's
            count of operations and bytes)
  voc2coco  VOC-layout dataset -> COCO layout
  txt2xml   txt labels (YOLO rows or the reference's dump) -> VOC XML dataset
  anchors   k-means auto-anchors from a dataset's GT boxes

The first five and ``sensitivity`` take ``--device cuda|cpu`` (default
cuda); ``export`` takes it for its calibration and QAT, and writes its files
on the host; ``convert``, ``prune``, ``info`` and the data tools run on the
host.  ``detect``, ``serve``, ``video`` and ``eval`` take ``--backend
native|native-int8``: the C++ engine of ``cpp/`` on the host CPU
(``yolofastest_torch.native``; ``native-int8`` calibrates on ``--device``
on a cache miss).  ``--weights`` takes a zoo ``.npz``, a reference
``.pth``, an ``.onnx`` or a port checkpoint directory.  The top-level
``--compile-cache`` is accepted so that every JAX command line parses; it
has no effect (it names XLA's compilation cache).
"""

from __future__ import annotations

import argparse

from yolofastest_torch.cli.datatools import (add_datatools_parsers, cmd_anchors, cmd_txt2xml,
                                             cmd_voc2coco)
from yolofastest_torch.cli.detect import add_detect_parser, cmd_detect
from yolofastest_torch.cli.evaluate import add_eval_parser, cmd_eval
from yolofastest_torch.cli.export import add_export_parsers, cmd_convert, cmd_export
from yolofastest_torch.cli.info import add_info_parser, cmd_info
from yolofastest_torch.cli.quantize import add_quantize_parsers, cmd_prune, cmd_sensitivity
from yolofastest_torch.cli.serve import add_serve_parsers, cmd_serve, cmd_video
from yolofastest_torch.cli.train import add_train_parser, cmd_train


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="yolofastest_torch")
    p.add_argument("--compile-cache", default=None, metavar="DIR|off",
                   help="accepted for the JAX package's command lines; no effect here (it "
                        "names XLA's persistent compilation cache; the port's CUDA kernels "
                        "are cached under build/kernels)")
    sub = p.add_subparsers(dest="command", required=True)
    add_detect_parser(sub)
    add_serve_parsers(sub)
    add_train_parser(sub)
    add_eval_parser(sub)
    add_export_parsers(sub)
    add_quantize_parsers(sub)
    add_info_parser(sub)
    add_datatools_parsers(sub)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


__all__ = [
    "main",
    "build_parser",
    "cmd_anchors",
    "cmd_convert",
    "cmd_detect",
    "cmd_eval",
    "cmd_export",
    "cmd_info",
    "cmd_prune",
    "cmd_sensitivity",
    "cmd_serve",
    "cmd_train",
    "cmd_txt2xml",
    "cmd_video",
    "cmd_voc2coco",
]
