"""Command-line interface: ``python -m yolofastest_torch <command>``.

The port's subset of the JAX package's CLI (the fp, int8 and int8-fused
backends):

  detect    batch-detect a directory of images (also --fold-bn, --tta, --sliced RxC)
  serve     HTTP detection server with dynamic batching
  video     detect over a video file -> annotated video (optionally tracked)
  train     train on a VOC-XML or COCO dataset (checkpoints, validation)
  eval      mAP on a VOC-XML or COCO val set (--backend train | fp | int8 | int8-fused)
  export    weights -> .yfb, ONNX, ncnn, Caffe and TorchScript artifacts, and with
            --calib-data the int8 QDQ ONNX, ncnn table and scaled .yfb (--qat-steps)
  convert   reference .pth, ncnn pair or .onnx -> zoo .npz
  prune     structured channel pruning of the res blocks -> smaller .npz
  sensitivity  per-layer int8 sensitivity table and a --keep-fp suggestion

The first five and ``sensitivity`` take ``--device cuda|cpu`` (default
cuda); ``export`` takes it for its calibration and QAT, and writes its files
on the host; ``convert`` and ``prune`` run on the host.  ``--weights``
takes a zoo ``.npz``, a reference ``.pth``, an ``.onnx`` or a port
checkpoint directory.

The other commands of ``python -m yolofastest_tpu`` (``info``, ``voc2coco``,
``txt2xml``, ``anchors``) are not ported yet (ROADMAP, "Modules": to port).
"""

from __future__ import annotations

import argparse

from yolofastest_torch.cli.detect import add_detect_parser
from yolofastest_torch.cli.evaluate import add_eval_parser
from yolofastest_torch.cli.export import add_export_parsers
from yolofastest_torch.cli.quantize import add_quantize_parsers
from yolofastest_torch.cli.serve import add_serve_parsers
from yolofastest_torch.cli.train import add_train_parser


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="yolofastest_torch")
    sub = p.add_subparsers(dest="command", required=True)
    add_detect_parser(sub)
    add_serve_parsers(sub)
    add_train_parser(sub)
    add_eval_parser(sub)
    add_export_parsers(sub)
    add_quantize_parsers(sub)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


__all__ = ["build_parser", "main"]
