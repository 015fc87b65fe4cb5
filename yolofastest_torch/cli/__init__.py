"""Command-line interface: ``python -m yolofastest_torch <command>``.

The port's subset of the JAX package's CLI (the fp backend):

  detect    batch-detect a directory of images (also --tta, --sliced RxC)
  serve     HTTP detection server with dynamic batching
  video     detect over a video file -> annotated video (optionally tracked)
  train     train on a VOC-XML or COCO dataset (checkpoints, validation)
  eval      mAP on a VOC-XML or COCO val set (--backend train | fp)

Each takes ``--device cuda|cpu`` (default cuda).

The other commands of ``python -m yolofastest_tpu`` are not ported yet
(ROADMAP, "Modules": to port).
"""

from __future__ import annotations

import argparse

from yolofastest_torch.cli.detect import add_detect_parser
from yolofastest_torch.cli.evaluate import add_eval_parser
from yolofastest_torch.cli.serve import add_serve_parsers
from yolofastest_torch.cli.train import add_train_parser


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="yolofastest_torch")
    sub = p.add_subparsers(dest="command", required=True)
    add_detect_parser(sub)
    add_serve_parsers(sub)
    add_train_parser(sub)
    add_eval_parser(sub)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


__all__ = ["build_parser", "main"]
