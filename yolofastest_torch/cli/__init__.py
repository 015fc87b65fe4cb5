"""Command-line interface: ``python -m yolofastest_torch <command>``.

The port's subset of the JAX package's CLI:

  detect    batch-detect a directory of images (fp32 folded graph)

The other commands of ``python -m yolofastest_tpu`` are not ported yet
(ROADMAP, "Modules": to port).
"""

from __future__ import annotations

import argparse

from yolofastest_torch.cli.detect import add_detect_parser


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="yolofastest_torch")
    sub = p.add_subparsers(dest="command", required=True)
    add_detect_parser(sub)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


__all__ = ["build_parser", "main"]
