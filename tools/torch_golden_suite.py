"""Golden deployment matrix of the PyTorch port: every backend x both
resolutions over the golden frames, with golden recall and ms per image.

The port of ``tools/run_golden_suite.py`` (``yolofastest_torch.eval.
golden_suite``), with the same rows under the same names, ``jax-`` read as
``torch-``: torch-fp32, torch-bf16, int8, int8-fused, pruned040-bf16,
pruned040-int8, pruned040-int8-fused on ``--device``; native-cpp,
native-cpp-int8, pruned040-native-int8 (the C++ engine of ``cpp/``, found
or built from its sources) on the host CPU.  Writes ``summary.json`` and
the native ``.yfb`` files to ``--out``.

Usage: python tools/torch_golden_suite.py [--out DIR] [--device cuda|cpu]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="golden_suite_results")
    ap.add_argument("--device", default=None,
                    help="device of the device rows (default: the CUDA card)")
    args = ap.parse_args(argv)

    from yolofastest_torch.eval.golden_suite import run_suite

    run_suite(args.out, args.device)


if __name__ == "__main__":
    main()
