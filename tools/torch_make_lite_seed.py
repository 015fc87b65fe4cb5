"""Seed YoloFastest-lite from a converted full-model checkpoint, with the
PyTorch port (no JAX).

The lite parameter tree (backbone + the stride-32 ``head_5`` path) is a
subset of the full YoloFastest tree, so every lite weight is grafted from
the full checkpoint of ``--res`` (``yolofastest_torch.models.zoo.lite_seed``;
the port of ``tools/make_lite_seed.py``, whose output it equals leaf for
leaf).  The tree work is numpy on the host.

Usage: python tools/torch_make_lite_seed.py --out /tmp/lite_seed.npz [--res 256x320]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--res", default="256x320", choices=["256x320", "512x640"])
    args = ap.parse_args(argv)

    from yolofastest_torch.models import save_variables
    from yolofastest_torch.models.zoo import lite_seed

    save_variables(lite_seed(args.res), args.out)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
