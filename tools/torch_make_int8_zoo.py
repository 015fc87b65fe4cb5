"""Regenerate the int8 deployment artifacts with the PyTorch port.

Per resolution, writes ``<--out>/yolofastest_int8_<res>.npz`` (``folded``:
the BN-folded weights, QAT-refined for 256x320; ``act_scales``: the frozen
activation scales), never into ``weights/``.  The default reproduces the
shipped recipes of ``tools/make_int8_zoo.py``
(``yolofastest_torch.quant.recipes.build_shipped``):

  * 512x640: plain PTQ weights, amax scales over the first 16 golden images;
  * 256x320: recall-selected QAT (amax-8 scales, conf_weight 4, snapshots
    every 20 of 800 steps), shipped at the first candidate with full recall
    on all three int8 backends (per-layer, fused, native); exits with an
    error where none has it.

``--custom`` switches to the loss-selected exploration flow with the
``--steps/--lr/--method/--calib-k`` knobs (not a shipped recipe).

Usage: python tools/torch_make_int8_zoo.py [--res 256x320 512x640] [--custom ...]
           [--out DIR] [--device cuda|cpu]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", nargs="+", default=["256x320", "512x640"])
    ap.add_argument("--custom", action="store_true",
                    help="generic loss-selected flow with the knobs below "
                         "instead of the shipped per-resolution recipes")
    ap.add_argument("--steps", type=int, default=200,
                    help="[--custom] QAT steps (0 = plain PTQ weights)")
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--method", default="amax",
                    choices=["amax", "mse", "percentile", "entropy"])
    ap.add_argument("--calib-k", type=int, default=0,
                    help="[--custom] calibrate on first K golden images "
                         "(0 = all)")
    ap.add_argument("--out", default=os.path.join(REPO, "int8_artifacts"),
                    help="directory of the artifacts (default: int8_artifacts/ "
                         "under the repository, which git ignores)")
    ap.add_argument("--device", default=None,
                    help="device of calibration, QAT and the int8 executors "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    from yolofastest_torch.quant.recipes import build_custom, build_shipped

    for res in args.res:
        out = os.path.join(args.out, f"yolofastest_int8_{res}.npz")
        if args.custom:
            build_custom(res, out, args.steps, args.lr, args.method, args.calib_k, args.device)
        else:
            build_shipped(res, out, args.device)


if __name__ == "__main__":
    main()
