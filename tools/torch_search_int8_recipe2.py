"""Recall-selected QAT for an int8 artifact, with the PyTorch port.

The port of ``tools/search_int8_recipe2.py``
(``yolofastest_torch.quant.recipes.search_recall_qat``): QAT runs with a
parameter snapshot every ``--snap`` steps (optionally conf-weighted
distillation), and the plain PTQ weights, the lowest-loss weights and
every snapshot are scored on the three int8 backends (per-layer, fused,
native VNNI on the host CPU); the first candidate whose smallest recall
reaches the target ships (``--ship``) to ``--out``.  Exits 1 where none
reaches it.

Usage:
  python tools/torch_search_int8_recipe2.py --res 256x320 --scales mseF \\
      --steps 800 --snap 40 --conf-weight 4 [--ship --out PATH] [--device cpu]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", required=True)
    ap.add_argument("--scales", default="mseF")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--snap", type=int, default=40)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--conf-weight", type=float, default=4.0)
    ap.add_argument("--weights", default=None,
                    help="checkpoint .npz (default: the stock zoo for --res;"
                         " pass the pruned checkpoint to build its artifact)")
    ap.add_argument("--out", default=None,
                    help="artifact path for --ship (default "
                         "int8_artifacts/yolofastest_int8_<res>.npz under the "
                         "repository, which git ignores)")
    ap.add_argument("--target", type=int, default=0,
                    help="recall target (default: all golden detections)")
    ap.add_argument("--ship", action="store_true",
                    help="write the int8 zoo artifact on a full-recall "
                         "snapshot")
    ap.add_argument("--device", default=None,
                    help="device of calibration, QAT and the int8 executors "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.eval.golden import golden_inputs
    from yolofastest_torch.models import fold_batchnorm, load_variables, zoo_path
    from yolofastest_torch.quant.recipes import make_scales, parse_scale_set, search_recall_qat

    try:
        parse_scale_set(args.scales)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    imgs, golden = golden_inputs(args.res)
    folded = fold_batchnorm(load_variables(args.weights or zoo_path(args.res)))
    scales = make_scales(folded, imgs, args.scales, args.device)
    out = None
    if args.ship:
        out = args.out or os.path.join(REPO, "int8_artifacts",
                                       f"yolofastest_int8_{args.res}.npz")
    found = search_recall_qat(folded, get_config(args.res), scales, spec=args.scales,
                              imgs=imgs, golden=golden, steps=args.steps, snap=args.snap,
                              lr=args.lr, conf_weight=args.conf_weight, target=args.target,
                              out=out, device=args.device)
    return 0 if found is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
