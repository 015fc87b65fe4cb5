"""Hybrid-int8 (keep-fp) recipe search for the pruned checkpoint, with the
PyTorch port.

The port of ``tools/search_pruned_int8.py``
(``yolofastest_torch.quant.recipes.search_hybrid_keep_fp``):

  for each calibration scale set:
    rank layers by int8 damage (layer_sensitivity at those scales)
    greedily keep the worst layers in fp, scoring JOINT recall on
      * per-layer mixed   (quantized_apply_flagged: flags on the device)
      * fused mixed       (quantized_apply_fused_flagged)
      * native VNNI hybrid (mixed_native_tree -> NativeEngine, host CPU),
        scored only where both of the others are full
    stop at the first set with full recall on all three

The set with the fewest fp layers over all scale sets wins; ``--ship``
writes it (the pruned checkpoint's folded weights, the scales, the
``keep_fp`` set) to ``--out``.  Exits 1 where no set has full recall.

Usage:
  python tools/torch_search_pruned_int8.py [--res 256x320] [--weights PATH]
      [--scale-sets amax8,mse12,...] [--max-keep 8] [--ship] [--out PATH]
      [--device cuda|cpu]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    from yolofastest_torch.quant.recipes import PRUNED_SCALE_SETS

    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="256x320")
    ap.add_argument("--weights", default=None,
                    help="checkpoint .npz (default: the pruned040 zoo)")
    ap.add_argument("--scale-sets", default=PRUNED_SCALE_SETS)
    ap.add_argument("--max-keep", type=int, default=8)
    ap.add_argument("--scan-width", type=int, default=20,
                    help="sensitivity-ranked candidates scored per greedy "
                         "step")
    ap.add_argument("--ship", action="store_true")
    ap.add_argument("--out", default=None,
                    help="artifact path for --ship (default int8_artifacts/"
                         "yolofastest_int8_pruned040_<res>.npz under the "
                         "repository, which git ignores)")
    ap.add_argument("--device", default=None,
                    help="device of calibration, the sweep and the flagged "
                         "applies (default: the CUDA card)")
    args = ap.parse_args(argv)

    from yolofastest_torch.configs import get_config
    from yolofastest_torch.eval.golden import golden_inputs
    from yolofastest_torch.models import fold_batchnorm, load_variables
    from yolofastest_torch.quant import save_int8_zoo
    from yolofastest_torch.quant.recipes import parse_scale_set, search_hybrid_keep_fp

    specs = args.scale_sets.split(",")
    for spec in specs:
        try:
            parse_scale_set(spec)
        except ValueError:
            raise SystemExit(f"bad scale set {spec}") from None
    res = args.res
    weights = args.weights or os.path.join(REPO, "weights", f"yolofastest_pruned040_{res}.npz")
    folded = fold_batchnorm(load_variables(weights))
    imgs, golden = golden_inputs(res)
    best = search_hybrid_keep_fp(folded, get_config(res), imgs, golden, specs,
                                 max_keep=args.max_keep, scan_width=args.scan_width,
                                 device=args.device)
    if best is None:
        print("NO full-recall hybrid found within the search budget")
        return 1
    n_keep, spec, keep, recalls, scales = best
    print(f"WINNER: scales={spec} keep_fp={list(keep)} "
          f"({n_keep} fp layers) recalls={recalls}")
    if args.ship:
        out = args.out or os.path.join(REPO, "int8_artifacts",
                                       f"yolofastest_int8_pruned040_{res}.npz")
        save_int8_zoo(folded, scales, out, keep_fp=keep)
        print("shipped", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
