"""`prune` and `sensitivity` commands.

The port of ``yolofastest_tpu/cli/quantize.py``, with the JAX commands'
flags (``yolofastest_tpu/cli/parser.py``) and output.  ``prune`` is host
work (numpy); ``sensitivity`` runs its sweep on ``--device`` (default
cuda).
"""

from __future__ import annotations

import json
import os
import sys

from yolofastest_torch.cli._common import (UnportedWeights, add_config_args, calib_kwargs,
                                           check_arch_config, get_config, int8_cache_path,
                                           load_calibration, load_weights)


def add_quantize_parsers(sub) -> None:
    pr = sub.add_parser(
        "prune",
        help="structured channel pruning: drop the lowest-importance fraction of every res "
             "block's expansion channels; the pruned .npz runs/fine-tunes on every backend "
             "unchanged")
    pr.add_argument("--weights", required=True,
                    help=".npz, reference .pth, .onnx or a port checkpoint directory")
    pr.add_argument("--ratio", type=float, required=True,
                    help="fraction of inner channels to remove per block, in [0, 1)")
    pr.add_argument("--min-keep", type=int, default=4,
                    help="floor on kept channels per block (default 4)")
    pr.add_argument("--round-to", type=int, default=4,
                    help="kept widths round UP to this multiple (default 4)")
    pr.add_argument("--arch", choices=["fastest", "lite"], default="fastest")
    pr.add_argument("--config", default="256x320")
    pr.add_argument("--config-json")
    pr.add_argument("--out", required=True, help="output .npz path")
    pr.set_defaults(fn=cmd_prune)

    sn = sub.add_parser(
        "sensitivity",
        help="per-layer int8 sensitivity: quantise one layer at a time, rank the head-logit "
             "damage, suggest a --keep-fp set for mixed-precision deployment")
    add_config_args(sn)
    sn.add_argument("--weights", required=True,
                    help=".npz, reference .pth, .onnx or a port checkpoint directory")
    sn.add_argument("--data", required=True, help="probe/calibration image directory")
    sn.add_argument("--arch", default="fastest", choices=["fastest", "lite"])
    sn.add_argument("--images", type=int, default=8,
                    help="probe batch size (first N images of --data)")
    sn.add_argument("--top", type=int, default=5, help="size of the suggested --keep-fp set")
    sn.add_argument("--json-out", default=None, help="also write the ranked table as JSON")
    sn.add_argument("--calibration-cache", default=None,
                    help="JSON file for int8 activation scales (default: "
                         "<weights>.calib.json; reused when it exists)")
    sn.add_argument("--calib-method", default="amax",
                    choices=["amax", "mse", "percentile", "entropy"],
                    help="int8 activation-scale algorithm when no cache exists")
    sn.add_argument("--calib-percentile", type=float, default=99.99,
                    help="clip percentile for --calib-method percentile")
    sn.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sn.set_defaults(fn=cmd_sensitivity)


def _weights(args):
    try:
        return load_weights(args.weights, args.arch)
    except UnportedWeights as e:
        print(e, file=sys.stderr)
        return None


def cmd_prune(args) -> int:
    """Structured channel pruning (``models/prune.py``): drop the lowest-
    importance fraction of every res block's expansion channels and write a
    plain (smaller) weights tree, which every backend runs and ``train
    --pretrained`` fine-tunes."""
    from yolofastest_torch.models import fold_batchnorm, save_variables
    from yolofastest_torch.models.prune import prune_variables
    from yolofastest_torch.models.summary import summarize

    cfg = get_config(args)
    check_arch_config(cfg, args.arch)
    variables = _weights(args)
    if variables is None:
        return 2
    pruned, report = prune_variables(variables, args.ratio, min_keep=args.min_keep,
                                     round_to=args.round_to)
    walk_arch = "yolofastest" if args.arch == "fastest" else "yolofastest-lite"
    before = summarize(fold_batchnorm(variables), cfg.io.input_hw, walk_arch)
    after = summarize(fold_batchnorm(pruned), cfg.io.input_hw, walk_arch)

    print(f"{'block':<10} {'before':>7} {'after':>6}")
    for name, (old, new) in report.items():
        mark = "" if new == old else f"  (-{old - new})"
        print(f"{name:<10} {old:>7} {new:>6}{mark}")
    dp = 1.0 - after["total_params"] / before["total_params"]
    dm = 1.0 - after["total_macs"] / before["total_macs"]
    print(f"params {before['total_params']:,} -> {after['total_params']:,} (-{dp:.1%})")
    print(f"MACs   {before['total_macs']:,} -> {after['total_macs']:,} (-{dm:.1%})")
    save_variables(pruned, args.out)
    print(f"wrote {args.out}")
    return 0


def cmd_sensitivity(args) -> int:
    """Per-layer int8 sensitivity table (``quant/sensitivity.py``): quantise
    one layer at a time, measure the head-logit damage against the fp folded
    graph, rank worst first, and print the ``--keep-fp`` line that deploys
    the worst ``--top`` in float."""
    from yolofastest_torch.models import fold_batchnorm
    from yolofastest_torch.quant import layer_sensitivity

    cfg = get_config(args)
    check_arch_config(cfg, args.arch)
    variables = _weights(args)
    if variables is None:
        return 2
    folded = fold_batchnorm(variables)
    cal = load_calibration(args.data, cfg.io, k=args.images)
    if cal is None:
        return 2
    act_scales = None
    cache = int8_cache_path(args)
    if os.path.exists(cache):
        # one calibration serves every int8 entry point; a miss calibrates
        # on --data below (and writes no cache, as in JAX)
        with open(cache) as f:
            act_scales = {k: float(v) for k, v in json.load(f).items()}
        print(f"calibration scales: {cache}")
    rows = layer_sensitivity(folded, [cal], arch=args.arch, act_scales=act_scales,
                             device=args.device, **calib_kwargs(args))
    print(f"{'layer':<14} {'mean|d|':>12} {'max|d|':>12}")
    for r in rows:
        print(f"{r['layer']:<14} {r['mean_abs']:>12.6f} {r['max_abs']:>12.6f}")
    worst = ",".join(r["layer"] for r in rows[:args.top])
    print(f"\nsuggested mixed-precision deployment (worst {args.top}):")
    print(f"  --backend int8 --keep-fp {worst}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json_out}")
    return 0
