"""`info` command: the model summary (per-layer shapes, parameters and MACs
from the deployment walk), as ``python -m yolofastest_tpu info`` prints it.
``--device-cost`` adds the port's own count of its fp32 forward's
operations and bytes per image (:func:`~yolofastest_torch.models.summary.
device_cost_analysis`), not XLA's compiled cost analysis.  Host arithmetic
only: no device is used."""

from __future__ import annotations

from yolofastest_torch.cli._common import add_config_args, check_arch_config, get_config


def add_info_parser(sub) -> None:
    i = sub.add_parser("info", help="model summary: per-layer shapes, params, MACs "
                                    "(optionally the port's count of operations and bytes)")
    add_config_args(i, choices=None)
    i.add_argument("--arch", choices=["fastest", "lite"], default="fastest")
    i.add_argument("--weights", help="optional .npz/.pth/.onnx/checkpoint dir; fresh init "
                                     "when omitted (shapes need only channel counts)")
    i.add_argument("--device-cost", action="store_true",
                   help="also report the port's count of its fp32 forward's operations and "
                        "bytes per image at --batch (from the walk's shapes; the JAX command "
                        "reports XLA's compiled cost here)")
    i.add_argument("--batch", type=int, default=8, help="batch for --device-cost")
    i.add_argument("--json-out", help="also dump the summary dict as JSON")
    i.set_defaults(fn=cmd_info)


def cmd_info(args) -> int:
    """Model summary (per-layer shapes/params/MACs from the deployment
    topology walk); the reference has no model introspection at all."""
    import json

    from yolofastest_torch.cli._common import load_weights
    from yolofastest_torch.models import build_model, fold_batchnorm, variables_from_module
    from yolofastest_torch.models.summary import (device_cost_analysis, format_summary,
                                                  summarize)

    cfg = get_config(args)
    check_arch_config(cfg, args.arch)
    arch = "yolofastest-lite" if args.arch == "lite" else "yolofastest"
    if args.weights:
        variables = load_weights(args.weights, args.arch)
    else:  # shapes and parameter counts need only the channel counts
        variables = variables_from_module(build_model(cfg.io.num_cls, cfg.io.num_anchors,
                                                      arch=args.arch, seed=0))
    folded = fold_batchnorm(variables)
    s = summarize(folded, cfg.io.input_hw, arch=arch)
    cost = None
    if args.device_cost:
        cost = device_cost_analysis(folded, cfg.io.input_hw, arch=arch, batch=args.batch)
    print(format_summary(s, device_cost=cost))
    if args.json_out:
        out = dict(s)
        if cost:
            out["device_cost"] = cost
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.json_out)
    return 0
