"""`export` and `convert` commands: deployable artifacts out, weights in.

The port of ``yolofastest_tpu/cli/export.py`` for the fp artifacts, with the
JAX command's flags and file names.  Both commands run on the host: the
writers and readers are numpy, and the TorchScript trace runs on the CPU.
``export`` writes ``model.yfb``, ``model_int8.yfb`` (weights only),
``model.onnx``, ``detect.onnx``, ``model.param`` + ``model.bin``,
``model.prototxt`` + ``model.caffemodel`` and ``model.pt``.  The JAX
command's ``forward``/``detect`` ``.stablehlo`` and ``.mlir`` files are JAX
programs and are not written; ``--calib-data`` and ``--qat-steps`` (the
int8 artifacts with activation scales) exit 2 until the ROADMAP item
'Quantisation, part 2' ports them.
``convert`` writes a zoo-layout ``.npz`` from a ``.pth`` (or ``.npz``, or a
port checkpoint directory), an ncnn pair or an ``.onnx``.
"""

from __future__ import annotations

import os
import sys

from yolofastest_torch.cli._common import (UnportedWeights, add_config_args, check_arch_config,
                                           get_config, load_weights)

_IDENTITY_BN_NOTE = ("note: batch norms are identity-lifted from the folded artifact; "
                     "fine-tuning will re-estimate running stats")


def add_export_parsers(sub) -> None:
    x = sub.add_parser("export", help="export ONNX + ncnn + Caffe + TorchScript + native .yfb")
    add_config_args(x)
    x.add_argument("--weights", required=True,
                   help=".npz zoo file, reference .pth, .onnx or a port checkpoint directory")
    x.add_argument("--out", required=True)
    x.add_argument("--batch", type=int, default=1, help="batch of the traced model.pt")
    x.add_argument("--arch", default="fastest", choices=["fastest", "lite"],
                   help="model architecture; every artifact is emitted for both (lite = "
                        "single-head topology)")
    x.add_argument("--calib-data", default=None,
                   help="calibration images for the int8 artifacts with activation scales "
                        "(not ported yet)")
    x.add_argument("--qat-steps", type=int, default=0,
                   help="quantisation-aware distillation steps (not ported yet)")
    x.add_argument("--qat-lr", type=float, default=1e-4, help="learning rate for --qat-steps")
    x.add_argument("--calib-method", default="amax",
                   choices=["amax", "mse", "percentile", "entropy"],
                   help="int8 activation-scale algorithm (with --calib-data)")
    x.add_argument("--calib-percentile", type=float, default=99.99,
                   help="clip percentile for --calib-method percentile")
    x.set_defaults(fn=cmd_export)

    c = sub.add_parser("convert",
                       help="reference .pth, port checkpoint dir, ncnn .param/.bin, or .onnx "
                            "-> zoo .npz")
    c.add_argument("--pth", help="reference .pth, a .npz, or a port epoch_<n> checkpoint "
                                 "directory (its EMA model when the run kept one)")
    c.add_argument("--ncnn", help="ncnn .param path (the matching .bin beside it); the arch "
                                  "is detected")
    c.add_argument("--onnx", help=".onnx path: torch exports (BN preserved -> the exact "
                                  "unfolded variables) and our BN-folded exports; the arch is "
                                  "detected")
    c.add_argument("--out", required=True)
    c.set_defaults(fn=cmd_convert)


def cmd_export(args) -> int:
    from yolofastest_torch.export import (export_caffe, export_ncnn, export_onnx,
                                          export_onnx_detect, export_torchscript,
                                          save_native_weights)
    from yolofastest_torch.models import fold_batchnorm
    from yolofastest_torch.quant import quantize_weights

    if args.calib_data or args.qat_steps > 0:
        print("--calib-data and --qat-steps (int8 artifacts with activation scales) are not "
              "ported yet (ROADMAP: 'Quantisation, part 2')", file=sys.stderr)
        return 2
    cfg = get_config(args)
    check_arch_config(cfg, args.arch)
    try:
        variables = load_weights(args.weights, args.arch)
    except UnportedWeights as e:
        print(e, file=sys.stderr)
        return 2
    folded = fold_batchnorm(variables)
    os.makedirs(args.out, exist_ok=True)

    def out(name):
        return os.path.join(args.out, name)

    save_native_weights(folded, out("model.yfb"), io_config=cfg.io)
    print("wrote", out("model.yfb"))
    save_native_weights(quantize_weights(folded), out("model_int8.yfb"), io_config=cfg.io)
    print("wrote", out("model_int8.yfb"))
    graph_arch = "yolofastest" if args.arch == "fastest" else "yolofastest-lite"
    export_onnx(folded, cfg.io.input_hw, out("model.onnx"), arch=graph_arch)
    print("wrote", out("model.onnx"))
    export_onnx_detect(folded, cfg, out("detect.onnx"), arch=graph_arch)
    print("wrote", out("detect.onnx"))
    export_ncnn(folded, cfg.io.input_hw, out("model.param"), out("model.bin"), arch=graph_arch)
    print("wrote", out("model.param"), "+", out("model.bin"))
    export_caffe(folded, cfg.io.input_hw, out("model.prototxt"), out("model.caffemodel"),
                 arch=graph_arch)
    print("wrote", out("model.prototxt"), "+", out("model.caffemodel"))
    export_torchscript(folded, cfg.io.input_hw, out("model.pt"), batch=args.batch,
                       arch=graph_arch)
    print("wrote", out("model.pt"))
    print("not written: forward.stablehlo, forward.mlir, detect.stablehlo and detect.mlir are "
          "JAX programs (python -m yolofastest_tpu export writes them)")
    return 0


def cmd_convert(args) -> int:
    from yolofastest_torch.models import save_variables

    given = [o for o in ("pth", "ncnn", "onnx") if getattr(args, o, None)]
    if len(given) != 1:
        print("convert: give exactly one of --pth / --ncnn / --onnx")
        return 2
    if args.ncnn:
        from yolofastest_torch.export import import_ncnn
        from yolofastest_torch.models import unfold_to_variables

        folded, arch = import_ncnn(args.ncnn)
        save_variables(unfold_to_variables(folded), args.out)
        print(f"{args.ncnn} ({arch}) -> {args.out}")
        print(_IDENTITY_BN_NOTE)
        return 0
    if args.onnx:
        from yolofastest_torch.export import import_onnx

        variables, arch, bn_preserved = import_onnx(args.onnx)
        save_variables(variables, args.out)
        print(f"{args.onnx} ({arch}) -> {args.out}")
        if not bn_preserved:
            print(_IDENTITY_BN_NOTE)
        return 0
    try:
        variables = load_weights(args.pth)
    except UnportedWeights as e:
        print(e, file=sys.stderr)
        return 2
    save_variables(variables, args.out)
    print(f"{args.pth} -> {args.out}")
    return 0
