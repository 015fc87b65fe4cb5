"""`export` and `convert` commands: deployable artifacts out, weights in.

The port of ``yolofastest_tpu/cli/export.py``, with the JAX command's flags,
file names and output.  ``export`` writes ``model.yfb``, ``model_int8.yfb``,
``model.onnx``, ``detect.onnx``, ``model.param`` + ``model.bin``,
``model.prototxt`` + ``model.caffemodel`` and ``model.pt``.  With
``--calib-data`` it calibrates on the first 8 images (a missing or empty
directory skips the int8 extras and still writes the fp files), so
``model_int8.yfb`` carries the activation scales, and it writes
``model_int8.onnx`` (QDQ) and ``model.table`` (ncnn's int8 calibration
table, from the fp weights that ``model.param``/``model.bin`` ship);
``--qat-steps N`` first fine-tunes the int8 artifacts' weights by
quantisation-aware distillation on those images.  The calibration and QAT
run on ``--device`` (default cuda); the writers are numpy and the
TorchScript trace runs on the CPU.  Where the JAX command writes its
serialised programs (``forward``/``detect.stablehlo``, and
``forward_int8.stablehlo`` with calibration images), this one writes
``forward.pt2`` and ``detect.pt2`` (and ``forward_int8.pt2``), exported on
``--device``, where they will run (``yolofastest_torch.export.pt2``), and
beside the first two their StableHLO text, ``forward.mlir`` and
``detect.mlir``, which ``cpp/runner/shlo_runner.cpp`` (``yf_shlo``) runs with
no Python in the process (``yolofastest_torch.export.mlir``).
``convert`` writes a zoo-layout ``.npz`` from a ``.pth`` (or ``.npz``, or a
port checkpoint directory), an ncnn pair or an ``.onnx``.
"""

from __future__ import annotations

import os
import sys

from yolofastest_torch.cli._common import (UnportedWeights, add_config_args, calib_kwargs,
                                           check_arch_config, get_config, load_calibration,
                                           load_weights)

_IDENTITY_BN_NOTE = ("note: batch norms are identity-lifted from the folded artifact; "
                     "fine-tuning will re-estimate running stats")


def add_export_parsers(sub) -> None:
    x = sub.add_parser("export", help="export ONNX + ncnn + Caffe + TorchScript + native .yfb "
                                           "+ the .pt2 programs and their StableHLO text "
                                           "(+ the int8 files with --calib-data)")
    add_config_args(x)
    x.add_argument("--weights", required=True,
                   help=".npz zoo file, reference .pth, .onnx or a port checkpoint directory")
    x.add_argument("--out", required=True)
    x.add_argument("--batch", type=int, default=1,
                   help="batch of the traced model.pt and of the .pt2 programs")
    x.add_argument("--arch", default="fastest", choices=["fastest", "lite"],
                   help="model architecture; every artifact is emitted for both (lite = "
                        "single-head topology)")
    x.add_argument("--calib-data", default=None,
                   help="directory of calibration images; when given, the int8 artifacts "
                        "carry activation scales, and model_int8.onnx (QDQ) and model.table "
                        "(ncnn int8 calibration) are written too")
    x.add_argument("--qat-steps", type=int, default=0,
                   help="quantisation-aware distillation steps on the calibration images "
                        "before emitting the int8 artifacts (needs --calib-data; the fp "
                        "artifacts keep the original weights)")
    x.add_argument("--qat-lr", type=float, default=1e-4, help="Adam learning rate for --qat-steps")
    x.add_argument("--calib-method", default="amax",
                   choices=["amax", "mse", "percentile", "entropy"],
                   help="int8 activation-scale algorithm (with --calib-data)")
    x.add_argument("--calib-percentile", type=float, default=99.99,
                   help="clip percentile for --calib-method percentile")
    x.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the calibration and QAT run and the .pt2 programs are "
                        "exported to run (the other writers run on the host)")
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
    from yolofastest_torch.export import (export_caffe, export_detect_pipeline,
                                          export_folded_forward, export_int8_forward,
                                          export_ncnn, export_ncnn_table, export_onnx,
                                          export_onnx_detect, export_onnx_qdq,
                                          export_torchscript, save_exported,
                                          save_exported_mlir, save_native_weights)
    from yolofastest_torch.models import fold_batchnorm
    from yolofastest_torch.quant import calibrate, qat_finetune, quantize_weights

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

    cal = act_scales = None
    if args.calib_data:
        # a missing or empty directory skips the int8 extras, not the fp files
        # (the JAX command's os.listdir raises for a missing one)
        if os.path.isdir(args.calib_data):
            cal = load_calibration(args.calib_data, cfg.io)
        else:
            print(f"no calibration images (.jpg/.png/.bmp) in {args.calib_data}")
        if cal is not None:
            act_scales = calibrate(folded, [cal], arch=args.arch, device=args.device,
                                   **calib_kwargs(args))
    # the int8 artifacts may come from QAT-refined weights; the fp ones
    # always ship the original checkpoint
    int8_src = folded
    if args.qat_steps > 0:
        if act_scales is None:
            print("--qat-steps needs --calib-data (skipping QAT)")
        else:
            int8_src, hist = qat_finetune(folded, act_scales, [cal], arch=args.arch,
                                          steps=args.qat_steps, lr=args.qat_lr,
                                          device=args.device)
            # the lowest-loss iterate ships, so min(hist) is the exported point
            print("QAT distillation: loss %.3e -> %.3e (best of %d steps)"
                  % (hist[0], min(hist), len(hist)))

    save_native_weights(folded, out("model.yfb"), io_config=cfg.io)
    print("wrote", out("model.yfb"))
    # with --calib-data the int8 .yfb carries activation scales too
    qparams = quantize_weights(int8_src)
    save_native_weights(qparams, out("model_int8.yfb"), act_scales=act_scales, io_config=cfg.io)
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
    if act_scales is not None:
        export_onnx_qdq(qparams, act_scales, cfg.io.input_hw, out("model_int8.onnx"),
                        arch=graph_arch)
        print("wrote", out("model_int8.onnx"))
        # ncnn2int8 quantises the fp weights of model.param/model.bin with
        # this table, so it is made from those weights even after QAT (whose
        # smaller multipliers would clip them); the QAT refinement ships in
        # model_int8.yfb and model_int8.onnx
        table_qparams = qparams if int8_src is folded else quantize_weights(folded)
        export_ncnn_table(table_qparams, act_scales, out("model.table"), arch=graph_arch)
        print("wrote", out("model.table"))
    export_torchscript(folded, cfg.io.input_hw, out("model.pt"), batch=args.batch,
                       arch=graph_arch)
    print("wrote", out("model.pt"))
    programs = [("forward.pt2", lambda: export_folded_forward(
                    folded, cfg, batch=args.batch, arch=args.arch, device=args.device)),
                ("detect.pt2", lambda: export_detect_pipeline(
                    variables, cfg, batch=args.batch, arch=args.arch, device=args.device))]
    if cal is not None:
        # int8_src/act_scales carry the QAT refinement when --qat-steps ran
        programs.append(("forward_int8.pt2", lambda: export_int8_forward(
            variables, cfg, cal, batch=args.batch, arch=args.arch, folded=int8_src,
            act_scales=act_scales, device=args.device)))
    for name, export in programs:
        program = export()
        save_exported(program, out(name))
        print("wrote", out(name))
        if name != "forward_int8.pt2":  # as in JAX, the int8 program has no text twin
            # the textual twin for the native consumer (yf_shlo)
            save_exported_mlir(program, out(name.replace(".pt2", ".mlir")))
            print("wrote", out(name.replace(".pt2", ".mlir")))
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
