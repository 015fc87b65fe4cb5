"""Helpers shared by the port's commands: config, weights, datasets, int8
calibration and the Detector.

The int8 helpers are the JAX package's (``yolofastest_tpu/cli/_common.py``)
under the port's names: ``load_calibration`` (``_load_calibration``),
``calib_kwargs``, ``int8_cache_path``, ``resolve_int8_calibration``
(``_resolve_jax_int8_calibration``), ``parse_keep_fp``, ``resolve_int8_zoo``
and ``add_int8_args`` (the flags of ``parser.py``, with
``_add_calib_method_flags``) and ``native_int8_scales``
(``_native_int8_scales``); ``build_detector`` is ``_build_engine``, and
``write_native_weights`` stages the native backends' ``.yfb`` as its native
branch and the JAX ``detect`` do.
"""

from __future__ import annotations

import os
import sys

CONFIGS = ["256x320", "512x640", "lite-256x320", "lite-512x640"]
INT8_BACKENDS = ("int8", "int8-fused")
# the C++ engine of cpp/ (yolofastest_torch.native), fp32 or int8 arithmetic
NATIVE_BACKENDS = ("native", "native-int8")
NATIVE_TTA = ("--tta runs the flip pass on device; it applies to the "
              "jax backends (fp/int8/int8-fused), not the C++ engine")


def add_model_args(p) -> None:
    """``--config``, ``--config-json``, ``--weights``, ``--arch``,
    ``--backend``, ``--device`` and the int8 flags (``detect`` and
    ``video`` add :func:`add_tta_arg`; ``serve`` has no ``--tta``, as in
    JAX)."""
    add_config_args(p)
    p.add_argument("--weights", required=True,
                   help=".npz zoo file, reference .pth, .onnx or a port checkpoint directory")
    p.add_argument("--backend", default="fp",
                   choices=["fp", "jax", *NATIVE_BACKENDS, *INT8_BACKENDS],
                   help="fp (or its alias jax); native = fp32 C++ engine on the host CPU; "
                        "native-int8 = the C++ engine with int8 VNNI arithmetic (calibrates "
                        "on the first 8 images unless the cache or --int8-zoo gives the "
                        "scales); int8 = per-layer int8 weights and inputs, int8-fused = "
                        "end-to-end int8 activations")
    p.add_argument("--arch", default="fastest", choices=["fastest", "lite"],
                   help="model architecture (lite = single-head variant; "
                        "use with a lite-* config)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_int8_args(p)


def add_tta_arg(p) -> None:
    p.add_argument("--tta", action="store_true",
                   help="horizontal-flip test-time augmentation: the mirrored "
                        "batch rides the same forward and both candidate sets "
                        "merge into one NMS")


def add_int8_args(p) -> None:
    """The int8 backends' flags: ``--int8-zoo``, ``--keep-fp``,
    ``--calib-data``, ``--calibration-cache``, ``--calib-method`` and
    ``--calib-percentile``."""
    p.add_argument("--int8-zoo", nargs="?", const="auto", default=None, metavar="PATH",
                   help="deploy the SHIPPED int8 artifact (refined weights + frozen scales, "
                        "full golden recall on every int8 backend) instead of calibrating; "
                        "bare flag resolves weights/yolofastest_int8_<config>.npz")
    p.add_argument("--keep-fp", default=None, metavar="L1,L2,...",
                   help="mixed precision for --backend int8: these folded-graph layers run "
                        "the fp kernel")
    p.add_argument("--calib-data", default=None,
                   help="calibration image dir for the int8 backends and native-int8 "
                        "(detect: default --data)")
    p.add_argument("--calibration-cache", default=None,
                   help="JSON file for int8 activation scales (default: "
                        "<weights>.calib.json)")
    p.add_argument("--calib-method", default="amax",
                   choices=["amax", "mse", "percentile", "entropy"],
                   help="int8 activation-scale algorithm: amax (exact range, default), mse "
                        "(min-quant-error clip), percentile, entropy (KL). Non-amax methods "
                        "get their own cache file suffix")
    p.add_argument("--calib-percentile", type=float, default=99.99,
                   help="clip percentile for --calib-method percentile")


def check_arch_config(cfg, arch: str) -> None:
    """Fail fast on an arch/config mismatch: the lite arch emits ONE head, so
    it needs a one-anchor-group (lite-*) preset, and the other way round."""
    n_heads = 1 if arch == "lite" else 2
    n_groups = len(cfg.io.anchors)
    if n_heads != n_groups:
        raise SystemExit(
            f"--arch {arch} produces {n_heads} head(s) but the config has "
            f"{n_groups} anchor group(s); use "
            f"{'a lite-* config preset' if arch == 'lite' else 'a non-lite config preset'}")


def check_arch_weights(variables, arch: str, path: str) -> None:
    """Fail fast when the weights' head set contradicts --arch."""
    two_head = "head_4" in variables.get("params", {})
    if two_head != (arch != "lite"):
        kind = "two-head" if two_head else "single-head (lite)"
        want = "fastest" if two_head else "lite"
        raise SystemExit(f"{path} holds a {kind} model but --arch is "
                         f"{arch!r}; pass --arch {want}")


def build_detector(args, logger=None, fold_bn: bool = True, calib_data=None, cfg=None):
    """(config, engine) from the model arguments, or None after a printed
    message: a weights format the port does not read, or a misused flag.
    The engine is a :class:`~yolofastest_torch.inference.Detector`, or for
    the native backends a :class:`~yolofastest_torch.native.NativeEngine`
    over a ``.yfb`` staged in a temporary directory (the engine reads it
    whole when it is made).  An int8 backend without ``--int8-zoo`` takes
    its scales from the calibration cache, or calibrates on the first 8
    images of ``calib_data`` and writes the cache.  ``cfg`` defaults to the
    arguments' config."""
    from yolofastest_torch.inference import Detector

    backend = "fp" if args.backend == "jax" else args.backend
    tta = getattr(args, "tta", False)  # serve has no --tta
    if cfg is None:
        cfg = get_config(args)
        check_arch_config(cfg, args.arch)
    zoo8 = resolve_int8_zoo(args, backend)
    if zoo8 == "error":
        return None
    if backend in NATIVE_BACKENDS:
        if tta:
            print(NATIVE_TTA)
            return None
        import tempfile

        from yolofastest_torch.native import NativeEngine

        with tempfile.TemporaryDirectory(prefix="yf_engine_") as td:
            yfb = os.path.join(td, "model.yfb")
            if not write_native_weights(args, cfg, backend, zoo8, calib_data, yfb):
                return None
            return cfg, NativeEngine(yfb, cfg)
    try:
        variables = load_weights(args.weights, args.arch)
    except UnportedWeights as e:
        print(e, file=sys.stderr)
        return None
    keep_fp = parse_keep_fp(args, backend)
    if keep_fp is None:
        return None
    calibration = cache = None
    if backend in INT8_BACKENDS and not zoo8:
        resolved = resolve_int8_calibration(args, cfg, calib_data)
        if resolved is None:
            return None
        calibration, cache = resolved
    ck = calib_kwargs(args)
    detector = Detector(cfg, variables=variables, logger=logger, fold_bn=fold_bn,
                        device=args.device, backend=backend, arch=args.arch, tta=tta,
                        calibration=calibration, calibration_cache=cache,
                        calib_method=ck["method"], calib_percentile=ck["percentile"],
                        keep_fp=keep_fp, int8_artifact=zoo8)
    return cfg, detector


def write_native_weights(args, cfg, backend, zoo8, calib_data, path) -> bool:
    """Write the ``.yfb`` of a native backend to ``path`` through the calls
    the JAX commands make: the folded ``--weights``, or for ``native-int8``
    the int8 tree of :func:`~yolofastest_torch.quant.mixed_native_tree` with
    its activation scales (the shipped artifact's tree and scales with
    ``--int8-zoo``, else :func:`native_int8_scales`).  ``--keep-fp`` is
    refused with the message of the other backends.  False after a printed
    message."""
    from yolofastest_torch.export import save_native_weights
    from yolofastest_torch.models import fold_batchnorm
    from yolofastest_torch.quant import load_int8_zoo, mixed_native_tree

    if parse_keep_fp(args, backend) is None:
        return False
    if backend == "native-int8" and zoo8:
        # the shipped artifact: refined weights, frozen scales, its keep-fp set
        folded, scales, keep_fp8 = load_int8_zoo(zoo8)
    else:
        try:
            folded = fold_batchnorm(load_weights(args.weights, args.arch))
        except UnportedWeights as e:
            print(e, file=sys.stderr)
            return False
        if backend == "native":
            save_native_weights(folded, path, io_config=cfg.io)
            return True
        scales, keep_fp8 = native_int8_scales(args, cfg, folded, calib_data), ()
        if scales is None:
            return False
    tree, nscales = mixed_native_tree(folded, scales, keep_fp8)
    save_native_weights(tree, path, act_scales=nscales, io_config=cfg.io)
    return True


def native_int8_scales(args, cfg, folded, data_dir):
    """Activation scales for the native int8 engine from the same cache file
    as the int8 backends (one calibration serves every backend).  On a miss
    it calibrates on the first 8 images of ``data_dir`` on ``--device`` and
    writes the cache; returns None after a printed message."""
    import json

    from yolofastest_torch.quant import calibrate

    cache = int8_cache_path(args)
    if os.path.exists(cache):
        with open(cache) as f:
            return {k: float(v) for k, v in json.load(f).items()}
    if not data_dir:
        print("native-int8 calibration needs images: pass a data/--calib-data "
              f"directory (or reuse an existing cache at {cache})", file=sys.stderr)
        return None
    cal = load_calibration(data_dir, cfg.io)
    if cal is None:
        return None
    scales = calibrate(folded, [cal], arch=args.arch, device=args.device, **calib_kwargs(args))
    with open(cache, "w") as f:
        json.dump(scales, f, indent=1)
    return scales


def load_calibration(data_dir: str, io, k: int = 8):
    """First ``k`` images of a directory as one net-input batch (the int8
    calibration recipe), or ``None`` after a printed message when the
    directory holds no readable images."""
    import numpy as np

    from yolofastest_torch.inference.detector import load_net_input

    names = sorted(f for f in os.listdir(data_dir)
                   if f.lower().endswith((".jpg", ".png", ".bmp")))[:k]
    if not names:
        print(f"no calibration images (.jpg/.png/.bmp) in {data_dir}")
        return None
    return np.concatenate([load_net_input(os.path.join(data_dir, n), io)[0] for n in names])


def calib_kwargs(args) -> dict:
    """Calibration-algorithm kwargs shared by every int8 entry point."""
    return {"method": getattr(args, "calib_method", "amax"),
            "percentile": getattr(args, "calib_percentile", 99.99)}


def int8_cache_path(args) -> str:
    """The scale cache: ``--calibration-cache``, else beside ``--weights``
    with a suffix that encodes the calibration method (amax keeps the bare
    ``.calib.json``)."""
    if args.calibration_cache:
        return args.calibration_cache
    method = getattr(args, "calib_method", "amax")
    if method == "percentile":
        suffix = ".calib-percentile%g.json" % getattr(args, "calib_percentile", 99.99)
    elif method != "amax":
        suffix = f".calib-{method}.json"
    else:
        suffix = ".calib.json"
    return os.path.splitext(args.weights)[0] + suffix


def resolve_int8_calibration(args, cfg, data_dir):
    """Cache-or-calibrate resolution for the int8 backends: ``(calibration
    batch or None, cache path)`` for the Detector (None on a cache hit: the
    Detector reads the file), or ``None`` after a printed message."""
    cache = int8_cache_path(args)
    if os.path.exists(cache):
        return None, cache
    if not data_dir:
        print("int8 calibration needs images: pass --calib-data (or reuse "
              f"an existing cache at {cache})", file=sys.stderr)
        return None
    cal = load_calibration(data_dir, cfg.io)
    if cal is None:
        return None
    return cal, cache


def parse_keep_fp(args, backend) -> tuple:
    """``--keep-fp a,b,c`` -> layer-name tuple.  Returns ``None`` after a
    printed message when the flag is set on a backend that cannot mix."""
    keep = tuple(s for s in (getattr(args, "keep_fp", None) or "").split(",") if s)
    if keep and backend not in INT8_BACKENDS:
        print("--keep-fp (mixed precision) applies to the int8 backends "
              "(int8 / int8-fused) only", file=sys.stderr)
        return None
    if keep and getattr(args, "int8_zoo", None):
        print("--keep-fp and --int8-zoo are exclusive (the zoo artifact "
              "already fixes the per-layer deployment)", file=sys.stderr)
        return None
    return keep


def resolve_int8_zoo(args, backend):
    """``--int8-zoo [PATH]`` -> artifact path (or None when unused); 'auto'
    (the bare flag) is the shipped artifact of ``--config``.  Returns the
    string "error" after a printed message."""
    from yolofastest_torch.quant import int8_zoo_path

    want = getattr(args, "int8_zoo", None)
    if not want:
        return None
    if backend not in (*INT8_BACKENDS, "native-int8"):
        print("--int8-zoo applies to the int8 backends only", file=sys.stderr)
        return "error"
    path = int8_zoo_path(args.config) if want == "auto" else want
    if not os.path.exists(path):
        print(f"--int8-zoo: artifact not found: {path}", file=sys.stderr)
        return "error"
    return path


def add_config_args(p, choices=CONFIGS) -> None:
    """``--config`` and ``--config-json``; ``choices=None`` takes any name
    (``get_config`` raises ``KeyError`` for one that is not a preset), as
    the JAX ``info`` and ``prune`` do."""
    p.add_argument("--config", default="256x320", choices=choices)
    p.add_argument("--config-json", default=None,
                   help="Config JSON file (Config.to_json of either package); overrides "
                        "--config")


def get_config(args):
    """The command's Config: ``--config-json FILE`` wins over the ``--config``
    preset name."""
    from yolofastest_torch.configs import Config
    from yolofastest_torch.configs import get_config as preset

    if getattr(args, "config_json", None):
        with open(args.config_json) as f:
            return Config.from_json(f.read())
    return preset(args.config)


class UnportedWeights(ValueError):
    """A weights format the port cannot read."""


def load_weights(path: str, arch: str = None):
    """The flax-layout variables tree from a zoo-layout ``.npz``, a reference
    ``.pth``, an ``.onnx`` (:func:`~yolofastest_torch.export.import_onnx`) or
    a port checkpoint directory (``epoch_<n>/``, the EMA model when it has
    one), as the JAX package's loader reads them.  Raises
    :class:`UnportedWeights` for any other directory (the JAX package's orbax
    checkpoints among them)."""
    from yolofastest_torch.models import load_variables
    from yolofastest_torch.models.torch_io import load_torch_checkpoint
    from yolofastest_torch.train.trainer import CHECKPOINT_FILE, checkpoint_variables

    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, CHECKPOINT_FILE)):
            raise UnportedWeights(
                f"{path} is not a checkpoint of the port (no {CHECKPOINT_FILE}); orbax "
                "checkpoints of the JAX package are not read: save its variables as .npz "
                "(models.save_variables) and pass that")
        variables = checkpoint_variables(path)
    elif path.endswith(".pth"):
        variables = load_torch_checkpoint(path)
    elif path.endswith(".onnx"):
        from yolofastest_torch.export import import_onnx

        variables = import_onnx(path)[0]
    else:
        variables = load_variables(path)
    if arch is not None:
        check_arch_weights(variables, arch, path)
    return variables


def make_index(root: str, class_names, logger=None, fmt: str = "auto"):
    """Dataset index for ``root``: VOC (``<root>/xml``) or COCO
    (``<root>/annotations.json``); ``fmt='auto'`` picks by layout."""
    from yolofastest_torch.data import COCOIndex, VOCIndex

    if fmt == "auto":
        fmt = "coco" if os.path.exists(os.path.join(root, "annotations.json")) else "voc"
    if fmt == "coco":
        return COCOIndex(root, class_names, logger)
    return VOCIndex(root, class_names, logger)
