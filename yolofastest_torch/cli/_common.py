"""Helpers shared by the port's commands: config, weights, datasets and the
Detector."""

from __future__ import annotations

import os
import sys

CONFIGS = ["256x320", "512x640", "lite-256x320", "lite-512x640"]
# The backends of the JAX commands that the port has not ported, with the
# ROADMAP item that ports each.
UNPORTED_BACKENDS = {"int8": "Quantisation", "int8-fused": "Quantisation",
                     "native": "Native engine", "native-int8": "Native engine"}


def add_model_args(p) -> None:
    """``--config``, ``--config-json``, ``--weights``, ``--arch``,
    ``--backend``, ``--tta`` and ``--device``."""
    add_config_args(p)
    p.add_argument("--weights", required=True,
                   help=".npz zoo file, reference .pth, .onnx or a port checkpoint directory")
    p.add_argument("--backend", default="fp", choices=["fp", "jax", *UNPORTED_BACKENDS],
                   help="fp (or its alias jax); the int8 and native backends are not "
                        "ported yet")
    p.add_argument("--arch", default="fastest", choices=["fastest", "lite"],
                   help="model architecture (lite = single-head variant; "
                        "use with a lite-* config)")
    p.add_argument("--tta", action="store_true",
                   help="horizontal-flip test-time augmentation: the mirrored "
                        "batch rides the same forward and both candidate sets "
                        "merge into one NMS")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


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


def build_detector(args, logger=None, fold_bn: bool = True):
    """(config, Detector) from the model arguments, or None after a printed
    message when --backend is not ported or --weights is a format the port
    does not read."""
    from yolofastest_torch.inference import Detector

    if unported_backend(args.backend):
        return None
    cfg = get_config(args)
    check_arch_config(cfg, args.arch)
    try:
        variables = load_weights(args.weights, args.arch)
    except UnportedWeights as e:
        print(e, file=sys.stderr)
        return None
    detector = Detector(cfg, variables=variables, logger=logger, fold_bn=fold_bn,
                        device=args.device, arch=args.arch, tta=args.tta)
    return cfg, detector


def add_config_args(p) -> None:
    """``--config`` and ``--config-json``."""
    p.add_argument("--config", default="256x320", choices=CONFIGS)
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


def unported_backend(backend: str) -> bool:
    """True, after a printed message naming its ROADMAP item, for a backend
    the port has not ported."""
    if backend not in UNPORTED_BACKENDS:
        return False
    print(f"--backend {backend} is not ported yet (ROADMAP: "
          f"'{UNPORTED_BACKENDS[backend]}')", file=sys.stderr)
    return True


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
