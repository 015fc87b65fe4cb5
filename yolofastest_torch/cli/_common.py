"""Helpers shared by the port's commands: config, weights, datasets and the
Detector."""

from __future__ import annotations

import os

CONFIGS = ["256x320", "512x640", "lite-256x320", "lite-512x640"]


def add_model_args(p) -> None:
    """``--config``, ``--weights``, ``--arch``, ``--tta`` and ``--device``."""
    p.add_argument("--config", default="256x320", choices=CONFIGS)
    p.add_argument("--weights", required=True, help=".npz zoo file")
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


def build_detector(args, logger=None):
    """(config, Detector) from the model arguments, or None after a printed
    message when --weights is not a zoo file."""
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.models import load_variables

    if not args.weights.endswith(".npz"):
        print(f"--weights takes a .npz zoo file; {args.weights!r} is another "
              "format, whose import is not ported yet (ROADMAP: 'Export and import')")
        return None
    cfg = get_config(args.config)
    check_arch_config(cfg, args.arch)
    variables = load_variables(args.weights)
    check_arch_weights(variables, args.arch, args.weights)
    detector = Detector(cfg, variables=variables, logger=logger, device=args.device,
                        arch=args.arch, tta=args.tta)
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


class UnportedWeights(ValueError):
    """A weights format the port cannot read yet."""


def load_weights(path: str, arch: str = None):
    """The flax-layout variables tree from a zoo-layout ``.npz`` or a port
    checkpoint directory (``epoch_<n>/``, the EMA model when it has one).
    Raises :class:`UnportedWeights` for ``.pth``, ``.onnx`` and the JAX
    package's orbax checkpoint directories."""
    from yolofastest_torch.models import load_variables
    from yolofastest_torch.train.trainer import CHECKPOINT_FILE, checkpoint_variables

    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, CHECKPOINT_FILE)):
            raise UnportedWeights(
                f"{path} is not a checkpoint of the port (no {CHECKPOINT_FILE}); orbax "
                "checkpoints of the JAX package are not read (ROADMAP: 'Export and "
                "import'): save its variables as .npz (models.save_variables) and pass that")
        variables = checkpoint_variables(path)
    elif path.endswith((".pth", ".onnx")):
        raise UnportedWeights(f"{path}: .pth and .onnx weights are not ported yet "
                              "(ROADMAP: 'Export and import'); pass a .npz")
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
