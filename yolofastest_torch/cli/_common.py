"""Helpers shared by the port's commands: config, weights and the Detector."""

from __future__ import annotations

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
