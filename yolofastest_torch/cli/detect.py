"""`detect` command: batch image detection through the port's Detector.

Flags are a subset of ``python -m yolofastest_tpu detect`` plus ``--device``.
Writes ``result_<image>`` files and ``detect_info.log``
(reference log format) into ``--out``.
"""

from __future__ import annotations

import os


def add_detect_parser(sub) -> None:
    d = sub.add_parser("detect", help="batch-detect a directory of images")
    d.add_argument("--config", default="256x320", choices=["256x320", "512x640"])
    d.add_argument("--weights", required=True, help=".npz zoo file")
    d.add_argument("--data", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--batch", type=int, default=1,
                   help="device batch size (>1 = throughput mode, amortised "
                        "per-image timing)")
    d.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    d.set_defaults(fn=cmd_detect)


def cmd_detect(args) -> int:
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.models import load_variables
    from yolofastest_torch.utils.logging import config_logger

    if not args.weights.endswith(".npz"):
        print(f"--weights takes a .npz zoo file; {args.weights!r} is another "
              "format, whose import is not ported yet (ROADMAP: 'Export and import')")
        return 2
    cfg = get_config(args.config)
    logger = config_logger(args.out, "detect_info.log")
    os.makedirs(args.out, exist_ok=True)
    detector = Detector(cfg, variables=load_variables(args.weights), logger=logger,
                        device=args.device)
    detector.batch_detect(args.data, args.out, batch_size=args.batch)
    return 0
