"""`serve` (HTTP server with dynamic batching) and `video` commands.

The fp subset of ``python -m yolofastest_tpu serve|video`` plus
``--device``; ``--backend`` int8 and native exit 2 (ROADMAP:
'Quantisation', 'Native engine').
"""

from __future__ import annotations

import json
import os

from yolofastest_torch.cli._common import add_model_args, build_detector


def add_serve_parsers(sub) -> None:
    s = sub.add_parser("serve", help="HTTP detection server with dynamic batching")
    add_model_args(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000,
                   help="TCP port (0 = pick a free one, printed at start)")
    s.add_argument("--max-batch", type=int, default=8,
                   help="device batch capacity; concurrent requests coalesce "
                        "up to this many per dispatch")
    s.add_argument("--window-ms", type=float, default=5.0,
                   help="how long to wait for co-arriving requests after the "
                        "first (idle-latency floor)")
    s.set_defaults(fn=cmd_serve)

    v = sub.add_parser("video", help="detect over a video file -> annotated video")
    add_model_args(v)
    v.add_argument("--video", required=True,
                   help="input video path, stream URL, or camera index (e.g. 0)")
    v.add_argument("--out", required=True, help="output directory")
    v.add_argument("--batch", type=int, default=8, help="frames per device dispatch")
    v.add_argument("--depth", type=int, default=2,
                   help="batches in flight before the first fetch (overlaps "
                        "upload, compute and fetch)")
    v.add_argument("--track", action="store_true",
                   help="annotate stable track IDs (SORT-style IoU tracker) "
                        "instead of independent detections")
    v.add_argument("--track-iou", type=float, default=0.3,
                   help="association IoU gate for --track")
    v.add_argument("--track-max-age", type=int, default=10,
                   help="frames a track coasts unmatched before dropping")
    v.set_defaults(fn=cmd_video)


def build_server(args):
    """The DetectionServer of the `serve` arguments (not started), or None
    after a printed message."""
    built = build_detector(args)
    if built is None:
        return None
    cfg, detector = built

    from yolofastest_torch.inference import DetectionServer, DynamicBatcher, make_batch_fn

    batcher = DynamicBatcher(make_batch_fn(detector),
                             cfg.io.input_hw, max_batch=args.max_batch,
                             window_ms=args.window_ms)
    return DetectionServer(batcher, cfg, host=args.host, port=args.port,
                           arch=args.arch, backend="fp")


def cmd_serve(args) -> int:
    """HTTP detection server over a dynamic batcher (``inference/server.py``)."""
    server = build_server(args)
    if server is None:
        return 2
    print(f"serving on http://{args.host}:{server.port} "
          "(POST /detect, GET /healthz, GET /stats, GET /metrics)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


def cmd_video(args) -> int:
    """Video file -> annotated video (``inference/video.py``); prints the
    stats dict as one JSON line."""
    from yolofastest_torch.inference import IoUTracker, detect_video
    from yolofastest_torch.utils.logging import config_logger

    os.makedirs(args.out, exist_ok=True)
    logger = config_logger(args.out, "video_info.log")
    built = build_detector(args, logger)
    if built is None:
        return 2
    cfg, detector = built
    tracker = None
    if args.track:
        tracker = IoUTracker(iou_thre=args.track_iou, max_age=args.track_max_age)
    stem, ext = os.path.splitext(os.path.basename(args.video))
    if ext.lower() not in (".mp4", ".m4v", ".avi"):
        ext = ".avi"
    out_path = os.path.join(args.out, "result_" + stem + ext)
    stats = detect_video(detector, cfg, args.video, out_path, batch_size=args.batch,
                         depth=args.depth, tracker=tracker, logger=logger)
    print(json.dumps(stats))
    return 0
