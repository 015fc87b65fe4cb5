"""Video detection: file in, annotated video out, batches overlapped.

The port of ``yolofastest_tpu/inference/video.py``.  A video file (or a
stream URL, or a camera index) runs through the port's :class:`Detector` by
way of :class:`~yolofastest_torch.inference.streaming.StreamingDetector`:
``depth`` batches stay in flight, so upload, compute and fetch overlap, and
frames are drawn and written in stream order.  The output is an annotated
video at the source fps; the summary records the realtime factor (effective
fps / source fps).  The C++ engine
(:class:`~yolofastest_torch.native.NativeEngine`) runs frame by frame on
the host CPU, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

from yolofastest_torch.configs import Config
from yolofastest_torch.utils.visualize import CLASS_COLORS, plot_one_box

# codec by container: mp4v for .mp4, MJPG for everything else (both verified
# present in the opencv build; MJPG is intra-only so single-frame artifacts
# stay inspectable)
_FOURCC = {".mp4": "mp4v", ".m4v": "mp4v"}


def iter_frame_batches(cap, io, batch_size: int
                       ) -> Iterator[Tuple[np.ndarray, List[np.ndarray], int]]:
    """Yield ``(net_batch (B,H,W,C) float32, originals, n_valid)`` from an
    opened ``cv2.VideoCapture``; the tail batch is zero-padded to the fixed
    ``batch_size`` (one batch shape)."""
    from yolofastest_torch.inference.detector import image_to_net_input

    eof = False
    while not eof:
        originals: List[np.ndarray] = []
        nets: List[np.ndarray] = []
        while len(originals) < batch_size:
            ok, frame = cap.read()
            if not ok:
                eof = True
                break
            originals.append(frame)
            nets.append(image_to_net_input(frame, io))
        if not originals:
            return
        n_valid = len(originals)
        while len(nets) < batch_size:
            nets.append(np.zeros_like(nets[0]))
        yield np.stack(nets), originals, n_valid


# per-ID colors: distinct-ish BGR from a low-discrepancy walk over hue-like
# channel mixes (deterministic, no palette table to run out of)
def _track_color(tid: int) -> list:
    return [32 + (tid * 67) % 224, 32 + (tid * 97) % 224,
            32 + (tid * 131) % 224]


def _draw_tracked(frame: np.ndarray, tracked, io) -> int:
    """Annotate one original frame with stable-ID track boxes in place."""
    sh = frame.shape[0] / io.input_hw[0]
    sw = frame.shape[1] / io.input_hw[1]
    for tb in tracked:
        x1, y1, x2, y2 = tb.box
        plot_one_box([round(x1 * sw), round(y1 * sh),
                      round(x2 * sw), round(y2 * sh)], frame,
                     color=_track_color(tb.tid),
                     label="#%d %s %.2f" % (tb.tid, io.class_names[tb.cls],
                                            tb.score),
                     line_thickness=3)
    return len(tracked)


def _draw(frame: np.ndarray, det: Dict[str, np.ndarray], b: int, io) -> int:
    """Annotate one original frame in place; returns the detection count."""
    sh = frame.shape[0] / io.input_hw[0]
    sw = frame.shape[1] / io.input_hw[1]
    n = int(det["count"][b])
    for i in range(n):
        x1, y1, x2, y2 = det["boxes"][b, i]
        cls = int(det["cls_idx"][b, i])
        score = float(det["conf"][b, i]) * float(det["cls_score"][b, i])
        plot_one_box([round(x1 * sw), round(y1 * sh),
                      round(x2 * sw), round(y2 * sh)], frame,
                     color=CLASS_COLORS[cls % len(CLASS_COLORS)],
                     label="%s %.2f" % (io.class_names[cls], score),
                     line_thickness=3)
    return n


def _rows_to_det(rows) -> Dict[str, np.ndarray]:
    """The C++ engine's rows of one frame as a one-frame detection dict."""
    return {"boxes": np.asarray([r[0:4] for r in rows], np.float32).reshape(1, -1, 4),
            "conf": np.asarray([[r[4] for r in rows]], np.float32),
            "cls_score": np.asarray([[r[5] for r in rows]], np.float32),
            "cls_idx": np.asarray([[int(r[6]) for r in rows]], np.int32),
            "count": np.asarray([len(rows)], np.int32)}


def detect_video(engine, config: Config, src: str, out_path: str,
                 batch_size: int = 8, depth: int = 2, tracker=None,
                 logger=None) -> Dict[str, Any]:
    """Run a deployment engine over a video; write the annotated video.

    Args:
      engine: a :class:`Detector` (anything with ``run_packed`` and
        ``warmup``), whose batches overlap through a ``depth``-deep
        :class:`StreamingDetector`, or a
        :class:`~yolofastest_torch.native.NativeEngine` (per frame, up to
        ``config.io.max_det`` detections).
      src: input video path, stream URL (RTSP/HTTP), or an integer camera
        index as int or digit-string ("0" = first camera): anything
        cv2.VideoCapture opens.
      out_path: annotated output video path (codec from the extension).
      batch_size: frames per device dispatch (frames read at a time for the
        C++ engine).
      depth: batches in flight before the first fetch (1 = synchronous;
        the Detector only).
      tracker: optional :class:`~yolofastest_torch.inference.track.IoUTracker`;
        when given, frames are annotated with stable track IDs instead of
        raw detections (results come back in stream order, so the tracker
        sees a sequential stream at any depth).

    Returns a stats dict: frames, detections, avg_ms (per frame, steady-state
    wall clock, after the Detector's warm-up batch), fps (effective), src_fps,
    realtime_x (fps / src_fps), out, and with a tracker, tracks (distinct IDs
    ever created).
    """
    import cv2

    from yolofastest_torch.inference.streaming import StreamingDetector

    io = config.io
    is_detector = hasattr(engine, "run_packed")
    if not is_detector and not hasattr(engine, "detect"):
        raise TypeError(f"cannot drive {type(engine).__name__} over video")
    if isinstance(src, str) and src.isdigit():
        src = int(src)  # camera index, e.g. CLI --video 0
    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        cap.release()
        raise FileNotFoundError(f"cannot open video source {src!r}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fourcc = _FOURCC.get(os.path.splitext(out_path)[1].lower(), "MJPG")
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*fourcc),
                             src_fps, (w, h))
    if not writer.isOpened():
        cap.release()
        raise RuntimeError(f"cannot open video writer for {out_path!r} "
                           f"(codec {fourcc})")

    frames_done = 0
    det_total = 0

    def emit(frame: np.ndarray, det: Dict[str, np.ndarray], b: int) -> int:
        """Annotate + write one frame; raw detections or tracked IDs."""
        if tracker is None:
            n = _draw(frame, det, b, io)
        else:
            k = int(det["count"][b])
            score = det["conf"][b, :k] * det["cls_score"][b, :k]
            tracked = tracker.update(det["boxes"][b, :k],
                                     det["cls_idx"][b, :k], score)
            n = _draw_tracked(frame, tracked, io)
        writer.write(frame)
        return n

    pending: deque = deque()  # (originals, n_valid) of each dispatched batch

    def net_batches():
        for nets, originals, n_valid in iter_frame_batches(cap, io, batch_size):
            pending.append((originals, n_valid))
            yield nets

    def log_batch():
        if logger is not None:
            logger.info("video batch done -> frames:%d" % frames_done)

    try:
        if is_detector:
            engine.warmup(batch_size)  # builds the kernels outside the timed loop
            t0 = time.time()
            for det in StreamingDetector.over(engine, depth)(net_batches()):
                originals, n_valid = pending.popleft()
                for b, frame in enumerate(originals[:n_valid]):
                    det_total += emit(frame, det, b)
                frames_done += n_valid
                log_batch()
        else:
            t0 = None
            for nets, originals, n_valid in iter_frame_batches(cap, io, batch_size):
                if t0 is None:
                    t0 = time.time()
                for b, frame in enumerate(originals[:n_valid]):
                    img = nets[b, ..., 0] if nets.shape[-1] == 1 else nets[b]
                    rows = engine.detect(img, max_det=io.max_det)
                    det_total += emit(frame, _rows_to_det(rows), 0)
                frames_done += n_valid
                log_batch()
        elapsed = (time.time() - t0) if t0 is not None else 0.0
    finally:
        cap.release()
        writer.release()

    avg_ms = elapsed * 1e3 / frames_done if frames_done else 0.0
    fps = frames_done / elapsed if elapsed > 0 else 0.0
    stats = {"frames": frames_done, "detections": det_total,
             "avg_ms": avg_ms, "fps": fps, "src_fps": float(src_fps),
             "realtime_x": fps / src_fps if src_fps else 0.0,
             "out": out_path}
    if tracker is not None:
        stats["tracks"] = tracker.total_tracks
    if logger is not None:
        logger.info(
            "video done -> frames:%d detections:%d avg_time:%.2fms "
            "fps:%.1f (source %.1f fps, %.1fx realtime)" %
            (stats["frames"], det_total, avg_ms, fps, src_fps,
             stats["realtime_x"]))
    return stats
