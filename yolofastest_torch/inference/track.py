"""Multi-object tracking over the video pipeline (host-side, numpy only).

The port's own copy of ``yolofastest_tpu/inference/track.py``:
:class:`IoUTracker` is a SORT-style tracker (greedy IoU association plus
constant-velocity prediction) that gives detections stable integer IDs
across frames.  It lives on the host: association is a tiny (tracks x
detections) problem with data-dependent control flow, run between device
dispatches and overlapped with them by the ``depth``-deep video pipeline
(``inference/video.py``).

Algorithm (class-aware SORT-lite):

1. predict: each track's box is extrapolated by its EMA velocity;
2. associate: greedy max-IoU matching between predicted boxes and the
   frame's detections, same-class pairs only, gated at ``iou_thre``;
3. update: matched tracks EMA-blend box + velocity and reset their miss
   counter; unmatched detections open tentative tracks; tracks unseen for
   ``max_age`` consecutive frames are dropped.

A track is *emitted* once seen ``min_hits`` times (always, during the
first ``min_hits`` frames of a stream, so short clips aren't blind).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["IoUTracker", "TrackedBox"]


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between ``a`` (N,4) and ``b`` (M,4) xyxy boxes -> (N,M).

    Same zero-pixel-offset convention as the postprocess NMS
    (``ops/boxes.py::iou_pairwise(pixel_offset=0)``), in numpy so the
    per-frame tracker never touches the device.
    """
    a = a[:, None, :]
    b = b[None, :, :]
    iw = np.clip(np.minimum(a[..., 2], b[..., 2])
                 - np.maximum(a[..., 0], b[..., 0]), 0.0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3])
                 - np.maximum(a[..., 1], b[..., 1]), 0.0, None)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


class TrackedBox:
    """One emitted track state for the current frame."""

    __slots__ = ("tid", "box", "cls", "score", "hits")

    def __init__(self, tid: int, box: np.ndarray, cls: int, score: float,
                 hits: int):
        self.tid = tid
        self.box = box          # (4,) float32 xyxy, net-input coordinates
        self.cls = cls
        self.score = score
        self.hits = hits

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TrackedBox(tid={self.tid}, cls={self.cls}, "
                f"score={self.score:.2f}, box={np.round(self.box, 1)})")


class _Track:
    __slots__ = ("tid", "box", "vel", "cls", "score", "hits", "misses")

    def __init__(self, tid: int, box: np.ndarray, cls: int, score: float):
        self.tid = tid
        self.box = box.astype(np.float32).copy()
        self.vel = np.zeros(4, np.float32)
        self.cls = cls
        self.score = score
        self.hits = 1
        self.misses = 0


class IoUTracker:
    """Class-aware greedy-IoU tracker with constant-velocity prediction.

    Args:
      iou_thre: association gate — a (track, detection) pair below this
        predicted-box IoU is never matched.
      max_age: frames a track survives unmatched (coasting on its
        velocity) before it is dropped; bridges detector flicker and short
        occlusions.
      min_hits: matches required before a track is emitted (suppresses
        one-frame false positives; waived for the first ``min_hits``
        frames of the stream).
      vel_alpha: EMA weight of the newest displacement in the velocity
        estimate (1 = last displacement only, 0 = frozen).
    """

    def __init__(self, iou_thre: float = 0.3, max_age: int = 10,
                 min_hits: int = 2, vel_alpha: float = 0.6):
        if not 0.0 < iou_thre < 1.0:
            raise ValueError(f"iou_thre must be in (0,1), got {iou_thre}")
        if max_age < 1 or min_hits < 1:
            raise ValueError("max_age and min_hits must be >= 1")
        self.iou_thre = float(iou_thre)
        self.max_age = int(max_age)
        self.min_hits = int(min_hits)
        self.vel_alpha = float(vel_alpha)
        self._tracks: List[_Track] = []
        self._next_id = 1
        self.frame_count = 0

    @property
    def total_tracks(self) -> int:
        """Distinct track IDs ever created (a stability diagnostic: for a
        smooth clip this stays near the per-frame object count)."""
        return self._next_id - 1

    @property
    def active_tracks(self) -> int:
        return len(self._tracks)

    def update(self, boxes: np.ndarray, cls_idx: np.ndarray,
               scores: Optional[np.ndarray] = None) -> List[TrackedBox]:
        """Advance one frame; returns the emitted tracks matched this frame.

        Args:
          boxes: (N, 4) xyxy detections (any consistent coordinate frame).
          cls_idx: (N,) int class index per detection.
          scores: (N,) optional confidence per detection (carried on the
            track; higher-score detections get association priority via
            greedy order only through IoU — SORT semantics).
        """
        self.frame_count += 1
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        cls_idx = np.asarray(cls_idx, np.int32).reshape(-1)
        if scores is None:
            scores = np.ones(len(boxes), np.float32)
        scores = np.asarray(scores, np.float32).reshape(-1)
        if not (len(boxes) == len(cls_idx) == len(scores)):
            raise ValueError("boxes / cls_idx / scores length mismatch")

        # 1. predict
        predicted = (np.stack([t.box + t.vel for t in self._tracks])
                     if self._tracks else np.zeros((0, 4), np.float32))

        # 2. associate (greedy max-IoU, same-class pairs only)
        matched_det = np.full(len(boxes), -1, np.int64)
        if len(predicted) and len(boxes):
            iou = _iou_matrix(predicted, boxes)
            track_cls = np.asarray([t.cls for t in self._tracks])
            iou[track_cls[:, None] != cls_idx[None, :]] = -1.0
            while True:
                ti, di = np.unravel_index(np.argmax(iou), iou.shape)
                if iou[ti, di] < self.iou_thre:
                    break
                matched_det[di] = ti
                iou[ti, :] = -1.0
                iou[:, di] = -1.0

        # 3. update matched / age unmatched / open new
        emitted: List[TrackedBox] = []
        hit = np.zeros(len(self._tracks), bool)
        for di, ti in enumerate(matched_det):
            if ti < 0:
                continue
            t = self._tracks[ti]
            disp = boxes[di] - t.box
            t.vel = (1.0 - self.vel_alpha) * t.vel + self.vel_alpha * disp
            t.box = boxes[di].copy()
            t.score = float(scores[di])
            t.hits += 1
            t.misses = 0
            hit[ti] = True
            if t.hits >= self.min_hits or self.frame_count <= self.min_hits:
                emitted.append(TrackedBox(t.tid, t.box.copy(), t.cls,
                                          t.score, t.hits))
        for ti, t in enumerate(self._tracks):
            if not hit[ti]:
                t.misses += 1
                t.box = t.box + t.vel  # coast while unseen
        self._tracks = [t for t in self._tracks if t.misses < self.max_age]
        for di in range(len(boxes)):
            if matched_det[di] < 0:
                t = _Track(self._next_id, boxes[di], int(cls_idx[di]),
                           float(scores[di]))
                self._next_id += 1
                self._tracks.append(t)
                if self.min_hits <= 1 or self.frame_count <= self.min_hits:
                    emitted.append(TrackedBox(t.tid, t.box.copy(), t.cls,
                                              t.score, t.hits))
        emitted.sort(key=lambda e: e.tid)
        return emitted
