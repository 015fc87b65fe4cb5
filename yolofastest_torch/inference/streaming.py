"""Streaming detection: overlapped upload, compute and fetch over a frame stream.

The port of ``yolofastest_tpu/inference/streaming.py``.  ``depth`` batches
are kept in flight, and a batch's result is fetched ``depth`` steps after its
dispatch:

  upload(batch k) | compute(batch k-1) | ... | fetch(batch k-depth)

On the card, frames are copied into pinned host memory and uploaded with
``non_blocking=True`` on a stream of their own, so the upload of batch k
runs under the compute of earlier batches; the detect path reads nothing back
(the NMS keep mask is a kernel), so dispatching a batch does not wait for the
card; each packed result is copied into pinned host memory, again
``non_blocking``, and a :class:`torch.cuda.Event` recorded after that copy is
what the fetch waits on.  On the CPU (``device="cpu"``) each batch runs to
its end as it is dispatched.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch

from yolofastest_torch.configs import Config
from yolofastest_torch.inference.detector import Detector
from yolofastest_torch.ops import normalize, unpack_detections


class StreamingDetector:
    """Iterator in, iterator out: batched detection with ``depth`` batches in
    flight.

    Args:
      config: framework config.
      variables: the numpy ``{'params', 'batch_stats'}`` tree.
      compute_dtype: torch.bfloat16 for deployment throughput.
      fold_bn: True runs the BN-folded graph, False the trainable model's
        eval forward (see :class:`Detector`).
      arch: ``'fastest'`` (two heads) or ``'lite'`` (single head).
      depth: batches in flight before the first result is fetched.  1 is
        synchronous (each batch is fetched right after its dispatch); 2
        fetches batch k-1 while k runs; more keep the card busy across
        longer host stalls.
      threaded: dispatch from a worker thread while the calling thread waits
        on the results, so that host work on either side overlaps.
      device: "cuda" (the default, which needs a card) or "cpu".

    ``__call__`` consumes an iterable of frame batches, uint8 gray ``(B, H,
    W)`` (normalised on the device) or float net inputs ``(B, H, W, 1)``, and
    yields detection dicts as host numpy arrays, in order.
    """

    def __init__(self, config: Config, variables: Dict[str, Any],
                 compute_dtype=torch.bfloat16, fold_bn: bool = True,
                 arch: str = "fastest", depth: int = 2, threaded: bool = False,
                 device=None):
        self._setup(Detector(config, variables, compute_dtype, fold_bn=fold_bn, arch=arch,
                             device=device), depth, threaded)

    @classmethod
    def over(cls, detector: Detector, depth: int = 2,
             threaded: bool = False) -> "StreamingDetector":
        """A streaming pipeline over an existing :class:`Detector` (its arch,
        dtype, TTA and device)."""
        self = cls.__new__(cls)
        self._setup(detector, depth, threaded)
        return self

    def _setup(self, detector: Detector, depth: int, threaded: bool) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.detector = detector
        self.config = detector.config
        self.depth = depth
        self.threaded = threaded
        on_card = detector.device.type == "cuda"
        self._upload_stream = torch.cuda.Stream(detector.device) if on_card else None

    # ------------------------------------------------------------ one batch
    def _net_input(self, frames: torch.Tensor) -> torch.Tensor:
        if frames.dtype == torch.uint8:
            return normalize(frames, self.detector.compute_dtype)[..., None]
        return frames

    def _dispatch(self, frames):
        """Queue one batch; returns what :meth:`_fetch` takes."""
        det = self.detector
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if self._upload_stream is None:
            return det.run_packed(self._net_input(host)), None
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        with torch.cuda.stream(self._upload_stream):
            dev = pinned.to(det.device, non_blocking=True)
        compute = torch.cuda.current_stream(det.device)
        compute.wait_stream(self._upload_stream)
        dev.record_stream(compute)
        packed = det.run_packed(self._net_input(dev))
        out = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        out.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(compute)
        return out, done

    @staticmethod
    def _fetch(item) -> Dict[str, np.ndarray]:
        out, done = item
        # Wait only for a result that is not there yet: the wait releases the
        # GIL, and while the worker of the threaded variant dispatches, taking
        # it back costs up to the interpreter's switch interval (5 ms).
        if done is not None and not done.query():
            done.synchronize()
        return unpack_detections(out.numpy())

    # ------------------------------------------------------------- the loop
    def __call__(self, frame_batches: Iterable[np.ndarray]) -> Iterator[Dict[str, np.ndarray]]:
        if self.threaded and self.depth > 1:
            yield from self._call_threaded(frame_batches)
            return
        inflight: deque = deque()
        for frames in frame_batches:
            inflight.append(self._dispatch(frames))
            if len(inflight) >= self.depth:
                # fetch the oldest batch while newer ones run
                yield self._fetch(inflight.popleft())
        while inflight:
            yield self._fetch(inflight.popleft())

    def _call_threaded(self, frame_batches):
        """A worker thread uploads and dispatches while this thread waits on
        the results; the bounded queue keeps at most ``depth`` batches
        queued (backpressure).  An error on the worker is raised here.  When
        this side stops early (an error, or the caller closing the
        iterator), the worker is told to stop and the queue is drained until
        it has, so that a worker blocked on a full queue cannot hang the
        join."""
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        err = []

        def uploader():
            try:
                for frames in frame_batches:
                    if stop.is_set():
                        break
                    q.put(self._dispatch(frames))
            except BaseException as e:  # re-raised on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=uploader, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield self._fetch(item)
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]
