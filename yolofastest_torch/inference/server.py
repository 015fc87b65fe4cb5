"""Serving: dynamic batching and a zero-dependency HTTP endpoint.

The port of ``yolofastest_tpu/inference/server.py``.  Serving traffic
arrives as independent single-image requests, and the card earns its keep on
batches: a **dynamic batcher** queues concurrent requests, a worker
coalesces whatever arrived within a small window (bounded by ``max_batch``)
into ONE device batch, and every requester gets its own rows back.  Under
load the card sees full batches; an idle server adds at most ``window_ms``.

Two layers, separately usable:

* :class:`DynamicBatcher`: the queueing and coalescing core over any
  ``batch_fn``; :func:`make_batch_fn` adapts the port's :class:`Detector`
  (the packed single-transfer path).
* :class:`DetectionServer`: an ``http.server`` front end: ``POST /detect``
  with image bytes -> JSON detections, ``GET /healthz``, ``GET /stats``,
  ``GET /metrics``.  CLI: ``python -m yolofastest_torch serve``.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from yolofastest_torch.configs import Config

# batch_fn contract: ((B, H, W, 1) float32 net inputs, n_valid) -> n_valid
# per-image lists of [x1, y1, x2, y2, conf, cls_score, cls_idx] rows
# (net-input coords).  B is always the batcher's max_batch (rows >= n_valid
# are zero padding): a batched backend runs the full padded batch (ONE
# shape) and slices; a per-image backend processes only the first n_valid
# rows and never pays for the padding.
BatchFn = Callable[[np.ndarray, int], List[List[List[float]]]]

# POST /detect body cap: encoded camera frames are tens of KB; 32 MB admits
# any plausible high-res photo while refusing attacker-sized uploads before
# the read/allocation happens.
MAX_BODY_BYTES = 32 * 1024 * 1024


def make_batch_fn(engine: Any) -> BatchFn:
    """Adapt the port's :class:`~yolofastest_torch.inference.Detector` (or
    anything with ``run_packed``) to the :class:`DynamicBatcher` contract:
    one packed fetch per batch.  The JAX package's per-image C++ engine is
    not ported yet (ROADMAP: 'Native engine')."""
    if hasattr(engine, "run_packed"):
        from yolofastest_torch.inference.detector import detections_to_lists
        from yolofastest_torch.ops import unpack_detections

        def batch_fn(batch: np.ndarray, n: int) -> List[List[List[float]]]:
            return detections_to_lists(
                unpack_detections(engine.run_packed(batch)))[:n]

        return batch_fn
    if hasattr(engine, "detect"):
        raise TypeError("the native C++ engine is not ported yet (ROADMAP: "
                        "'Native engine'); serve through the Detector")
    raise TypeError(f"cannot adapt {type(engine).__name__} to a batch_fn")


@dataclass
class _Request:
    net_in: np.ndarray  # (H, W, 1) float32
    done: threading.Event = field(default_factory=threading.Event)
    rows: Optional[List[List[float]]] = None
    error: Optional[BaseException] = None
    t0: float = field(default_factory=time.perf_counter)


class DynamicBatcher:
    """Coalesces concurrent single-image requests into device batches.

    Args:
      batch_fn: see :data:`BatchFn` (build with :func:`make_batch_fn`).
      input_hw: net input (H, W) — every submitted image must match.
      max_batch: device batch capacity.  Partial batches are zero-padded to
        this size, so the card sees ONE batch shape (run once at start).
      window_ms: how long the worker waits for co-arriving requests after
        the first one.  Latency floor when idle; under load the batch fills
        to ``max_batch`` before the window expires.
    """

    def __init__(self, batch_fn: BatchFn, input_hw, max_batch: int = 8,
                 window_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._fn = batch_fn
        self._hw = tuple(input_hw)
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self._q: "queue.SimpleQueue[Optional[_Request]]" = queue.SimpleQueue()
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0,
                      "errors": 0}
        # observability: per-request queue+execute latency (bounded ring,
        # quantiles over the most recent window) and batch-occupancy counts
        # (how well dynamic batching is coalescing under the current load)
        self._lat_ms: "collections.deque[float]" = collections.deque(
            maxlen=2048)
        self._lat_sum_ms = 0.0
        self._lat_count = 0
        self._fill_counts = [0] * (max_batch + 1)  # index = batch occupancy
        self._stats_mu = threading.Lock()
        # Run the one batch shape before accepting traffic, so the first
        # request doesn't pay the kernels' build.
        self._fn(np.zeros((max_batch, *self._hw, 1), np.float32), 1)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="yf-batcher")
        self._worker.start()

    # ------------------------------------------------------------------ API
    def submit(self, net_in: np.ndarray,
               timeout: Optional[float] = 30.0) -> List[List[float]]:
        """Detect one (H, W, 1) float32 net input; blocks until its batch
        ran.  Thread-safe — this is the method HTTP handler threads call."""
        net_in = np.asarray(net_in, np.float32)
        if net_in.shape != (*self._hw, 1):
            raise ValueError(
                f"expected net input {(*self._hw, 1)}, got {net_in.shape}")
        if self._closed:
            raise RuntimeError("batcher is closed")
        req = _Request(net_in)
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("detection batch did not complete in time")
        if req.error is not None:
            raise RuntimeError("batch execution failed") from req.error
        return req.rows  # type: ignore[return-value]

    def close(self) -> None:
        self._closed = True
        self._q.put(None)
        self._worker.join(timeout=5)
        # Fail-fast drain: a submit() that won the race against the closed
        # flag (enqueued after the worker consumed the sentinel) must not
        # block for its full timeout — fail it now.
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.error = RuntimeError("batcher closed during submit")
                req.done.set()

    # --------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            items = [first]
            deadline = time.monotonic() + self.window_s
            while len(items) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(items)
                    return
                items.append(nxt)
            self._flush(items)

    def _flush(self, items: List[_Request]) -> None:
        batch = np.zeros((self.max_batch, *self._hw, 1), np.float32)
        for i, req in enumerate(items):
            batch[i] = req.net_in
        failed = False
        try:
            rows = self._fn(batch, len(items))
            for i, req in enumerate(items):
                req.rows = rows[i]
        except BaseException as e:  # surface to every waiter, keep serving
            failed = True
            for req in items:
                req.error = e
        # Counters BEFORE waking the waiters: a submit() that returned (and
        # anything it triggers, e.g. a follow-up GET /stats) must already see
        # its own request counted.
        now = time.perf_counter()
        with self._stats_mu:
            self.stats["requests"] += len(items)
            self.stats["batches"] += 1
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                               len(items))
            if failed:
                self.stats["errors"] += 1
            self._fill_counts[len(items)] += 1
            for req in items:
                ms = (now - req.t0) * 1e3
                self._lat_ms.append(ms)
                self._lat_sum_ms += ms
                self._lat_count += 1
        for req in items:
            req.done.set()

    # -------------------------------------------------------- observability
    def snapshot(self) -> Dict[str, Any]:
        """Counters + latency quantiles (over the recent window) + batch
        occupancy histogram, one consistent view."""
        with self._stats_mu:
            out: Dict[str, Any] = dict(self.stats)
            lat = list(self._lat_ms)
            out["latency_sum_ms"] = self._lat_sum_ms
            out["latency_count"] = self._lat_count
            out["batch_fill"] = {str(i): c
                                 for i, c in enumerate(self._fill_counts)
                                 if i > 0 and c > 0}
        if lat:
            q = np.quantile(np.asarray(lat), [0.5, 0.95, 0.99])
            out["latency_ms"] = {"p50": round(float(q[0]), 3),
                                 "p95": round(float(q[1]), 3),
                                 "p99": round(float(q[2]), 3)}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition of :meth:`snapshot` — counters, a
        request-latency summary, and a batch-occupancy histogram (cumulative
        ``le`` buckets, as scrapers expect)."""
        s = self.snapshot()
        lines = [
            "# TYPE yf_requests_total counter",
            f"yf_requests_total {s['requests']}",
            "# TYPE yf_batches_total counter",
            f"yf_batches_total {s['batches']}",
            "# TYPE yf_errors_total counter",
            f"yf_errors_total {s['errors']}",
            "# TYPE yf_max_batch_seen gauge",
            f"yf_max_batch_seen {s['max_batch_seen']}",
            "# TYPE yf_request_latency_ms summary",
        ]
        for k, v in s.get("latency_ms", {}).items():
            quantile = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}[k]
            lines.append(
                f'yf_request_latency_ms{{quantile="{quantile}"}} {v}')
        lines.append(f"yf_request_latency_ms_sum {s['latency_sum_ms']:.3f}")
        lines.append(f"yf_request_latency_ms_count {s['latency_count']}")
        lines.append("# TYPE yf_batch_size histogram")
        cum = 0
        with self._stats_mu:
            fills = list(self._fill_counts)
        for i in range(1, len(fills)):
            cum += fills[i]
            lines.append(f'yf_batch_size_bucket{{le="{i}"}} {cum}')
        lines.append(f'yf_batch_size_bucket{{le="+Inf"}} {cum}')
        lines.append(
            f"yf_batch_size_sum {sum(i * c for i, c in enumerate(fills))}")
        lines.append(f"yf_batch_size_count {cum}")
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------------- HTTP
class DetectionServer:
    """HTTP serving front end over a :class:`DynamicBatcher`.

    Endpoints:
      * ``POST /detect`` — body = encoded image bytes (anything
        ``cv2.imdecode`` reads: JPEG/PNG/BMP...).  Reply::

            {"count": N,
             "detections": [{"box": [x1, y1, x2, y2],        # original px
                             "box_net": [x1, y1, x2, y2],    # net-input px
                             "conf": c, "cls_score": s,
                             "cls": k, "name": "carrier"}, ...],
             "ms": server_side_milliseconds}

      * ``GET /healthz`` — ``{"status": "ok", "arch": ..., "input_hw": ...}``
      * ``GET /stats`` — batcher counters (requests, batches,
        max_batch_seen, errors) + latency p50/p95/p99 over the recent
        window + batch-occupancy histogram.
      * ``GET /metrics`` — the same in Prometheus text exposition format
        (counter/summary/histogram families), scrapable as-is.
    """

    def __init__(self, batcher: DynamicBatcher, config: Config,
                 host: str = "127.0.0.1", port: int = 8000,
                 arch: str = "fastest", backend: str = "fp"):
        self.batcher = batcher
        self.config = config
        self.arch = arch
        self.backend = backend
        io = config.io
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # quiet per-request stderr lines; errors still raise JSON replies
            def log_message(self, *a):
                pass

            def _json(self, code: int, payload: Dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok", "arch": outer.arch,
                                     "backend": outer.backend,
                                     "input_hw": list(io.input_hw),
                                     "class_names": list(io.class_names)})
                elif self.path == "/stats":
                    # snapshot() copies under the lock; socket writes happen
                    # OUTSIDE it, so a stalled client can't block the batcher
                    self._json(200, outer.batcher.snapshot())
                elif self.path == "/metrics":
                    body = outer.batcher.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/detect":
                    self._json(404, {"error": "unknown path"})
                    return
                import cv2

                from yolofastest_torch.inference.detector import image_to_net_input

                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self._json(400, {"error": "bad Content-Length"})
                    return
                if n <= 0:
                    self._json(400, {"error": "empty body"})
                    return
                if n > MAX_BODY_BYTES:  # don't read attacker-sized bodies
                    self._json(413, {"error": "body too large"})
                    return
                raw = self.rfile.read(n)
                ori = cv2.imdecode(np.frombuffer(raw, np.uint8),
                                   cv2.IMREAD_COLOR)
                if ori is None:
                    self._json(400, {"error": "cannot decode image"})
                    return
                t0 = time.perf_counter()
                net_in = image_to_net_input(ori, io)
                try:
                    rows = outer.batcher.submit(net_in)
                except TimeoutError:
                    self._json(503, {"error": "detection timed out"})
                    return
                except RuntimeError as e:
                    self._json(500, {"error": str(e)})
                    return
                sh = ori.shape[0] / io.input_hw[0]
                sw = ori.shape[1] / io.input_hw[1]
                dets = []
                for x1, y1, x2, y2, conf, cls_score, cls in rows:
                    k = int(cls)
                    dets.append({
                        "box": [x1 * sw, y1 * sh, x2 * sw, y2 * sh],
                        "box_net": [x1, y1, x2, y2],
                        "conf": conf, "cls_score": cls_score, "cls": k,
                        "name": io.class_names[k % len(io.class_names)],
                    })
                self._json(200, {
                    "count": len(dets), "detections": dets,
                    "ms": round((time.perf_counter() - t0) * 1e3, 2),
                })

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> threading.Thread:
        """Serve on a daemon thread (tests / embedding); returns it."""
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="yf-http")
        t.start()
        return t

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
