"""Profiling helpers: a trace and a section timer.

The port of ``yolofastest_tpu/utils/profiling.py``:

* :func:`trace` — a context manager around ``torch.profiler`` that writes a
  Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``) of the host's
  operations and, where a card is available, its kernels, into ``log_dir``.
  TensorBoard's profiler plugin, ``chrome://tracing`` and Perfetto load it.
  (JAX's writes an XPlane trace.)  The Trainer's step phases are
  ``train_step/*`` spans in it;
* :class:`SectionTimer` — segmented wall-clock timing with an aggregate
  report, for quick host-side numbers without the profiler (JAX's, copied).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into a Chrome trace file in ``log_dir`` (made if
    missing); yields the running ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()  # the block's kernels end inside the trace


class SectionTimer:
    """Accumulating section timer.

    >>> t = SectionTimer()
    >>> with t.section("infer"): run_model()
    >>> with t.section("post"): postprocess()
    >>> t.report()   # {'infer': {'total_ms': ..., 'count': ..., 'avg_ms': ...}}
    """

    def __init__(self):
        self._total = defaultdict(float)
        self._count = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += (time.perf_counter() - t0) * 1e3
            self._count[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_ms": round(self._total[k], 3),
                "count": self._count[k],
                "avg_ms": round(self._total[k] / max(self._count[k], 1), 3),
            }
            for k in self._total
        }
