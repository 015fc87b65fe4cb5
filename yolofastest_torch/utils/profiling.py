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


# Host seconds between the trace's window and the block, at either end: the
# profiler keeps a kernel only if its start and end, on the card's clock
# converted to the host's, fall inside the window it opened on the host's
# clock, and that conversion was off by up to ~4 ms on an H100 host.
MARGIN_S = 0.05
# Tiny kernels the warm-up step runs: a long-running process lost the first
# 29-45 kernels launched after the profiler started (H100), so several times
# that many.
_WARM_UP_KERNELS = 256


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _warm_up_cupti() -> None:
    """Tiny kernels, run to their end while the profiler warms up."""
    x = torch.zeros(1024, device="cuda")
    for _ in range(_WARM_UP_KERNELS):
        x.add_(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into a Chrome trace file in ``log_dir`` (made if
    missing); yields the running ``torch.profiler.profile``.

    The trace holds every kernel the block launches.  The card's earlier
    work ends before the profiler starts; the profiler then starts in a
    warm-up step (its events are dropped) in which, where there is a card,
    :data:`_WARM_UP_KERNELS` tiny kernels run to their end, and the window opens
    :data:`MARGIN_S` before the block and closes :data:`MARGIN_S` after the
    block's kernels end.  Without the warm-up kernels the first kernels
    launched after the profiler started were missing (their launches
    recorded), in a long-running process on an H100 in nearly every trace;
    without the margins the block's first kernels could fall outside the
    window."""
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    _synchronize()
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        if cuda:
            _warm_up_cupti()
        prof.step()  # warm-up -> recording: the window opens here
        time.sleep(MARGIN_S)
        try:
            yield prof
        finally:
            _synchronize()  # the block's kernels end inside the window
            time.sleep(MARGIN_S)


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
