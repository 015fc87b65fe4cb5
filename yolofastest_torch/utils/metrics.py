"""Training metrics sinks: JSONL always, TensorBoard when available.

The port's own copy of ``yolofastest_tpu/utils/metrics.py``.

Covers the reference's tensorboardX usage (``train.py:151-155``, scalars
``lr``, ``example/sec`` and the 7 loss components every 10 steps).  The
primary sink is a JSONL file — greppable, diffable, no daemon — and a
``tensorboardX.SummaryWriter`` is attached when the package exists.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, filename), "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter  # optional

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def __call__(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
