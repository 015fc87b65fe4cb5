"""Learning-rate schedule: per-epoch cosine x linear warmup.

The port of ``yolofastest_tpu/train/schedule.py`` (reference
``train.py:81-111``)::

    lr(it) = lr0 * lf(it // bpe) * min(it / num_warm, 1)
    lf(e) = ((1 + cos(e * pi / E)) / 2) * 0.8 + 0.2
    num_warm = max(3 * bpe, warmup_min_iters)

A plain function of the step, computed in float32 as the JAX package does.
It takes a Python number or a tensor; for a tensor on the card (Adam's count
of accepted updates) it stays on the card, with no host read.
"""

from __future__ import annotations

import math

import torch


def make_lr_schedule(lr0: float, total_epochs: int, batch_per_epoch: int,
                     warmup_min_iters: int = 1000):
    num_warm = max(3 * batch_per_epoch, warmup_min_iters)

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        epoch = torch.floor(step / batch_per_epoch)
        lf = ((1.0 + torch.cos(epoch * math.pi / total_epochs)) / 2.0) * 0.8 + 0.2
        warm = torch.clamp(step / num_warm, max=1.0)
        return lr0 * lf * warm

    return schedule
