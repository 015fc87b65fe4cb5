"""Knowledge distillation: a frozen teacher supervises the train step.

The port of ``yolofastest_tpu/train/distill.py``.  The teacher is the
BN-folded deployment graph (:func:`fold_batchnorm`, then
:func:`folded_apply` / :func:`folded_apply_lite`) run under
``torch.no_grad()``; on the card its six res chains are the chain kernel
(six launches a step).  Heads are ordered coarse -> fine, so a student's
heads align with the LAST ``len(student_heads)`` teacher heads: full -> full
matches both scales, full -> lite the stride-32 head.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from yolofastest_torch.models import (fold_batchnorm, folded_apply, folded_apply_lite,
                                      torch_params_from_folded)
from yolofastest_torch.utils.device import resolve_device

_APPLY = {"fastest": folded_apply, "lite": folded_apply_lite}


def make_teacher_fn(variables: Dict[str, Any], arch: str = "fastest",
                    compute_dtype: torch.dtype = torch.float32,
                    device=None) -> Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Frozen-teacher forward: (B, H, W, 1) images -> the tuple of head
    logits.  ``variables`` is a raw checkpoint tree; BatchNorm is folded
    once here.  ``device`` as the entry points take it ("cuda" by default)."""
    if arch not in _APPLY:
        raise ValueError(f"unknown teacher arch {arch!r}")
    params = torch_params_from_folded(fold_batchnorm(variables), resolve_device(device),
                                      compute_dtype)
    apply_fn = _APPLY[arch]

    def teacher(imgs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with torch.no_grad():
            heads = apply_fn(params, imgs, compute_dtype)
        return heads if isinstance(heads, tuple) else (heads,)

    return teacher


def distill_loss(student_heads: Tuple[torch.Tensor, ...],
                 teacher_heads: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Mean over heads of the MSE between student and teacher logits (the
    teacher's carry no gradient)."""
    if len(teacher_heads) < len(student_heads):
        raise ValueError(
            f"teacher produces {len(teacher_heads)} head(s) but the student "
            f"has {len(student_heads)}")
    matched = teacher_heads[len(teacher_heads) - len(student_heads):]
    d = 0.0
    for s, t in zip(student_heads, matched):
        t = t.detach().to(torch.float32)
        if s.shape != t.shape:
            raise ValueError(
                f"student head {tuple(s.shape)} vs teacher head {tuple(t.shape)}: "
                "teacher must share input resolution and num_cls/anchors")
        d = d + torch.mean((s.to(torch.float32) - t) ** 2)
    return d / len(student_heads)
