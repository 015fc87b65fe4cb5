"""Knowledge distillation: a frozen teacher supervises the train step.

The port of ``yolofastest_tpu/train/distill.py``.  The teacher is the
BN-folded deployment graph (:func:`fold_batchnorm`, then
:func:`folded_apply` / :func:`folded_apply_lite`) run under
``torch.no_grad()``; on the card its six res chains are the chain kernel
(six launches a step).  Heads are ordered coarse -> fine, so a student's
heads align with the LAST ``len(student_heads)`` teacher heads: full -> full
matches both scales, full -> lite the stride-32 head.  Over a process group
each rank's loss is its share of the global batch's (the means' counts
are summed over the ranks).  On the mesh's spatial axis (``rows``) the
teacher runs the spatial executor on the rank's rows
(:func:`~yolofastest_torch.models.spatial_apply`: the chain kernel on the
rows plus their halos, six launches a step on each rank) and returns the
heads of the whole images, as the student's are gathered.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist

from yolofastest_torch.models import (fold_batchnorm, folded_apply, folded_apply_lite,
                                      spatial_apply, torch_params_from_folded)
from yolofastest_torch.utils.device import resolve_device

_APPLY = {"fastest": folded_apply, "lite": folded_apply_lite}


def make_teacher_fn(variables: Dict[str, Any], arch: str = "fastest",
                    compute_dtype: torch.dtype = torch.float32, device=None,
                    rows=None) -> Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Frozen-teacher forward: (B, H, W, 1) images -> the tuple of head
    logits.  ``variables`` is a raw checkpoint tree; BatchNorm is folded
    once here.  ``device`` as the entry points take it ("cuda" by default).
    ``rows``: the spatial axis's ``mesh.rows`` of a spatial Trainer (the
    teacher then takes the rank's rows and returns whole-image heads), or
    None for whole images."""
    if arch not in _APPLY:
        raise ValueError(f"unknown teacher arch {arch!r}")
    params = torch_params_from_folded(fold_batchnorm(variables), resolve_device(device),
                                      compute_dtype)
    apply_fn = _APPLY[arch]
    if rows is not None and rows.count > 1:
        def apply_fn(params, imgs, dtype):
            return spatial_apply(params, imgs, rows, dtype, arch)

    def teacher(imgs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with torch.no_grad():
            heads = apply_fn(params, imgs, compute_dtype)
        return heads if isinstance(heads, tuple) else (heads,)

    return teacher


def distill_loss(student_heads: Tuple[torch.Tensor, ...],
                 teacher_heads: Tuple[torch.Tensor, ...], group=None) -> torch.Tensor:
    """Mean over heads of the MSE between student and teacher logits (the
    teacher's carry no gradient); ``group``: the process group whose ranks
    hold the rest of the batch, or None."""
    if len(teacher_heads) < len(student_heads):
        raise ValueError(
            f"teacher produces {len(teacher_heads)} head(s) but the student "
            f"has {len(student_heads)}")
    matched = teacher_heads[len(teacher_heads) - len(student_heads):]
    for s, t in zip(student_heads, matched):
        if s.shape != t.shape:
            raise ValueError(
                f"student head {tuple(s.shape)} vs teacher head {tuple(t.shape)}: "
                "teacher must share input resolution and num_cls/anchors")
    counts = None
    if group is not None:
        counts = torch.tensor([float(s.numel()) for s in student_heads], dtype=torch.float32,
                              device=student_heads[0].device)
        dist.all_reduce(counts, group=group)
    d = 0.0
    for i, (s, t) in enumerate(zip(student_heads, matched)):
        sq = (s.to(torch.float32) - t.detach().to(torch.float32)) ** 2
        d = d + (torch.mean(sq) if counts is None else torch.sum(sq) / counts[i])
    return d / len(student_heads)
