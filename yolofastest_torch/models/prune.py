"""Structured channel pruning of the res-block expansion channels (numpy).

The port of ``yolofastest_tpu/models/prune.py``, a copy in numpy.  In an
inverted-residual block (1x1 expand -> 3x3 depthwise -> 1x1 project) an inner
channel ``c`` is touched only by ``k1[..., c]``, ``k2[..., c]`` and
``k3[:, :, c, :]``, so removing it is local to the block, and the pruned
checkpoint is a plain smaller weights tree that every consumer takes as it is
(the port's chain kernel reads the inner width from the weights).

Importance of channel ``c``, with BN folded into the convs::

    ||k1f[..., c]||_1 * ||k2f[..., c]||_1 * ||k3f[:, :, c, :]||_1
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np

from yolofastest_torch.models.graph import fold_batchnorm

__all__ = ["channel_scores", "infer_inner_widths", "jax_to_numpy", "prune_variables"]


def infer_inner_widths(variables: Dict[str, Any]) -> Tuple[Tuple[str, int], ...]:
    """Res-block inner (expansion) widths read off a variables tree, as the
    sorted ``((block, width), ...)`` tuple.  Works on a bare ``params`` dict
    too."""
    params = variables.get("params", variables)
    return tuple(
        (name, int(np.shape(params[name]["conv1"]["conv"]["kernel"])[-1]))
        for name in sorted(params)
        if name.startswith("res")
    )


def channel_scores(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Fold-aware importance of every res-block inner channel: per block, a
    ``(cmid,)`` float64 array (higher = more important)."""
    folded = fold_batchnorm(variables)
    scores: Dict[str, np.ndarray] = {}
    for name, _ in infer_inner_widths(variables):
        k1 = np.asarray(folded[f"{name}/conv1"]["kernel"], np.float64)  # (1,1,cin,cmid)
        k2 = np.asarray(folded[f"{name}/conv2"]["kernel"], np.float64)  # (3,3,1,cmid)
        k3 = np.asarray(folded[f"{name}/conv3"]["kernel"], np.float64)  # (1,1,cmid,cout)
        s1 = np.abs(k1).sum(axis=(0, 1, 2))
        s2 = np.abs(k2).sum(axis=(0, 1, 2))
        s3 = np.abs(k3).sum(axis=(0, 1, 3))
        scores[name] = s1 * s2 * s3
    return scores


def _keep_count(cmid: int, ratio: float, min_keep: int, round_to: int) -> int:
    """Channels kept in a ``cmid``-wide block at prune ``ratio``: rounded up
    to a multiple of ``round_to``, floored at ``min_keep``, capped at
    ``cmid``."""
    raw = cmid * (1.0 - ratio)
    keep = round_to * math.ceil(raw / round_to)
    return max(min(keep, cmid), min(min_keep, cmid))


def prune_variables(
    variables: Dict[str, Any],
    ratio: float,
    min_keep: int = 4,
    round_to: int = 4,
) -> Tuple[Dict[str, Any], Dict[str, Tuple[int, int]]]:
    """Drop the lowest-scoring fraction ``ratio`` of every res block's inner
    channels.  Returns ``(pruned_variables, report)`` where ``report`` maps
    ``block -> (width_before, width_after)``.

    The returned tree is a full ``{'params', 'batch_stats'}`` tree (numpy
    leaves) with the same layer names; only the res-block ``conv1``-out /
    ``conv2`` / ``conv3``-in axes are sliced, and kept channels keep their
    order.
    """
    if not 0.0 <= ratio < 1.0:
        raise ValueError(f"ratio must be in [0, 1), got {ratio}")
    scores = channel_scores(variables)
    params = jax_to_numpy(variables["params"])
    stats = jax_to_numpy(variables["batch_stats"])
    report: Dict[str, Tuple[int, int]] = {}

    for name, cmid in infer_inner_widths(variables):
        keep = _keep_count(cmid, ratio, min_keep, round_to)
        report[name] = (cmid, keep)
        if keep == cmid:
            continue
        # top-`keep` by score, original channel order preserved
        idx = np.sort(np.argsort(scores[name])[::-1][:keep])
        p, s = params[name], stats[name]
        p["conv1"]["conv"]["kernel"] = p["conv1"]["conv"]["kernel"][..., idx]
        p["conv2"]["conv"]["kernel"] = p["conv2"]["conv"]["kernel"][..., idx]
        p["conv3"]["conv"]["kernel"] = p["conv3"]["conv"]["kernel"][:, :, idx, :]
        for sub in ("conv1", "conv2"):
            p[sub]["bn"]["scale"] = p[sub]["bn"]["scale"][idx]
            p[sub]["bn"]["bias"] = p[sub]["bn"]["bias"][idx]
            s[sub]["bn"]["mean"] = s[sub]["bn"]["mean"][idx]
            s[sub]["bn"]["var"] = s[sub]["bn"]["var"][idx]

    return {"params": params, "batch_stats": stats}, report


def jax_to_numpy(tree):
    """Deep-copy a tree of array leaves (nested dicts) to mutable nested dicts
    of numpy arrays (any array-like leaf; the name is the JAX package's)."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.array(tree)
