"""Shipped int8 deployment artifacts (``weights/yolofastest_int8_<res>.npz``).

The port of ``yolofastest_tpu/quant/zoo.py`` (numpy; the ``.npz`` reading
is the port's own :mod:`yolofastest_torch.models.zoo`).  An artifact holds
the refined BN-folded weights (``folded``), the frozen activation scales
every int8 backend deploys at (``act_scales``) and, for a hybrid artifact,
the layers kept at full precision (``keep_fp``).  The loader returns what
the file holds: ``yolofastest_int8_pruned040_256x320.npz`` keeps
``('conv2_2', 'conv4_1_2')``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from yolofastest_torch.models.zoo import load_variables, save_variables
from yolofastest_torch.quant.ptq import quantize_weights


def int8_zoo_path(res: str) -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "weights", f"yolofastest_int8_{res}.npz")


def save_int8_zoo(folded: Dict[str, Any], act_scales: Dict[str, float],
                  path: str, keep_fp: Tuple[str, ...] = ()) -> None:
    """``keep_fp`` names folded-graph layers the deployment keeps at full
    precision; it is part of the artifact because the artifact is the
    deployment config."""
    tree = {"folded": folded,
            "act_scales": {k: np.float64(v) for k, v in act_scales.items()}}
    if keep_fp:
        tree["keep_fp"] = np.asarray(sorted(keep_fp))
    save_variables(tree, path)


def load_int8_zoo(res_or_path: str) -> Optional[Tuple[Dict[str, Any], Dict[str, float],
                                                      Tuple[str, ...]]]:
    """Returns ``(folded, act_scales, keep_fp)`` or None when the artifact
    is absent; ``act_scales`` values are plain floats, ``keep_fp`` is empty
    for a fully int8 artifact."""
    path = (res_or_path if os.path.sep in res_or_path or
            res_or_path.endswith(".npz") else int8_zoo_path(res_or_path))
    if not os.path.exists(path):
        return None
    tree = load_variables(path)
    if "folded" not in tree or "act_scales" not in tree:
        raise ValueError(f"{path}: not an int8 zoo artifact "
                         "(expect 'folded' + 'act_scales' subtrees)")

    # layer names contain '/' (e.g. "res3_5/conv2"), which the flat-npz
    # round trip re-nests: flatten them back to '/'-joined keys.  The folded
    # tree's leaves are the per-layer {kernel, bias} dicts.
    def flat_scalars(d, prefix=""):
        out = {}
        for k, v in d.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                out.update(flat_scalars(v, key + "/"))
            else:
                out[key] = float(v)
        return out

    def flat_layers(d, prefix=""):
        out = {}
        for k, v in d.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict) and not {"kernel", "bias"} <= set(v):
                out.update(flat_layers(v, key + "/"))
            else:
                out[key] = v
        return out

    keep_fp = tuple(str(s) for s in np.asarray(tree.get("keep_fp", ())))
    return flat_layers(tree["folded"]), flat_scalars(tree["act_scales"]), keep_fp


def mixed_native_tree(folded: Dict[str, Any], act_scales: Dict[str, float],
                      keep_fp: Tuple[str, ...]):
    """The tensor tree and scales of a native hybrid deployment: layers
    outside ``keep_fp`` ship quantised (``kernel_q``/``w_scale`` and their
    activation scale), ``keep_fp`` layers ship the fp folded kernel.
    Returns ``(tree, scales)`` for ``save_native_weights``."""
    if not keep_fp:
        return quantize_weights(folded), dict(act_scales)
    unknown = set(keep_fp) - set(folded)
    if unknown:
        raise ValueError(f"keep_fp layers not in the folded tree: {sorted(unknown)}")
    tree = dict(quantize_weights({k: v for k, v in folded.items() if k not in keep_fp}))
    for k in keep_fp:
        tree[k] = folded[k]
    scales = {k: v for k, v in act_scales.items() if k not in keep_fp}
    return tree, scales
