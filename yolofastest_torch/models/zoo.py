"""Model zoo: flat-npz serialisation of variable trees (numpy only).

The port's own copy of ``yolofastest_tpu.models.zoo``: the committed
``weights/*.npz`` files hold ``collection/path/to/leaf`` keys
(``params/conv0/conv/kernel``, ``batch_stats/conv0/bn/mean``, ...), and
:func:`load_variables` returns the same nested ``{'params', 'batch_stats'}``
dict of numpy arrays as the JAX package does, so one loaded tree feeds both.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

_SEP = "/"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_variables(variables: Dict[str, Any], path: str) -> None:
    flat = _flatten({k: v for k, v in variables.items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_variables(path: str) -> Dict[str, Any]:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def zoo_path(res: str) -> str:
    """Committed converted checkpoint for a resolution preset."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "weights", f"yolofastest_{res}.npz")
