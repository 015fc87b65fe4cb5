"""Model zoo: flat-npz serialisation of variable trees (numpy only).

The port's own copy of ``yolofastest_tpu.models.zoo``: the committed
``weights/*.npz`` files hold ``collection/path/to/leaf`` keys
(``params/conv0/conv/kernel``, ``batch_stats/conv0/bn/mean``, ...), and
:func:`load_variables` returns the same nested ``{'params', 'batch_stats'}``
dict of numpy arrays as the JAX package does, so one loaded tree feeds both.
:func:`lite_seed` grafts the lite tree from a full checkpoint (the port of
``tools/make_lite_seed.py``).
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


def graft(dst: Dict[str, Any], src: Dict[str, Any], path: str = "", log=print):
    """Copy every leaf of ``dst``'s tree shape from ``src`` where ``src``
    has a leaf of that shape at the same path; keep ``dst``'s elsewhere
    (logged).  Returns ``(tree, grafted, kept)``."""
    out, hits, misses = {}, 0, 0
    for k, v in dst.items():
        if isinstance(v, dict):
            out[k], h, m = graft(v, src.get(k, {}), path + k + "/", log)
            hits, misses = hits + h, misses + m
        else:
            s = src.get(k) if isinstance(src, dict) else None
            if s is not None and np.shape(s) == np.shape(v):
                out[k], hits = np.asarray(s), hits + 1
            else:
                out[k], misses = np.asarray(v), misses + 1
                log(f"  kept random init: {path + k} {np.shape(v)}")
    return out, hits, misses


def lite_seed(res: str, log=print) -> Dict[str, Any]:
    """YoloFastest-lite's variables grafted from the full checkpoint of
    ``res``: the lite tree (the backbone and the stride-32 ``head_5`` path)
    is a subset of the full one, so every leaf comes from it; a leaf it
    lacks keeps the port's seeded init."""
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.models.convert import variables_from_module
    from yolofastest_torch.models.yolo_fastest import build_model

    io = get_config(f"lite-{res}").io
    full = load_variables(zoo_path(res))
    init = variables_from_module(build_model(io.num_cls, io.num_anchors, arch="lite", seed=0))
    seeded = {}
    for col in sorted(init):  # JAX's order: batch_stats, params
        seeded[col], h, m = graft(init[col], full.get(col, {}), log=log)
        log(f"{col}: grafted {h}, kept-init {m}")
    return seeded
