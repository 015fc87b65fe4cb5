"""Native weights format (``.yfb``) for the C++ runtime.

The port of ``yolofastest_tpu/export/native.py``: one little-endian binary
holding the BN-folded (or int8-quantised) tensors by layer name, the file
``cpp/src/weights.cpp`` loads.  Layout:

    magic  'Y','F','W','B'
    u32    version (1)
    u32    n_tensors
    repeat n_tensors (sorted by name):
        u32  name_len;  name bytes (utf-8)
        u32  dtype      (0 = float32, 1 = int8)
        u32  ndim;      u32 dims[ndim]
        u64  nbytes;    raw data

The run configuration travels inside the file under the reserved
``__meta__`` layer (``__meta__/anchors``, ``__meta__/conf_nms`` and
``__meta__/input_hw`` as f32 tensors; ``__meta__/class_names`` as the int8
bytes of a newline-joined utf-8 string), so a native consumer decodes with
the config the model was exported under; a reader that never looks these
names up still loads the weights.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np

MAGIC = b"YFWB"
VERSION = 1
_DTYPES = {np.dtype(np.float32): 0, np.dtype(np.int8): 1}
_DTYPES_INV = {0: np.float32, 1: np.int8}


def save_native_weights(folded: Dict[str, Dict[str, Any]], path: str,
                        act_scales: Dict[str, float] = None,
                        io_config=None) -> None:
    """Write ``{layer: {tensor_name: array}}`` (e.g. fold_batchnorm or
    quantize_weights output) as a flat ``layer/tensor`` -> array file.

    ``act_scales`` (per-layer input activation scales from calibration)
    adds ``layer/act_scale`` to each named layer; with those
    present alongside int8 ``kernel_q`` weights, the C++ engine executes the
    1x1 convs with real int8 arithmetic (``cpp/src/ops_int8.cpp``) instead
    of dequantising to fp32 at load.  Scale keys that are not layer names
    (the ``out/...`` fused-executor scales) are skipped.

    ``io_config`` (an :class:`yolofastest_torch.configs.IOConfig`) embeds the
    run configuration — anchors, conf/NMS thresholds, class names, input
    resolution — as ``__meta__/*`` entries so native consumers decode with
    THE config the model was exported under (custom auto-anchor configs
    included) instead of re-declared literals.
    """
    flat: Dict[str, np.ndarray] = {}
    for layer, tensors in folded.items():
        for tname, arr in tensors.items():
            flat[f"{layer}/{tname}"] = np.ascontiguousarray(np.asarray(arr))
    if act_scales:
        for layer, s in act_scales.items():
            if layer in folded:
                flat[f"{layer}/act_scale"] = np.asarray([s], np.float32)
    if io_config is not None:
        # anchors: (n_scales, A, 2), finest head first — same order the
        # engine emits heads in (head_large stride 16, then head_small).
        flat["__meta__/anchors"] = np.asarray(io_config.anchors, np.float32)
        flat["__meta__/conf_nms"] = np.asarray(
            [io_config.conf_thre, io_config.nms_thre], np.float32)
        flat["__meta__/input_hw"] = np.asarray(io_config.input_hw, np.float32)
        names = "\n".join(io_config.class_names).encode("utf-8")
        flat["__meta__/class_names"] = np.frombuffer(names, np.int8).copy()

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", VERSION, len(flat)))
        for name, arr in sorted(flat.items()):
            if arr.dtype not in _DTYPES:
                arr = arr.astype(np.float32)
            nb = name.encode("utf-8")
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<I", _DTYPES[arr.dtype]))
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}I", *arr.shape))
            data = arr.tobytes()
            f.write(struct.pack("<Q", len(data)))
            f.write(data)


def load_native_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a ``.yfb`` back into ``{layer: {tensor: array}}`` (test oracle
    for the C++ loader)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with open(path, "rb") as f:
        assert f.read(4) == MAGIC, "bad magic"
        version, n = struct.unpack("<II", f.read(8))
        assert version == VERSION
        for _ in range(n):
            (nlen,) = struct.unpack("<I", f.read(4))
            name = f.read(nlen).decode("utf-8")
            dtype_id, ndim = struct.unpack("<II", f.read(8))
            shape = struct.unpack(f"<{ndim}I", f.read(4 * ndim))
            (nbytes,) = struct.unpack("<Q", f.read(8))
            arr = np.frombuffer(f.read(nbytes), dtype=_DTYPES_INV[dtype_id]).reshape(shape)
            layer, tname = name.rsplit("/", 1)
            out.setdefault(layer, {})[tname] = arr
    return out


def read_native_meta(path: str) -> Dict[str, Any]:
    """Decode the ``__meta__`` run-config block of a ``.yfb`` (or return
    ``{}`` for a weights-only file).  Keys mirror IOConfig fields:
    ``anchors`` (nested tuples), ``conf_thre``, ``nms_thre``,
    ``class_names`` (tuple of str), ``input_hw``."""
    meta = load_native_weights(path).get("__meta__", {})
    if not meta:
        return {}
    out: Dict[str, Any] = {}
    if "anchors" in meta:
        out["anchors"] = tuple(
            tuple(tuple(float(v) for v in a) for a in grp)
            for grp in meta["anchors"])
    if "conf_nms" in meta:
        out["conf_thre"] = float(meta["conf_nms"][0])
        out["nms_thre"] = float(meta["conf_nms"][1])
    if "input_hw" in meta:
        out["input_hw"] = tuple(int(v) for v in meta["input_hw"])
    if "class_names" in meta:
        out["class_names"] = tuple(
            meta["class_names"].tobytes().decode("utf-8").split("\n"))
    return out
