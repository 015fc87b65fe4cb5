"""Post-training int8 quantisation of the folded graph: the weights.

The port of ``quantize_weights`` from ``yolofastest_tpu/quant/ptq.py``
(numpy): symmetric per-output-channel int8 weights with scale ``max|w| /
127``, which every ``export`` run writes as ``model_int8.yfb``.  Calibration
and the int8 executors are not ported yet (ROADMAP: 'Quantisation').
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def quantize_weights(folded: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, Dict[str, np.ndarray]]:
    """Folded fp params -> int8 params.

    Per layer: ``kernel_q`` int8 (same layout as fp), ``w_scale`` (O,)
    float32, ``bias`` float32 passthrough.
    """
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, p in folded.items():
        k = np.asarray(p["kernel"], np.float32)
        reduce_axes = tuple(range(k.ndim - 1))  # all but out-channel (last)
        amax = np.max(np.abs(k), axis=reduce_axes)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        kq = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
        out[name] = {"kernel_q": kq, "w_scale": scale, "bias": p["bias"].astype(np.float32)}
    return out
