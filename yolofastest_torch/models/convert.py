"""Folded numpy weights -> the port's tensors.

:func:`torch_params_from_folded` takes the ``fold_batchnorm`` tree (HWIO
numpy kernels, the JAX package's layout) and returns what
:class:`yolofastest_torch.models.graph.FoldedExecutor` reads:

* ``params["layers"][name] = {"weight", "bias"}`` for every conv, deconv and
  head: conv HWIO -> OIHW in channels_last memory (depthwise ``(k,k,1,C)`` ->
  ``(C,1,k,k)``), deconv ``(2,2,Cin,Cout)`` -> ``(Cin,Cout,2,2)`` for
  ``conv_transpose2d``; biases in the compute dtype.
* ``params["chains"][names] = (w1, b1, w2, b2, w3, b3)`` for each chain of
  :data:`RES_CHAINS`, stacked by :func:`chain_weights_from_folded`: weights in
  the compute dtype, biases in fp32, as the chain kernel takes them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from yolofastest_torch.kernels.res_block import chain_weights_from_folded
from yolofastest_torch.models.graph import RES_CHAINS
from yolofastest_torch.utils.device import resolve_device


def torch_params_from_folded(folded: Dict[str, Dict[str, np.ndarray]],
                             device: Optional[Any] = None,
                             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    dev = resolve_device(device)

    def tensor(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dt)

    layers = {}
    for name, p in folded.items():
        k = np.asarray(p["kernel"], np.float32)
        if name.startswith("deconv"):
            weight = tensor(k.transpose(2, 3, 0, 1), dtype)
        else:
            weight = tensor(k.transpose(3, 2, 0, 1), dtype).contiguous(
                memory_format=torch.channels_last)
        layers[name] = {"weight": weight, "bias": tensor(p["bias"], dtype)}

    chains = {}
    for names in RES_CHAINS:
        stacked = chain_weights_from_folded(folded, names)
        chains[names] = tuple(tensor(a, dtype if i % 2 == 0 else torch.float32)
                              for i, a in enumerate(stacked))
    return {"layers": layers, "chains": chains}
