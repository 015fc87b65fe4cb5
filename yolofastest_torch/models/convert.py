"""Weights between the JAX package's layout and the port's tensors.

* :func:`torch_params_from_folded` takes the ``fold_batchnorm`` tree (HWIO
  numpy kernels, the JAX package's layout) and returns what
  :class:`yolofastest_torch.models.graph.FoldedExecutor` reads:

  - ``params["layers"][name] = {"weight", "bias"}`` for every conv, deconv
    and head: conv HWIO -> OIHW in channels_last memory (depthwise
    ``(k,k,1,C)`` -> ``(C,1,k,k)``), deconv ``(2,2,Cin,Cout)`` ->
    ``(Cin,Cout,2,2)`` for ``conv_transpose2d``; biases in the compute dtype.
  - ``params["chains"][names] = (w1, b1, w2, b2, w3, b3)`` for each chain of
    :data:`RES_CHAINS`, stacked by :func:`chain_weights_from_folded`: weights
    in the compute dtype, biases in fp32, as the chain kernel takes them.

* :func:`module_state_from_variables` and :func:`variables_from_module` map a
  flax ``{"params", "batch_stats"}`` numpy tree (the zoo ``.npz`` layout)
  onto the ``state_dict`` of :class:`yolofastest_torch.models.yolo_fastest.
  YoloFastest` and back, with the same kernel transposes; BatchNorm's
  ``scale``/``bias``/``mean``/``var`` are the module's ``weight``/``bias``/
  ``running_mean``/``running_var``.  The round trip is bitwise, so a model
  trained here saves as an ``.npz`` that both packages load.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

from yolofastest_torch.kernels.res_block import chain_weights_from_folded
from yolofastest_torch.models.graph import RES_CHAINS
from yolofastest_torch.utils.device import resolve_device


def torch_params_from_folded(folded: Dict[str, Dict[str, np.ndarray]],
                             device: Optional[Any] = None,
                             dtype: torch.dtype = torch.float32,
                             chains: bool = True) -> Dict[str, Any]:
    """``chains=False`` leaves ``params["chains"]`` empty, for a subset of
    the layers or an executor that runs its chains layer by layer."""
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

    stacks = {}
    for names in RES_CHAINS if chains else ():
        stacked = chain_weights_from_folded(folded, names)
        stacks[names] = tuple(tensor(a, dtype if i % 2 == 0 else torch.float32)
                              for i, a in enumerate(stacked))
    return {"layers": layers, "chains": stacks}


# flax leaf name -> module attribute name, under a "bn" submodule
_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
# kernel layout -> weight layout: HWIO -> OIHW, and the deconv's
# (2, 2, Cin, Cout) -> (Cin, Cout, 2, 2)
_CONV_T, _DECONV_T = (3, 2, 0, 1), (2, 3, 0, 1)


def _inverse(perm):
    return tuple(int(i) for i in np.argsort(perm))


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def module_state_from_variables(variables: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax ``{"params", "batch_stats"}`` tree (numpy or any array leaves) ->
    the module's ``state_dict`` (fp32 CPU tensors)."""
    state = OrderedDict()
    for path, leaf in _walk(variables["params"]):
        a = np.array(leaf, np.float32)  # a copy: the tensors must not alias the input
        *mods, leaf_name = path
        if mods and mods[-1] == "bn":
            key = mods + [_BN_PARAMS[leaf_name]]
        elif leaf_name == "kernel":
            a = a.transpose(_DECONV_T if path[0].startswith("deconv") else _CONV_T)
            key = mods + ["weight"]
        else:  # a head's bias
            key = mods + [leaf_name]
        state[".".join(key)] = torch.from_numpy(np.ascontiguousarray(a))
    for path, leaf in _walk(variables["batch_stats"]):
        *mods, leaf_name = path
        state[".".join(mods + [_BN_STATS[leaf_name]])] = torch.from_numpy(
            np.array(leaf, np.float32))
    return state


def variables_from_module(module_or_state) -> Dict[str, Any]:
    """The module (or its ``state_dict``) -> the flax ``{"params",
    "batch_stats"}`` tree of numpy arrays in the tensors' dtype (float32 for
    the models the port builds: the zoo ``.npz`` layout)."""
    state = (module_or_state.state_dict() if isinstance(module_or_state, torch.nn.Module)
             else module_or_state)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    bn_params = {v: k for k, v in _BN_PARAMS.items()}
    bn_stats = {v: k for k, v in _BN_STATS.items()}
    for key, t in state.items():
        a = t.detach().cpu().numpy().copy()
        *mods, leaf_name = key.split(".")
        if mods and mods[-1] == "bn":
            if leaf_name in bn_stats:
                tree, path = stats, mods + [bn_stats[leaf_name]]
            else:
                tree, path = params, mods + [bn_params[leaf_name]]
        elif leaf_name == "weight":
            deconv = mods[0].startswith("deconv")
            a = a.transpose(_inverse(_DECONV_T if deconv else _CONV_T))
            tree, path = params, mods + ["kernel"]
        else:
            tree, path = params, mods + [leaf_name]
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return {"params": params, "batch_stats": stats}
