"""Reference ``.pth`` checkpoints -> the flax-layout variables tree.

The port of ``yolofastest_tpu/models/torch_io.py``.  The reference ships
trained ``state_dict`` checkpoints
(``models/pytorch/{256x320,512x640}/YOLO-Fastest_epoch_*.pth``) whose module
names are the layer names of this package, so the conversion is a layout
transpose:

* conv weight      OIHW -> HWIO                     (``<m>.0.weight``)
* depthwise weight (C,1,K,K) -> (K,K,1,C)           (the same transpose)
* deconv weight    (Cin,Cout,2,2) -> (2,2,Cin,Cout) (``deconv5_1.0.weight``)
* BatchNorm        weight/bias/running_mean/running_var -> scale/bias and
                   batch_stats mean/var             (``<m>.1.*``)
* heads            Conv2d with a bias               (``head_4.weight``/``.bias``)

The result is the numpy tree :func:`yolofastest_torch.models.load_variables`
returns, bit for bit what the JAX package's converter gives.
:func:`variables_to_torch_state_dict` is the inverse: a variables tree as a
state_dict in the reference's layout, which ``torch.save`` writes as a
``.pth`` the reference (and both packages' loaders) read.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` state_dict as float32 numpy arrays (tensors only:
    ``weights_only`` loading)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _to_np(v) for k, v in sd.items()}


def _convert_conv_bn(sd, prefix: str, deconv: bool = False):
    """``<prefix>.0`` conv + ``<prefix>.1`` BN -> the param and stat dicts."""
    w = sd[f"{prefix}.0.weight"]
    if deconv:
        params = {"kernel": w.transpose(2, 3, 0, 1)}  # (Cin,Cout,kh,kw) -> (kh,kw,Cin,Cout)
    else:
        params = {"conv": {"kernel": w.transpose(2, 3, 1, 0)}}  # OIHW -> HWIO
    params["bn"] = {"scale": sd[f"{prefix}.1.weight"], "bias": sd[f"{prefix}.1.bias"]}
    return params, {"bn": {"mean": sd[f"{prefix}.1.running_mean"],
                           "var": sd[f"{prefix}.1.running_var"]}}


def _convert_head(sd, prefix: str):
    return {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0),
            "bias": sd[f"{prefix}.bias"]}


def torch_state_dict_to_variables(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The full ``{'params', 'batch_stats'}`` tree from a reference
    state_dict, for both architectures (the module set comes from the keys)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for m in sorted({k.split(".")[0] for k in sd}):
        if m.startswith("head"):
            params[m] = _convert_head(sd, m)
        elif m.startswith("res"):
            params[m], stats[m] = {}, {}
            for sub in ("conv1", "conv2", "conv3"):
                params[m][sub], stats[m][sub] = _convert_conv_bn(sd, f"{m}.{sub}")
        else:
            params[m], stats[m] = _convert_conv_bn(sd, m, deconv=m.startswith("deconv"))
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.pth`` as a variables tree (numpy leaves)."""
    return torch_state_dict_to_variables(load_torch_state_dict(path))


def variables_to_torch_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A variables tree as a state_dict in the reference's layout (the
    inverse of :func:`torch_state_dict_to_variables`, bit for bit), with the
    ``num_batches_tracked`` counters a torch BatchNorm carries."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def put(key, a, perm=None):
        a = np.asarray(a, np.float32)
        sd[key] = torch.from_numpy(np.ascontiguousarray(a.transpose(perm) if perm else a))

    def conv_bn(prefix, p, s, deconv=False):
        if deconv:
            put(f"{prefix}.0.weight", p["kernel"], (2, 3, 0, 1))
        else:
            put(f"{prefix}.0.weight", p["conv"]["kernel"], (3, 2, 0, 1))
        put(f"{prefix}.1.weight", p["bn"]["scale"])
        put(f"{prefix}.1.bias", p["bn"]["bias"])
        put(f"{prefix}.1.running_mean", s["bn"]["mean"])
        put(f"{prefix}.1.running_var", s["bn"]["var"])
        sd[f"{prefix}.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    for m, p in params.items():
        if m.startswith("head"):
            put(f"{m}.weight", p["kernel"], (3, 2, 0, 1))
            put(f"{m}.bias", p["bias"])
        elif m.startswith("res"):
            for sub in ("conv1", "conv2", "conv3"):
                conv_bn(f"{m}.{sub}", p[sub], stats[m][sub])
        else:
            conv_bn(m, p, stats[m], deconv=m.startswith("deconv"))
    return sd
