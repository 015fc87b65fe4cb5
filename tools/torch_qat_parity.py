#!/usr/bin/env python3
"""Measure the arithmetic of the JAX package's jitted QAT step on the CPU,
and hold the port's fake quantisation against it.

JAX's ``qat_finetune`` jits its step with the activation scales as
constants, and XLA rewrites constant arithmetic.  This prints one JSON line
per question, counting the values in which each candidate formula differs
from what JAX's jitted function computes (the scale a constant, the input
and cotangent arguments):

* ``act_value``: ``fake_quant_act``'s value as ``x / s`` (a true division)
  or ``x * f32(1 / s)``;
* ``act_grad``: its gradient as ``(g * s) / s``, ``(g * s) * f32(1 / s)``
  or ``g * f32(s * f32(1 / s))`` (XLA folds the two constant factors into
  one);
* ``weight_scale``: ``fake_quant_weight``'s ``amax / 127`` as a division or
  as ``amax * f32(1 / 127)`` (a constant divisor too);
* ``port``: the port's ``fake_quant_act``/``fake_quant_weight`` values and
  gradients against JAX's over the same scales.

    python tools/torch_qat_parity.py [--scales 200]

Needs JAX (CPU) beside the port; ~20 s for 100 scales.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=int, default=200)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from yolofastest_torch.quant.qat import fake_quant_act, fake_quant_weight
    from yolofastest_tpu.quant import qat as jq

    f32 = np.float32
    rng = np.random.default_rng(0)
    counts = {"act_value": {"divide": 0, "reciprocal": 0},
              "act_grad": {"g*s/s": 0, "g*s*inv": 0, "g*f32(s*inv)": 0},
              "weight_scale": {"amax/127": 0, "amax*f32(1/127)": 0},
              "port": {"act_value": 0, "act_grad": 0, "weight_value": 0, "weight_grad": 0}}
    n_act = n_inside = n_w = 0
    for _ in range(args.scales):
        s = float(f32(10.0 ** rng.uniform(-3, 0)))
        sf = f32(s)
        inv = f32(1) / sf
        x = (rng.standard_normal(2048) * 70 * s).astype(f32)
        g = rng.standard_normal(2048).astype(f32)
        value = np.asarray(jax.jit(lambda v: jq.fake_quant_act(v, s))(x))
        grad = np.asarray(jax.jit(jax.grad(lambda v, c: jnp.sum(jq.fake_quant_act(v, s) * c)))(
            x, g))
        xc = np.minimum(np.maximum(x, f32(-127) * sf), f32(127) * sf)
        inside = np.abs(x) < f32(127) * sf
        counts["act_value"]["divide"] += int(np.sum(np.round(xc / sf) * sf != value))
        counts["act_value"]["reciprocal"] += int(np.sum(np.round(xc * inv) * sf != value))
        for name, cand in (("g*s/s", (g * sf) / sf), ("g*s*inv", (g * sf) * inv),
                           ("g*f32(s*inv)", g * (sf * inv))):
            counts["act_grad"][name] += int(np.sum(cand[inside] != grad[inside]))
        n_act += x.size
        n_inside += int(inside.sum())
        xt = torch.from_numpy(x).requires_grad_(True)
        yt = fake_quant_act(xt, s)
        (yt * torch.from_numpy(g)).sum().backward()
        counts["port"]["act_value"] += int(np.sum(yt.detach().numpy() != value))
        counts["port"]["act_grad"] += int(np.sum(xt.grad.numpy() != grad))

        k = rng.normal(0, 10.0 ** rng.uniform(-3, 0), (3, 3, 8, 16)).astype(f32)
        ck = rng.standard_normal(k.shape).astype(f32)
        wv = np.asarray(jax.jit(jq.fake_quant_weight)(k))
        wg = np.asarray(jax.jit(jax.grad(lambda v, c: jnp.sum(jq.fake_quant_weight(v) * c)))(
            k, ck))
        amax = np.abs(k).max(axis=(0, 1, 2))
        for name, sc in (("amax/127", amax / f32(127)), ("amax*f32(1/127)",
                                                         amax * (f32(1) / f32(127)))):
            ref = np.round(np.clip(k / sc, -127, 127)) * sc
            counts["weight_scale"][name] += int(np.sum(ref != wv))
        n_w += k.size
        kt = torch.from_numpy(k).requires_grad_(True)
        yk = fake_quant_weight(kt)
        (yk * torch.from_numpy(ck)).sum().backward()
        counts["port"]["weight_value"] += int(np.sum(yk.detach().numpy() != wv))
        counts["port"]["weight_grad"] += int(np.sum(kt.grad.numpy() != wg))

    print(json.dumps({"question": "act_value", "values": n_act, **counts["act_value"]}))
    print(json.dumps({"question": "act_grad", "values_inside_the_range": n_inside,
                      **counts["act_grad"]}))
    print(json.dumps({"question": "weight_scale", "values": n_w, **counts["weight_scale"]}))
    print(json.dumps({"question": "port", "act_values": n_act, "weight_values": n_w,
                      **counts["port"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
