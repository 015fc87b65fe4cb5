#!/usr/bin/env python3
"""Count the int8 activations in which the port's int8 executors differ from
the JAX package's, on the CPU, with the same scales.

Runs both int8 graphs (``int8`` and ``int8-fused``) of the shipped 256x320
artifact on the golden frames, in the JAX package (jitted as its Detector
jits them: the int8 weights an argument, the scales constants; and, for
comparison, with the scales as traced arguments) and in the port, records
every layer's int8 input, and prints one JSON line per (port formulation,
JAX form): how many int8 values differ and the heads' largest difference.

The port's formulation is ``round(x * f32(1 / s))`` with a fused
multiply-add epilogue.  ``--variants`` adds three others, each one change
away: a true division by ``s``, the epilogue rounded twice
(``acc * m`` then ``+ bias``), and both.

    python tools/torch_int8_parity.py [--frames 20] [--variants]

Needs JAX (CPU) beside the port; ~1 minute on an 8-core host.
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
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from yolofastest_torch.quant import ptq as tptq
    from yolofastest_tpu.models.graph import walk_topology as jwalk
    from yolofastest_tpu.quant import load_int8_zoo
    from yolofastest_tpu.quant import ptq as jptq

    fx = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_256x320.npz"))
    x = (fx["pre_imgs"][:args.frames].astype(np.float32)[..., None] - 128.0) / 255.0
    folded, scales, _ = load_int8_zoo("256x320")
    qp_np = jptq.quantize_weights(folded)
    qp = jax.tree.map(jnp.asarray, qp_np)

    def recording(base, fused):
        """``base`` recording each layer's int8 input in ``rec``."""
        class Rec(base):
            def __init__(self, *a):
                super().__init__(*a)
                self.rec = {}

            if fused:
                def conv(self, x, name, *a, **k):
                    self.rec[name] = x.q
                    return super().conv(x, name, *a, **k)

                def deconv2x(self, x, name):
                    self.rec[name] = x.q
                    return super().deconv2x(x, name)

                def head(self, x, name):
                    self.rec[name] = x.q
                    return super().head(x, name)
            else:
                def _quant_in(self, x, name):
                    xq, sx = super()._quant_in(x, name)
                    self.rec[name] = xq
                    return xq, sx
        return Rec

    def jax_run(fused, constant):
        cls = recording(jptq.Int8FusedExecutor if fused else jptq.Int8Executor, fused)

        def f(qp, sc, x):
            ex = cls(qp, sc)
            heads = jwalk(ex.quantize_input(x) if fused else x, ex)
            return heads, ex.rec

        if constant:
            out = jax.jit(lambda qp, x: f(qp, scales, x))(qp, jnp.asarray(x))
        else:
            out = jax.jit(f)(qp, scales, jnp.asarray(x))
        return jax.tree.map(np.asarray, out)

    params = tptq.QuantParams(qp_np, "cpu")

    def port_run(fused):
        cls = recording(tptq.Int8FusedExecutor if fused else tptq.Int8Executor, fused)
        ex = cls(params, scales)
        xt = torch.from_numpy(x)
        with torch.inference_mode(), tptq.exact_fp32():
            heads = tptq.walk_topology(ex.quantize_input(xt) if fused else xt, ex)
        return [h.numpy() for h in heads], {k: v.numpy() for k, v in ex.rec.items()}

    def divide(y, inv):
        return torch.round(y.float() / (1 / inv.double()).float()).clamp_(-127, 127)

    def twice(acc, m, b):
        return acc * m + b

    variants = {"port (reciprocal, fused multiply-add)": (tptq._requant, tptq._epilogue)}
    if args.variants:
        variants.update({"true division": (divide, tptq._epilogue),
                         "epilogue rounded twice": (tptq._requant, twice),
                         "true division, rounded twice": (divide, twice)})
    for fused in (False, True):
        refs = {"jit, scales constant (the JAX Detector)": jax_run(fused, True),
                "jit, scales traced": jax_run(fused, False)}
        for vname, (requant, epilogue) in variants.items():
            tptq._requant, tptq._epilogue = requant, epilogue
            try:
                heads, rec = port_run(fused)
            finally:
                tptq._requant, tptq._epilogue = variants[next(iter(variants))]
            for jname, (jheads, jrec) in refs.items():
                differing = {k: int((rec[k] != jrec[k]).sum()) for k in jrec}
                worst = sorted(differing.items(), key=lambda kv: -kv[1])[:3]
                print(json.dumps({
                    "backend": "int8-fused" if fused else "int8", "port": vname, "jax": jname,
                    "frames": len(x), "int8_values": int(sum(v.size for v in jrec.values())),
                    "int8_values_differing": sum(differing.values()),
                    "worst_layers": [[k, n] for k, n in worst if n],
                    "heads_max_abs_diff": max(float(np.abs(a - b).max())
                                              for a, b in zip(heads, jheads))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
