"""Both packages' StableHLO text through ``yf_shlo``, side by side.

Writes the port's ``forward.mlir`` and ``detect.mlir``
(``yolofastest_torch.export.save_exported_mlir``) and the JAX package's
(``yolofastest_tpu.export.save_exported_mlir``) for one zoo at batch 1, runs
each through ``cpp/runner/shlo_runner.cpp`` (built by
``yolofastest_torch.native.find_shlo_runner``) on the first golden frames,
and prints one JSON line: the largest difference between the two texts'
results, the port's text against JAX's jitted functions (the folded logits;
the exported detect program's counts, classes, boxes, conf and cls_score),
and yf_shlo's ``avg_time`` of each text in turns (port, JAX, JAX, port),
beside the host CPU.  The times are the host CPU's, in this process's
machine; both texts run in the same calls of the same binary.

    JAX_PLATFORMS=cpu python tools/shlo_check.py [--res 256x320] [--frames 4] [--reps 3]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
KEYS = ("boxes", "cls_idx", "cls_score", "conf", "count", "valid")


def host_cpu() -> str:
    out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    names = [ln.split(":", 1)[1].strip() for ln in out.splitlines() if "Model name" in ln]
    return f"{names[0] if names else 'unknown'}, {os.cpu_count()} CPUs"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", default="256x320")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from yolofastest_torch import export as tex
    from yolofastest_torch.configs import get_config as tget_config
    from yolofastest_torch.models import load_variables as tload
    from yolofastest_torch.native import find_shlo_runner, run_shlo
    from yolofastest_tpu import export as jex
    from yolofastest_tpu.configs import get_config
    from yolofastest_tpu.models import fold_batchnorm, load_variables, zoo_path
    from yolofastest_tpu.models.graph import folded_apply

    runner, _ = find_shlo_runner()
    variables = load_variables(zoo_path(args.res))
    folded = fold_batchnorm(variables)
    pre = np.load(os.path.join(ROOT, "tests", "fixtures",
                               f"golden_{args.res}.npz"))["pre_imgs"][:args.frames]
    x = (pre.astype(np.float32)[..., None] - 128.0) / 255.0
    want_heads = [np.asarray(h) for h in jax.jit(folded_apply)(
        jax.tree.map(jnp.asarray, folded), jnp.asarray(x))]
    want_det = jex.export_detect_pipeline(variables, get_config(args.res),
                                          batch=args.frames).call(jnp.asarray(pre))
    want_det = {k: np.asarray(v) for k, v in want_det.items()}

    report = {"res": args.res, "frames": args.frames, "host_cpu": host_cpu()}
    with tempfile.TemporaryDirectory() as tmp:
        path = {}
        tvars, tcfg = tload(zoo_path(args.res)), tget_config(args.res)
        for name, export in (("forward", lambda: tex.export_folded_forward(
                                  fold_batchnorm(tvars), tcfg, device="cpu")),
                             ("detect", lambda: tex.export_detect_pipeline(tvars, tcfg,
                                                                           device="cpu"))):
            path[("port", name)] = os.path.join(tmp, f"port_{name}.mlir")
            tex.save_exported_mlir(export(), path[("port", name)])
        for name, export in (("forward", lambda: jex.export_folded_forward(
                                  folded, get_config(args.res))),
                             ("detect", lambda: jex.export_detect_pipeline(
                                 variables, get_config(args.res)))):
            path[("jax", name)] = os.path.join(tmp, f"jax_{name}.mlir")
            jex.save_exported_mlir(export(), path[("jax", name)])
        for name, arg in (("forward", x), ("detect", pre)):
            outs, times = {"port": [], "jax": []}, {"port": [], "jax": []}
            for i in range(args.frames):
                for side in ("port", "jax", "jax", "port"):
                    res, ms = run_shlo(path[(side, name)], arg[i:i + 1], reps=args.reps,
                                       runner=runner)
                    times[side].append(ms)
                    if len(outs[side]) == i:
                        outs[side].append(res)
            between = max(float(np.abs(a - b).max()) for i in range(args.frames)
                          for a, b in zip(outs["port"][i], outs["jax"][i]))
            entry = {"port_vs_jax_text_max_abs": between,
                     "avg_ms": {k: float(np.median(v)) for k, v in times.items()},
                     "avg_ms_runs": times}
            if name == "forward":
                entry["port_text_vs_jax_jit_max_abs"] = max(
                    float(np.abs(o - w[i:i + 1]).max()) for i in range(args.frames)
                    for o, w in zip(outs["port"][i], want_heads))
            else:
                got = [dict(zip(KEYS, o)) for o in outs["port"]]
                entry["counts"] = [int(g["count"][0]) for g in got]
                entry["counts_equal_jax_program"] = entry["counts"] == want_det["count"].tolist()
                diffs = {"boxes": 0.0, "conf": 0.0, "cls_score": 0.0}
                same_cls = True
                for i, g in enumerate(got):
                    n = int(want_det["count"][i])
                    same_cls &= bool(np.array_equal(g["cls_idx"][0, :n],
                                                    want_det["cls_idx"][i, :n]))
                    for k in diffs:
                        if n:
                            diffs[k] = max(diffs[k], float(np.abs(g[k][0, :n]
                                                                  - want_det[k][i, :n]).max()))
                entry["cls_idx_equal_jax_program"] = same_cls
                entry["max_abs_vs_jax_program"] = diffs
            report[name] = entry
    print(json.dumps(report))


if __name__ == "__main__":
    main()
