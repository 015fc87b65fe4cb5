#!/usr/bin/env python3
"""Where the res-chain CUDA kernel spends its time, phase by phase (H100).

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tools/torch_chain_phases.py [--out build/phases]

It builds ``yolofastest_torch/kernels/csrc/res_chain.cu`` once per variant
into ``--out`` (git-ignored ``build/`` by default), all ``nvcc`` at once, each
variant with some of the source's ``SKIP_*`` guards defined, which compile a
phase of the chunk loop out.  It times each variant on the six chains of the
256x320 model at B=1 and B=64, fp32 and bf16, with the tiles the port picks.
A variant with a phase compiled out computes wrong values: the numbers are
for timing only.  The time a phase costs is ``base`` minus ``no_<phase>``;
the phases overlap little, so those differences roughly add up to
``base - only_loop``.  Prints one JSON line per (chain, batch, dtype) and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "yolofastest_torch", "kernels", "csrc", "res_chain.cu")

VARIANTS = {"base": [], "no_expand": ["SKIP_EXPAND"], "no_dw": ["SKIP_DW"],
            "no_proj": ["SKIP_PROJ"], "no_stage": ["SKIP_STAGE"],
            "only_loop": ["SKIP_EXPAND", "SKIP_DW", "SKIP_PROJ", "SKIP_STAGE"]}


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "phases"))
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_chain_phases: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from yolofastest_torch.kernels import _build
    from yolofastest_torch.kernels import res_block as rb
    from yolofastest_torch.models import RES_CHAINS, fold_batchnorm, load_variables

    os.makedirs(args.out, exist_ok=True)
    jobs = {}
    for name, macros in VARIANTS.items():
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
               "-o", os.path.join(args.out, f"{name}.so"), SOURCE]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    folded = fold_batchnorm(load_variables(os.path.join(ROOT, "weights",
                                                        "yolofastest_256x320.npz")))
    planes = [(256 // s, 320 // s) for s in (2, 4, 8, 8, 16, 32)]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    libs = {}
    for name in VARIANTS:
        libs[name] = rb.bind_signatures(ctypes.CDLL(os.path.join(args.out, f"{name}.so")))
    gen = np.random.default_rng(0)
    for names, (h, w) in zip(RES_CHAINS, planes):
        st = [torch.from_numpy(a).to(dev) for a in rb.chain_weights_from_folded(folded, names)]
        k, c, i = st[0].shape
        for b in (1, 64):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(gen.standard_normal((b * h * w, c)).astype(np.float32)).to(
                    dev, dt)
                wts = rb._prepare(x, c, x.shape[0], (h, w), st)
                tile = rb.pick_tile(h, w, c, i, k, b, n_sm, x.element_size())
                out = torch.empty_like(x)
                row = {"chain": names[0], "B": b, "dtype": str(dt).split(".")[-1],
                       "tile_chunk_cluster": list(tile)}
                for name, lib in libs.items():
                    def call():
                        rc = lib.yf_res_chain(0 if dt == torch.float32 else 1, 1, x.data_ptr(),
                                              out.data_ptr(), *[t.data_ptr() for t in wts],
                                              b, h, w, c, i, k, *tile, stream)
                        if rc:
                            raise SystemExit(f"{name}: launch failed with code {rc}")
                    for _ in range(3):
                        call()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(args.reps):
                        call()
                    end.record()
                    torch.cuda.synchronize()
                    row[f"{name}_ms"] = start.elapsed_time(end) / args.reps
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
