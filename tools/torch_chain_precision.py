#!/usr/bin/env python3
"""How far fp32 res chains may drift from exact arithmetic.

    python3 tools/torch_chain_precision.py [--seeds N]

For random chains (weights drawn as the kernel tests draw them, at two
scales) it computes the chain in float64, with the port's plain fp32 version
(``res_chain_rows_plain``), and with the CUDA kernel's fp32 arithmetic
emulated in numpy: each 1x1 product as 3xTF32 (both operands split into
tf32(a) + tf32(a - tf32(a)), the three products other than small x small
summed, in float64: it does not model the tensor cores' truncating
accumulation, so the card's kernel can be further from float64 than this).
It prints max|y| and, for each pair, the worst ratio of
``|a - b|`` to the kernel tests' fp32 tolerance ``1e-4 + 1e-4 |b|``: a
ratio above 1 fails that tolerance.  Where the plain version itself fails
against float64, no other summation order can be expected to pass against it.

On a machine with a CUDA card it also runs the CUDA kernel and the plain
version there (TF32 off), prints their ratios against float64, and last the
largest ratio of the kernel's distance from float64 to the plain version's
over the inputs where the plain version misses the tolerance (the measure
that ``chip_smoke.py``'s ``FLOAT64_SLACK`` bounds).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1, 5, 8, 10, 48, 224), (3, 5, 13, 17, 48, 136), (2, 2, 8, 10, 48, 224),
          (1, 4, 16, 20, 24, 136), (3, 5, 13, 17, 16, 48)]  # (B, K, H, W, C, I)


def tf32(a):
    """Round float32 to tf32 (10 mantissa bits), to nearest, ties away."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def matmul(a, b, mode):
    if mode == "float64":
        return a.astype(np.float64) @ b.astype(np.float64)
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    f64 = np.float64
    return (a_small.astype(f64) @ b_big.astype(f64) + a_big.astype(f64) @ b_small.astype(f64)
            + a_big.astype(f64) @ b_big.astype(f64))


def chain(x, w1, b1, w2, b2, w3, b3, mode):
    """The chain in NHWC numpy, rounding to float32 where the kernel does
    unless mode is float64."""
    ft = np.float64 if mode == "float64" else np.float32
    x = x.astype(ft)
    h, w = x.shape[1:3]
    for k in range(w1.shape[0]):
        h1 = np.maximum(matmul(x, w1[k], mode) + b1[k], 0).astype(ft)
        pad = np.pad(h1, ((0, 0), (1, 1), (1, 1), (0, 0)))
        acc = np.zeros_like(h1)
        for dy in range(3):
            for dx in range(3):
                acc = acc + pad[:, dy:dy + h, dx:dx + w] * w2[k, dy, dx]
        h2 = np.maximum(acc + b2[k], 0).astype(ft)
        x = ((matmul(h2, w3[k], mode) + b3[k]) + x).astype(ft)
    return x


def worst_ratio(a, b):
    return float(np.max(np.abs(a - b) / (1e-4 + 1e-4 * np.abs(b))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=1, help="inputs drawn per shape and scale")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from yolofastest_torch.kernels.res_block import fused_res_chain_rows, res_chain_rows_plain

    card = torch.cuda.is_available()
    if card:
        torch.backends.cudnn.allow_tf32 = False
    worst_vs_plain = 0.0
    for scale in (0.3, 0.15):
        for b, k, h, w, c, i in SHAPES:
            for seed in range(7, 7 + args.seeds):
                rng = np.random.default_rng(seed)
                x = (rng.standard_normal((b, h, w, c)) * 0.5).astype(np.float32)
                st = [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in (
                    ((k, c, i), scale), ((k, i), 0.1), ((k, 3, 3, i), scale), ((k, i), 0.1),
                    ((k, i, c), scale), ((k, c), 0.1))]
                exact = chain(x, *st, "float64")
                plain = res_chain_rows_plain(torch.from_numpy(x).reshape(-1, c),
                                             *map(torch.from_numpy, st), (h, w)).numpy()
                plain = plain.reshape(x.shape)
                tf = chain(x, *st, "3xtf32")
                line = (f"scale {scale} seed {seed} B{b} K{k} {h}x{w} C{c} I{i}: "
                        f"max|y| {np.abs(exact).max():.4g}  "
                        f"plain vs float64 {worst_ratio(plain, exact):.3g}  "
                        f"3xTF32 vs float64 {worst_ratio(tf, exact):.3g}  "
                        f"3xTF32 vs plain {worst_ratio(tf, plain):.3g}")
                if card:
                    xt = torch.from_numpy(x).reshape(-1, c).cuda()
                    wt = [torch.from_numpy(a).cuda() for a in st]
                    kern = fused_res_chain_rows(xt, *wt, (h, w)).cpu().numpy().reshape(x.shape)
                    cplain = res_chain_rows_plain(xt, *wt, (h, w)).cpu().numpy().reshape(x.shape)
                    r_kern, r_plain = worst_ratio(kern, exact), worst_ratio(cplain, exact)
                    line += (f"  card: kernel vs float64 {r_kern:.3g}, plain vs float64 "
                             f"{r_plain:.3g}, kernel vs plain {worst_ratio(kern, cplain):.3g}")
                    if r_plain > 1.0:
                        worst_vs_plain = max(worst_vs_plain, r_kern / r_plain)
                print(line, flush=True)
    if card:
        print(f"card: largest (kernel vs float64) / (plain vs float64) where plain misses "
              f"the tolerance: {worst_vs_plain:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
