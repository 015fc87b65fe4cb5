"""Fused inverted-residual chains: the CUDA kernel and its plain version.

The port of ``yolofastest_tpu/kernels/res_block.py``.  A chain is K
same-shape blocks (1x1 expand C->I, 3x3 depthwise, 1x1 project I->C plus the
residual); the YOLO-Fastest backbone has 18 such blocks in six chains.  One
CUDA kernel (``csrc/res_chain.cu``) runs a whole chain in one launch, with the
I-wide expanded activation held on chip.  It takes either layout of the JAX
package:

* channels-first ``(C, B*H*W)``: :func:`fused_res_chain_cf`, and its NHWC
  wrappers :func:`fused_res_chain` (transposes at the chain's ends) and
  :func:`fused_res_block` (K=1);
* row-major ``(B*H*W, C)``, which is NHWC memory: :func:`fused_res_chain_rows`
  and :func:`fused_res_chain_nhwc`.  The folded forward runs all six chains
  through this one.

Each wrapper launches the kernel for a CUDA tensor and takes the plain
PyTorch version (:func:`res_chain_cf_plain`, :func:`res_chain_rows_plain`)
only for a CPU tensor; anything else raises.  The plain version has the
kernel's rounding points: sums in fp32, ``h1``, ``h2`` and ``y`` rounded to
the input dtype, weights cast to the input dtype, biases kept in fp32.

:data:`LAUNCHES` counts kernel launches per wrapper, so that a run can show
that it went through the kernel; it is process-wide state, reset with
:func:`reset_launch_counts`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yolofastest_torch.utils.device import exact_fp32

LAUNCHES: Dict[str, int] = {"res_chain_cf": 0, "res_chain_rows": 0}

CHUNK = 16  # inner channels per kernel pass (kChunk in csrc/res_chain.cu)
SMEM_BUDGET = 100 * 1024  # shared memory per block: two blocks fit on one SM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ------------------------------------------------------------- plain version
def _chain_plain_nchw(x, w1, b1, w2, b2, w3, b3):
    """K blocks on an NCHW tensor with the kernel's rounding points."""
    dt = x.dtype
    f32 = torch.float32
    inner = w1.shape[2]
    with exact_fp32():
        for k in range(w1.shape[0]):
            xf = x.to(f32)
            h1 = F.conv2d(xf, w1[k].to(dt).to(f32).t()[:, :, None, None])
            h1 = torch.relu(h1 + b1[k].to(f32)[:, None, None]).to(dt)
            h2 = F.conv2d(h1.to(f32), w2[k].to(dt).to(f32).permute(2, 0, 1)[:, None],
                          padding=1, groups=inner)
            h2 = torch.relu(h2 + b2[k].to(f32)[:, None, None]).to(dt)
            h3 = F.conv2d(h2.to(f32), w3[k].to(dt).to(f32).t()[:, :, None, None])
            x = (h3 + b3[k].to(f32)[:, None, None] + xf).to(dt)
    return x


def res_chain_cf_plain(x_cf, w1, b1, w2, b2, w3, b3, hw: Tuple[int, int]):
    """Plain PyTorch version of the channels-first chain (any device)."""
    c, total = x_cf.shape
    h, w = hw
    b = total // (h * w)
    x = x_cf.reshape(c, b, h, w).permute(1, 0, 2, 3)
    y = _chain_plain_nchw(x, w1, b1, w2, b2, w3, b3)
    return y.permute(1, 0, 2, 3).reshape(c, total)


def res_chain_rows_plain(x_rows, w1, b1, w2, b2, w3, b3, hw: Tuple[int, int]):
    """Plain PyTorch version of the row-major chain (any device)."""
    total, c = x_rows.shape
    h, w = hw
    b = total // (h * w)
    x = x_rows.reshape(b, h, w, c).permute(0, 3, 1, 2)
    y = _chain_plain_nchw(x, w1, b1, w2, b2, w3, b3)
    return y.permute(0, 2, 3, 1).reshape(total, c)


# -------------------------------------------------------------------- kernel
def smem_bytes(h: int, w: int, c: int, k: int, tile_h: int, tile_w: int) -> int:
    """Shared memory of one thread block (``smem_bytes`` in csrc/res_chain.cu)."""
    plane = min(h, tile_h + 2 * k) * min(w, tile_w + 2 * k) | 1
    return 4 * (2 * c + CHUNK) * plane


@functools.lru_cache(maxsize=None)
def pick_tile(h: int, w: int, c: int, k: int) -> Tuple[int, int]:
    """Output tile (rows, cols) of one thread block.

    Among the tiles whose shared memory fits :data:`SMEM_BUDGET`, the one
    that makes the least work: tiles per image times the pixels of block 0's
    region (the tile plus its K-pixel halo, clipped to the image).
    """
    best = None
    for th in sorted({*range(1, min(h, 64) + 1), h}):
        for tw in sorted({*range(1, min(w, 64) + 1), w}):
            if smem_bytes(h, w, c, k, th, tw) > SMEM_BUDGET:
                continue
            tiles = -(-h // th) * -(-w // tw)
            cost = tiles * min(h, th + 2 * k) * min(w, tw + 2 * k)
            if best is None or cost < best[0]:
                best = (cost, th, tw)
    if best is None:
        raise ValueError(f"no tile of a ({h}, {w}) plane with C={c}, K={k} fits "
                         f"{SMEM_BUDGET} bytes of shared memory")
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    from yolofastest_torch.kernels import _build

    lib = _build.load("res_chain")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.yf_res_chain.argtypes = [ci, ci] + [vp] * 8 + [ci] * 8 + [vp]
    lib.yf_res_chain.restype = ci
    lib.yf_res_chain_chunk.argtypes = []
    lib.yf_res_chain_chunk.restype = ci
    lib.yf_cuda_error_string.argtypes = [ci]
    lib.yf_cuda_error_string.restype = ctypes.c_char_p
    if lib.yf_res_chain_chunk() != CHUNK:
        raise RuntimeError("res_chain.cu and res_block.py disagree on CHUNK")
    return lib


def _launch(rows: bool, x, w1, b1, w2, b2, w3, b3, hw):
    h, w = hw
    k, c, inner = w1.shape
    b = x.numel() // (c * h * w)
    tile_h, tile_w = pick_tile(h, w, c, k)
    out = torch.empty_like(x)
    lib = _lib()
    rc = lib.yf_res_chain(
        _DTYPES[x.dtype], int(rows), x.data_ptr(), out.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), b, h, w, c, inner, k, tile_h, tile_w,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"res_chain kernel launch failed: "
                           f"{lib.yf_cuda_error_string(rc).decode()} (code {rc})")
    LAUNCHES["res_chain_rows" if rows else "res_chain_cf"] += 1
    return out


def _prepare(x, c: int, total: int, hw, weights):
    """Check the arguments and cast as the Pallas wrappers do: weights to
    x's dtype, biases to fp32, all contiguous on x's device."""
    h, w = hw
    if total % (h * w):
        raise ValueError(f"{total} pixels is not a whole number of {h}x{w} images")
    if x.dtype not in _DTYPES:
        raise TypeError(f"res chain takes float32 or bfloat16, not {x.dtype}")
    w1, b1, w2, b2, w3, b3 = weights
    k, _, inner = w1.shape
    shapes = {"w1": (w1, (k, c, inner)), "b1": (b1, (k, inner)),
              "w2": (w2, (k, 3, 3, inner)), "b2": (b2, (k, inner)),
              "w3": (w3, (k, inner, c)), "b3": (b3, (k, c))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
    dev = x.device
    return tuple(
        t.to(device=dev, dtype=x.dtype if i % 2 == 0 else torch.float32).contiguous()
        for i, t in enumerate(weights))


def _dispatch(rows: bool, x, weights, hw):
    if x.device.type == "cpu":
        plain = res_chain_rows_plain if rows else res_chain_cf_plain
        return plain(x, *weights, hw)
    if x.device.type != "cuda":
        raise RuntimeError(f"res chain runs on cuda (kernel) or cpu (plain "
                           f"version), not {x.device}")
    return _launch(rows, x.contiguous(), *weights, hw)


# ---------------------------------------------------------- public functions
def fused_res_chain_cf(x_cf, w1, b1, w2, b2, w3, b3, hw: Tuple[int, int]):
    """K chained res blocks on a channels-first plane.

    Args:
      x_cf: (C, B*H*W) float32 or bfloat16, the batch folded into pixels.
      w1: (K, C, I); b1: (K, I); w2: (K, 3, 3, I); b2: (K, I);
      w3: (K, I, C); b3: (K, C).
      hw: (H, W) of one image.
    """
    c, total = x_cf.shape
    weights = _prepare(x_cf, c, total, hw, (w1, b1, w2, b2, w3, b3))
    return _dispatch(False, x_cf, weights, hw)


def fused_res_chain(x, w1, b1, w2, b2, w3, b3):
    """NHWC wrapper of :func:`fused_res_chain_cf`: (B, H, W, C) -> same,
    transposed to channels-first at the chain's two ends."""
    b, h, w, c = x.shape
    x_cf = x.permute(3, 0, 1, 2).reshape(c, b * h * w)
    y = fused_res_chain_cf(x_cf, w1, b1, w2, b2, w3, b3, (h, w))
    return y.reshape(c, b, h, w).permute(1, 2, 3, 0)


def fused_res_block(x, w1, b1, w2, b2, w3, b3):
    """Single-block convenience wrapper (a K=1 chain)."""
    return fused_res_chain(x, w1[None], b1[None], w2[None], b2[None],
                           w3[None], b3[None])


def fused_res_chain_rows(x_rows, w1, b1, w2, b2, w3, b3, hw: Tuple[int, int]):
    """K chained res blocks on a row-major plane: x_rows is (B*H*W, C),
    NHWC memory.  Weights as in :func:`fused_res_chain_cf`."""
    total, c = x_rows.shape
    weights = _prepare(x_rows, c, total, hw, (w1, b1, w2, b2, w3, b3))
    return _dispatch(True, x_rows, weights, hw)


def fused_res_chain_nhwc(x, w1, b1, w2, b2, w3, b3):
    """NHWC wrapper of :func:`fused_res_chain_rows`: no transposes, only a
    free collapse to (B*H*W, C)."""
    b, h, w, c = x.shape
    y = fused_res_chain_rows(x.contiguous().reshape(b * h * w, c),
                             w1, b1, w2, b2, w3, b3, (h, w))
    return y.reshape(b, h, w, c)


def chain_weights_from_folded(folded, names: Sequence[str]):
    """Stack (w1, b1, w2, b2, w3, b3) for a same-shape chain of res blocks
    from a ``fold_batchnorm`` tree (``res*/conv1..conv3`` layers, HWIO)."""
    w1, b1, w2, b2, w3, b3 = [], [], [], [], [], []
    for name in names:
        p1 = folded[f"{name}/conv1"]
        p2 = folded[f"{name}/conv2"]
        p3 = folded[f"{name}/conv3"]
        w1.append(np.asarray(p1["kernel"]).reshape(p1["kernel"].shape[2:]))
        b1.append(np.asarray(p1["bias"]))
        w2.append(np.asarray(p2["kernel"]).reshape(3, 3, -1))
        b2.append(np.asarray(p2["bias"]))
        w3.append(np.asarray(p3["kernel"]).reshape(p3["kernel"].shape[2:]))
        b3.append(np.asarray(p3["bias"]))
    return tuple(np.stack(a) for a in (w1, b1, w2, b2, w3, b3))
