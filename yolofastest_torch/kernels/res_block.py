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

Each wrapper calls a registered operator, ``yolofastest::res_chain_cf`` or
``yolofastest::res_chain_rows`` (:data:`CHAIN_OPS`), which launches the
kernel for a CUDA tensor and takes the plain PyTorch version
(:func:`res_chain_cf_plain`, :func:`res_chain_rows_plain`) only for a CPU
tensor; anything else raises.  The operators have fake (shape-only)
versions, so ``torch.export`` records each chain as one node.  The plain version has the
kernel's rounding points: sums in fp32, ``h1``, ``h2`` and ``y`` rounded to
the input dtype, weights cast to the input dtype, biases kept in fp32.

:data:`LAUNCHES` (from ``_build``, shared by every kernel of the port) counts
kernel launches per wrapper, so that a run can show that it went through the
kernel; it is process-wide state, reset with :func:`reset_launch_counts`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from yolofastest_torch.kernels._build import LAUNCHES, reset_launch_counts
from yolofastest_torch.utils.device import exact_fp32

# The kernel's fixed shape (csrc/res_chain.cu): 8 warps; each warp keeps
# ACC_TILES (16 x 8) projection tiles in registers, so a block's output
# region holds at most 16 * WARPS * max(1, ACC_TILES // n-tiles of C) pixels.
WARPS = 8
ACC_TILES = 8
SMEM_BUDGET = 113 * 1024  # shared memory per block: two blocks on one SM (228 KB)
# What two blocks on one SM get done, in units of one block alone there: the
# cost model of pick_tile (a lone block leaves part of the SM idle).
PAIR_RATE = 1.5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PROJ_TILES = ((8, 1), (16, 2), (24, 3), (48, 6))  # C up to .. -> 8-column tiles


# ------------------------------------------------------------- plain version
def _chain_plain_nchw(x, w1, b1, w2, b2, w3, b3):
    """K blocks on an NCHW tensor with the kernel's rounding points."""
    dt = x.dtype
    f32 = torch.float32
    inner = w1.shape[2]
    # every block's conv weights (OIHW) and biases (C, 1, 1) at once: a trace of
    # the chain (export/mlir.py, export/generic_onnx.py) then holds a third of
    # the nodes
    w1, w3 = (w.to(dt).to(f32).transpose(1, 2)[..., None, None] for w in (w1, w3))
    w2 = w2.to(dt).to(f32).permute(0, 3, 1, 2)[:, :, None]
    b1, b2, b3 = (b.to(f32)[..., None, None] for b in (b1, b2, b3))
    with exact_fp32():
        for k in range(w1.shape[0]):
            xf = x.to(f32)
            h1 = torch.relu(F.conv2d(xf, w1[k]) + b1[k]).to(dt)
            h2 = torch.relu(F.conv2d(h1.to(f32), w2[k], padding=1, groups=inner) + b2[k]).to(dt)
            x = (F.conv2d(h2.to(f32), w3[k]) + b3[k] + xf).to(dt)
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


def res_chain_float64(x, w1, b1, w2, b2, w3, b3):
    """The chain on an NHWC tensor in float64 on the CPU, with no rounding
    points: the exact function, as near as float64 gets.  Only a precision
    reference for checks; the plain versions above stay the kernel's oracle."""
    f64 = torch.float64
    x = x.detach().to("cpu", f64).permute(0, 3, 1, 2)
    w1, b1, w2, b2, w3, b3 = (t.detach().to("cpu", f64) for t in (w1, b1, w2, b2, w3, b3))
    for k in range(w1.shape[0]):
        h1 = torch.relu(F.conv2d(x, w1[k].t()[:, :, None, None]) + b1[k][:, None, None])
        h2 = F.conv2d(h1, w2[k].permute(2, 0, 1)[:, None], padding=1, groups=w1.shape[2])
        h2 = torch.relu(h2 + b2[k][:, None, None])
        x = F.conv2d(h2, w3[k].t()[:, :, None, None]) + b3[k][:, None, None] + x
    return x.permute(0, 2, 3, 1)


# -------------------------------------------------------------------- kernel
def _proj_tiles(c: int) -> int:
    for widest, tiles in _PROJ_TILES:
        if c <= widest:
            return tiles
    raise ValueError(f"the res chain kernel takes C <= {_PROJ_TILES[-1][0]}, not {c}")


def max_out_pixels(c: int) -> int:
    """Pixels a block's output region may hold at width C."""
    return 16 * WARPS * max(1, ACC_TILES // _proj_tiles(c))


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def _weight_ld(n: int) -> int:
    return n if n % 16 == 8 else n + 8


def smem_bytes(h: int, w: int, c: int, k: int, tile_h: int, tile_w: int, nc: int,
               itemsize: int = 4, cluster: int = 1) -> int:
    """Shared memory of one thread block (``make_layout`` in csrc/res_chain.cu):
    the x plane, one chunk of h1 on it, one chunk of h2 on block 0's output
    region, in a cluster the partial projection sums there, all fp32, and two
    buffers of one chunk's weights."""
    depth, pad = (8, 4) if itemsize == 4 else (16, 8)
    cp = -(-c // depth) * depth
    cn = 8 * _proj_tiles(c)
    plane = min(h, tile_h + 2 * k) * min(w, tile_w + 2 * k)
    out = min(h, tile_h + 2 * (k - 1)) * min(w, tile_w + 2 * (k - 1))
    h1_row = nc + 4 if nc == 16 else nc + 8
    planes = _r16(4 * plane * (cp + pad)) + _r16(4 * plane * h1_row) + _r16(4 * out * (nc + pad))
    if cluster > 1:
        planes += _r16(4 * out * c)
    wbuf = (_r16(itemsize * cp * _weight_ld(nc)) + _r16(itemsize * nc * _weight_ld(cn))
            + _r16(itemsize * 9 * nc) + 2 * _r16(4 * nc))
    return planes + 2 * wbuf


@functools.lru_cache(maxsize=None)
def pick_tile(h: int, w: int, c: int, i: int, k: int, batch: int = 1, n_sm: int = 132,
              itemsize: int = 4) -> Tuple[int, int, int, int]:
    """Output tile (rows, cols) of one thread block, its inner chunk width and
    the CTAs of a cluster that share it.

    A block's time is taken as the pixels of block 0's region (the tile plus
    its K-pixel halo, clipped to the image), the whole launch's as the larger
    of one block's time and the work of all blocks over ``n_sm`` SMs that run
    two blocks each at :data:`PAIR_RATE`.  So at a small batch smaller tiles
    fill the card as long as their halo recompute costs less than idle SMs,
    and at a large batch the tile with the least total work wins.  Among the
    tiles whose output region fits the projection's registers and whose
    shared memory fits :data:`SMEM_BUDGET`, the cheapest, then the one with
    the fewest blocks; its chunk is 32 inner channels where that fits, else 16.
    Where the tiles still leave the card with fewer than two blocks per SM
    and C is a multiple of 4, clusters of 4 or 2 CTAs split each tile's
    chunks (at most one CTA per chunk).
    """
    limit = max_out_pixels(c)
    best = None
    for th in sorted({*range(1, min(h, 64) + 1), h}):
        for tw in sorted({*range(1, min(w, 64) + 1), w}):
            if min(h, th + 2 * (k - 1)) * min(w, tw + 2 * (k - 1)) > limit:
                continue
            if smem_bytes(h, w, c, k, th, tw, 16, itemsize) > SMEM_BUDGET:
                continue
            blocks = batch * -(-h // th) * -(-w // tw)
            region = min(h, th + 2 * k) * min(w, tw + 2 * k)
            cost = (max(region, blocks * region / (PAIR_RATE * n_sm)), blocks)
            if best is None or cost < best[0]:
                best = (cost, th, tw)
    if best is None:
        raise ValueError(f"no tile of a ({h}, {w}) plane with C={c}, K={k} fits "
                         f"{SMEM_BUDGET} bytes of shared memory")
    _, th, tw = best
    nc = 32 if i > 16 and smem_bytes(h, w, c, k, th, tw, 32, itemsize) <= SMEM_BUDGET else 16
    blocks = batch * -(-h // th) * -(-w // tw)
    for cluster in (4, 2, 1):
        if cluster == 1 or (c % 4 == 0 and cluster <= -(-i // nc) and blocks * cluster <= 2 * n_sm
                            and smem_bytes(h, w, c, k, th, tw, nc, itemsize, cluster)
                            <= SMEM_BUDGET):
            return th, tw, nc, cluster


# Shapes at which _lib() holds smem_bytes and max_out_pixels against the
# library's own arithmetic: (H, W, C, K, tile_h, tile_w, nc, cluster).
_LAYOUT_CHECKS = ((128, 160, 4, 1, 20, 20, 16, 1), (64, 80, 8, 2, 9, 11, 32, 1),
                  (32, 40, 16, 4, 3, 3, 32, 2), (16, 20, 24, 4, 16, 20, 16, 1),
                  (8, 10, 48, 5, 8, 10, 32, 4), (13, 17, 48, 5, 13, 17, 16, 2))


def bind_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded ``csrc/res_chain.cu`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.yf_res_chain.argtypes = [ci, ci] + [vp] * 8 + [ci] * 10 + [vp]
    lib.yf_res_chain.restype = ci
    lib.yf_res_chain_smem.argtypes = [ci] * 9
    lib.yf_res_chain_smem.restype = ctypes.c_longlong
    lib.yf_res_chain_max_out.argtypes = [ci]
    lib.yf_res_chain_max_out.restype = ci
    lib.yf_cuda_error_string.argtypes = [ci]
    lib.yf_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    from yolofastest_torch.kernels import _build

    lib = bind_signatures(_build.load("res_chain"))
    for itemsize in (4, 2):
        for h, w, c, k, th, tw, nc, cl in _LAYOUT_CHECKS:
            if lib.yf_res_chain_smem(itemsize, h, w, c, k, th, tw, nc, cl) != smem_bytes(
                    h, w, c, k, th, tw, nc, itemsize, cl):
                raise RuntimeError("res_chain.cu and res_block.py disagree on shared memory")
    for widest, _ in _PROJ_TILES:
        if lib.yf_res_chain_max_out(widest) != max_out_pixels(widest):
            raise RuntimeError("res_chain.cu and res_block.py disagree on the region limit")
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(rows: bool, x, w1, b1, w2, b2, w3, b3, hw):
    h, w = hw
    k, c, inner = w1.shape
    b = x.numel() // (c * h * w)
    tile_h, tile_w, nc, cluster = pick_tile(h, w, c, inner, k, b, _sm_count(x.device.index),
                                            x.element_size())
    out = torch.empty_like(x)
    lib = _lib()
    rc = lib.yf_res_chain(
        _DTYPES[x.dtype], int(rows), x.data_ptr(), out.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), b, h, w, c, inner, k, tile_h, tile_w, nc, cluster,
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


# --------------------------------------------------------- registered operators
# The two layouts as operators of the ``yolofastest`` namespace: the kernel on
# the card, the plain version on the CPU, and a fake (shape-only) version, so
# that torch.export records a chain as one node and a saved program launches
# the kernel.  No autograd formula: every caller runs under no_grad on folded
# weights.
_OPS = torch.library.Library("yolofastest", "FRAGMENT")
_CHAIN_ARGS = ("(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, Tensor b3, "
               "int h, int w) -> Tensor")


def _chain_cuda(rows: bool):
    def impl(x, w1, b1, w2, b2, w3, b3, h, w):
        return _launch(rows, x.contiguous(), w1, b1, w2, b2, w3, b3, (h, w))
    return impl


def _chain_cpu(plain):
    def impl(x, w1, b1, w2, b2, w3, b3, h, w):
        return plain(x, w1, b1, w2, b2, w3, b3, (h, w))
    return impl


def _chain_fake(x, w1, b1, w2, b2, w3, b3, h, w):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


for _name, _rows, _plain in (("res_chain_cf", False, res_chain_cf_plain),
                             ("res_chain_rows", True, res_chain_rows_plain)):
    _OPS.define(_name + _CHAIN_ARGS)
    _OPS.impl(_name, _chain_cuda(_rows), "CUDA")
    _OPS.impl(_name, _chain_cpu(_plain), "CPU")
    torch.library.register_fake(f"yolofastest::{_name}", _chain_fake, lib=_OPS)
CHAIN_OPS = {False: torch.ops.yolofastest.res_chain_cf.default,
             True: torch.ops.yolofastest.res_chain_rows.default}


def _dispatch(rows: bool, x, weights, hw):
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"res chain runs on cuda (kernel) or cpu (plain "
                           f"version), not {x.device}")
    return CHAIN_OPS[rows](x, *weights, int(hw[0]), int(hw[1]))


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
