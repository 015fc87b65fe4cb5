"""The port's kernels: the res chains (``yolofastest_torch.kernels.res_block``)
and the NMS keep mask (``yolofastest_torch.kernels.nms``).

On the CPU the wrappers run their plain PyTorch version; it is held against
the JAX package's Pallas kernels in interpret mode, at the shapes of
``tests/test_kernels.py`` plus a pruned width and a ragged plane (the NMS
plain version is held against the JAX package in tests/test_torch_ops.py).
The tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card and skip without one.  JAX is imported inside the fixture that needs it, so
the ``cuda`` tests also run where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from yolofastest_torch.kernels import nms as tnms_kernel
from yolofastest_torch.kernels import res_block as rb

# (B, K, H, W, C, I): tests/test_kernels.py's shapes, a pruned040 width
# (I=20) and a ragged plane (H=13, W=17).
CF_SHAPES = [(2, 1, 16, 20, 8, 32), (3, 2, 8, 10, 4, 8), (2, 3, 8, 12, 16, 48),
             (2, 2, 16, 20, 8, 20), (3, 2, 13, 17, 8, 32)]
ROWS_SHAPES = [(2, 2, 8, 10, 48, 224), (4, 1, 16, 20, 24, 136),
               (2, 2, 16, 20, 8, 20), (3, 5, 13, 17, 16, 48)]
# B=1 at the six main-path chain shapes (small tiles over many blocks), then
# multi-tile ragged planes at B=1 with ragged widths: C=4, I = 20, 60, 84,
# 136, and odd C and I (bf16 weights staged without 4-byte pairs).
CUDA_SHAPES = [(1, 1, 128, 160, 4, 8), (1, 2, 64, 80, 8, 32), (1, 2, 32, 40, 8, 48),
               (1, 4, 32, 40, 16, 96), (1, 4, 16, 20, 24, 136), (1, 5, 8, 10, 48, 224),
               (1, 1, 29, 37, 4, 20), (1, 2, 23, 31, 8, 60), (1, 4, 19, 27, 24, 84),
               (1, 3, 13, 17, 24, 136), (2, 2, 9, 11, 5, 17)]
# 4 ulp of bf16 (8 significant bits: one ulp is at most 2^-7 of the value)
BF16_TOL = 4 * 2.0 ** -7
# chip_smoke.py's FLOAT64_SLACK: where the plain version misses 1e-4 of
# float64, the kernel may be at most twice as far from float64
FLOAT64_SLACK = 2.0


@pytest.fixture(scope="module")
def jax_rb():
    pytest.importorskip("jax")
    from yolofastest_tpu.kernels import res_block

    return res_block


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _case(shape, seed, scale=0.3):
    b, k, h, w, c, i = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, c)) * 0.5).astype(np.float32)
    st = tuple((rng.standard_normal(s) * sc).astype(np.float32) for s, sc in (
        ((k, c, i), scale), ((k, i), 0.1), ((k, 3, 3, i), scale), ((k, i), 0.1),
        ((k, i, c), scale), ((k, c), 0.1)))
    return x, st


@pytest.mark.parametrize("shape", CF_SHAPES)
def test_plain_cf_matches_pallas(shape, jax_rb):
    x, st = _case(shape, 0)
    ref = np.asarray(jax_rb.fused_res_chain(x, *st, interpret=True))
    got = rb.fused_res_chain(torch.from_numpy(x), *map(torch.from_numpy, st))
    # fp32, summation order only: the tolerance of tests/test_kernels.py:49
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", ROWS_SHAPES)
def test_plain_rows_matches_pallas(shape, jax_rb):
    x, st = _case(shape, 1, scale=0.2)
    ref = np.asarray(jax_rb.fused_res_chain_nhwc(x, *st, interpret=True))
    got = rb.fused_res_chain_nhwc(torch.from_numpy(x), *map(torch.from_numpy, st))
    # fp32, summation order only: the tolerance of tests/test_kernels.py:74
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def _bf16(a):
    """Round float32 numpy values to bfloat16 (nearest, ties to even)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def test_plain_bf16_rounding_points():
    """bf16: weights rounded to bf16, biases fp32, sums in fp32, h1/h2/y
    rounded to bf16 -- the Pallas kernel's rounding points, written out in
    numpy float32."""
    b, k, h, w, c, i = 2, 3, 9, 11, 16, 40
    x, st = _case((b, k, h, w, c, i), 2)
    w1, b1, w2, b2, w3, b3 = st
    ref = _bf16(x)
    for j in range(k):
        h1 = _bf16(np.maximum(ref @ _bf16(w1[j]) + b1[j], 0))
        pad = np.pad(h1, ((0, 0), (1, 1), (1, 1), (0, 0)))
        acc = np.zeros_like(h1)
        for dy in range(3):
            for dx in range(3):
                acc = acc + pad[:, dy:dy + h, dx:dx + w] * _bf16(w2[j, dy, dx])
        h2 = _bf16(np.maximum(acc + b2[j], 0))
        ref = _bf16(h2 @ _bf16(w3[j]) + b3[j] + ref)
    got = rb.fused_res_chain_nhwc(torch.from_numpy(x).to(torch.bfloat16),
                                  *map(torch.from_numpy, st))
    assert got.dtype == torch.bfloat16
    # Summation order differs, so a sum that lands next to a rounding
    # boundary of bf16 (8 significant bits) can round the other way and carry
    # that one-ulp step through the later blocks: allow 4 ulp of max|y|.
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= BF16_TOL * np.abs(ref).max(), err


def test_float64_reference_matches_plain():
    """The float64 precision reference computes the chain the plain version
    computes: at a well-conditioned shape the two agree to fp32's tolerance."""
    x, st = _case((2, 3, 9, 11, 16, 40), 8)
    exact = rb.res_chain_float64(torch.from_numpy(x), *map(torch.from_numpy, st))
    plain = rb.fused_res_chain_nhwc(torch.from_numpy(x), *map(torch.from_numpy, st))
    assert exact.dtype == torch.float64 and exact.shape == x.shape
    np.testing.assert_allclose(plain.numpy(), exact.numpy(), rtol=1e-4, atol=1e-4)


def test_chain_weights_from_folded_matches_jax(jax_rb):
    rng = np.random.default_rng(3)
    c, i = 8, 20
    folded = {}
    for name in ("res2_1", "res2_2"):
        folded[f"{name}/conv1"] = {"kernel": rng.standard_normal((1, 1, c, i)).astype(np.float32),
                                   "bias": rng.standard_normal(i).astype(np.float32)}
        folded[f"{name}/conv2"] = {"kernel": rng.standard_normal((3, 3, 1, i)).astype(np.float32),
                                   "bias": rng.standard_normal(i).astype(np.float32)}
        folded[f"{name}/conv3"] = {"kernel": rng.standard_normal((1, 1, i, c)).astype(np.float32),
                                   "bias": rng.standard_normal(c).astype(np.float32)}
    ours = rb.chain_weights_from_folded(folded, ["res2_1", "res2_2"])
    theirs = jax_rb.chain_weights_from_folded(folded, ["res2_1", "res2_2"])
    assert [a.shape for a in ours] == [(2, c, i), (2, i), (2, 3, 3, i), (2, i), (2, i, c), (2, c)]
    for a, t in zip(ours, theirs):
        np.testing.assert_array_equal(a, t)


# (H, W, C, I, K) of the six chains at 256x320, at 512x640, then a ragged plane
PLANES = [(128, 160, 4, 8, 1), (64, 80, 8, 32, 2), (32, 40, 8, 48, 2), (32, 40, 16, 96, 4),
          (16, 20, 24, 136, 4), (8, 10, 48, 224, 5),
          (256, 320, 4, 8, 1), (128, 160, 8, 32, 2), (64, 80, 8, 48, 2), (64, 80, 16, 96, 4),
          (32, 40, 24, 136, 4), (16, 20, 48, 224, 5), (13, 17, 48, 136, 5)]
N_SM = 132  # an H100's SMs


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("plane", PLANES)
def test_pick_tile_fits_budget(plane, batch, itemsize):
    """Every chain plane at both resolutions (and a ragged one) gets a tile within the
    plane whose shared memory fits the budget and whose output region fits
    the projection's registers; at B=1 the res1-res3 planes fill the SMs."""
    h, w, c, i, k = plane
    th, tw, nc, cluster = rb.pick_tile(h, w, c, i, k, batch, N_SM, itemsize)
    assert 1 <= th <= h and 1 <= tw <= w and nc in (16, 32)
    assert cluster in (1, 2, 4) and cluster <= -(-i // nc)
    assert rb.smem_bytes(h, w, c, k, th, tw, nc, itemsize, cluster) <= rb.SMEM_BUDGET
    assert min(h, th + 2 * (k - 1)) * min(w, tw + 2 * (k - 1)) <= rb.max_out_pixels(c)
    if batch == 1 and h >= 32:
        assert -(-h // th) * -(-w // tw) >= min(N_SM, h * w)


def test_pick_tile_keeps_whole_plane_when_halo_covers_it():
    """res5 at 256x320: a 5-pixel halo covers the 8x10 plane, so smaller
    tiles only repeat work; one tile per image, and clusters of 4 CTAs split
    its inner chunks to reach the SMs (64 or 1 tiles on 132 SMs)."""
    assert rb.pick_tile(8, 10, 48, 224, 5, 64, N_SM, 4) == (8, 10, 32, 4)
    assert rb.pick_tile(8, 10, 48, 224, 5, 1, N_SM, 4) == (8, 10, 32, 4)
    # a full card takes no cluster
    assert rb.pick_tile(8, 10, 48, 224, 5, 256, N_SM, 4)[3] == 1


def test_kernel_rejects_wide_blocks():
    """The projection keeps at most 48 output channels in registers."""
    with pytest.raises(ValueError, match="C <= 48"):
        rb.pick_tile(8, 8, 64, 64, 1)


def test_cpu_takes_plain_version_and_counts_nothing():
    x, st = _case((1, 1, 6, 7, 4, 8), 4)
    before = dict(rb.LAUNCHES)
    y = rb.fused_res_block(torch.from_numpy(x), *(torch.from_numpy(a[0]) for a in st))
    assert y.shape == x.shape and rb.LAUNCHES == before


def test_other_device_raises():
    """Neither the kernel nor the plain version takes a tensor that is on
    neither the card nor the CPU."""
    x, st = _case((1, 1, 6, 7, 4, 8), 5)
    with pytest.raises(RuntimeError, match="cuda"):
        rb.fused_res_chain_nhwc(torch.from_numpy(x).to("meta"), *map(torch.from_numpy, st))


def test_bad_shapes_raise():
    x, st = _case((1, 2, 6, 7, 4, 8), 6)
    w1, b1, w2, b2, w3, b3 = map(torch.from_numpy, st)
    with pytest.raises(ValueError, match="w3"):
        rb.fused_res_chain_nhwc(torch.from_numpy(x), w1, b1, w2, b2, w3[:, :4, :], b3)
    with pytest.raises(ValueError, match="whole number"):
        rb.fused_res_chain_rows(torch.from_numpy(x).reshape(-1, 4)[:41], w1, b1, w2, b2,
                                w3, b3, (6, 7))


def _fp32_ratio(a, b):
    """Worst ratio of |a - b| to the fp32 tolerance 1e-4 rel+abs."""
    return float(np.max(np.abs(a - b) / (1e-4 + 1e-4 * np.abs(b))))


def _assert_fp32_close(got, ref, exact):
    """fp32 on both sides (TF32 off in the plain version): within 1e-4
    rel+abs of the plain version, summation order only.  A deep chain with
    large weights can amplify fp32 rounding until the plain version itself
    misses that against the float64 chain; there the kernel may be at most
    FLOAT64_SLACK times as far from float64 as the plain version is."""
    if _fp32_ratio(got, ref) <= 1.0:
        return
    r_plain, r_kern = _fp32_ratio(ref, exact), _fp32_ratio(got, exact)
    assert r_plain > 1.0 and r_kern <= FLOAT64_SLACK * r_plain, (
        f"kernel vs plain {_fp32_ratio(got, ref):.3g} of the tolerance; against float64: "
        f"plain {r_plain:.3g}, kernel {r_kern:.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [True, False])
@pytest.mark.parametrize("shape", CF_SHAPES + ROWS_SHAPES + [(3, 1, 13, 17, 4, 8)] + CUDA_SHAPES)
def test_cuda_kernel_matches_plain(shape, rows, dtype, cuda_device):
    x, st = _case(shape, 7)
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    wt = [torch.from_numpy(a).to(cuda_device) for a in st]
    b, h, w, c = x.shape
    before = dict(rb.LAUNCHES)
    if rows:
        got = rb.fused_res_chain_nhwc(xt, *wt)
        ref = rb.res_chain_rows_plain(xt.reshape(-1, c), *wt, (h, w)).reshape(x.shape)
    else:
        got = rb.fused_res_chain(xt, *wt)
        x_cf = xt.permute(3, 0, 1, 2).reshape(c, -1)
        ref = rb.res_chain_cf_plain(x_cf, *wt, (h, w)).reshape(c, b, h, w).permute(1, 2, 3, 0)
    torch.cuda.synchronize()
    key = "res_chain_rows" if rows else "res_chain_cf"
    assert rb.LAUNCHES[key] == before[key] + 1
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    if dtype == torch.float32:
        exact = rb.res_chain_float64(torch.from_numpy(x), *map(torch.from_numpy, st))
        _assert_fp32_close(got, ref, exact.numpy())
    else:
        # bf16: one-ulp rounding flips carried through K blocks, 4 ulp of max|y|
        assert np.abs(got - ref).max() <= BF16_TOL * np.abs(ref).max()


# ---------------------------------------------------------------- NMS kernel
def _nms_case(seed, b, k, n_cls=2):
    """Heavily overlapping boxes on a small field, conf-descending, with
    invalid rows among the valid ones."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 40, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.integers(1, 30, (b, k, 2))], -1).astype(np.float32)
    cls = rng.integers(0, n_cls, (b, k)).astype(np.int32)
    valid = rng.random((b, k)) < 0.85
    return boxes, cls, valid


def test_nms_keep_on_cpu_is_the_plain_version():
    boxes, cls, valid = (torch.from_numpy(a) for a in _nms_case(0, 3, 40))
    before = dict(rb.LAUNCHES)
    for off in (0.0, 1.0):
        got = tnms_kernel.nms_keep(boxes, cls, valid, 0.45, off)
        assert torch.equal(got, tnms_kernel.nms_keep_plain(boxes, cls, valid, 0.45, off))
    assert rb.LAUNCHES == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="want boxes"):
        tnms_kernel.nms_keep(boxes[..., :3], cls, valid, 0.45)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(1, 128), (64, 128), (2, 256), (3, 37), (5, 1024)])
@pytest.mark.parametrize("pixel_offset", [0.0, 1.0])
def test_nms_kernel_matches_plain(cuda_device, b, k, pixel_offset):
    """Bit for bit: the kernel's keep mask equals the plain loop's on the card."""
    for seed in range(4):
        boxes, cls, valid = (torch.from_numpy(a).to(cuda_device) for a in _nms_case(seed, b, k))
        before = rb.LAUNCHES["nms_keep"]
        got = tnms_kernel.nms_keep(boxes, cls, valid, 0.45, pixel_offset)
        assert rb.LAUNCHES["nms_keep"] == before + 1
        want = tnms_kernel.nms_keep_plain(boxes, cls, valid, 0.45, pixel_offset)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_nms_kernel_empty_and_all_invalid(cuda_device):
    boxes, cls, valid = (torch.from_numpy(a).to(cuda_device) for a in _nms_case(9, 4, 128))
    valid[1:] = False
    got = tnms_kernel.nms_keep(boxes, cls, valid, 0.45)
    assert torch.equal(got, tnms_kernel.nms_keep_plain(boxes, cls, valid, 0.45))
    assert not got[1:].any()
    with pytest.raises(ValueError, match="at most"):
        tnms_kernel.nms_keep(*(t.repeat(1, 9, *([1] * (t.ndim - 2))) for t in (boxes, cls, valid)),
                             0.45)
