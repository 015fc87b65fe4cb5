"""The port's kernels: the res chains (``yolofastest_torch.kernels.res_block``)
and the NMS with its compaction (``yolofastest_torch.kernels.nms``).

On the CPU the wrappers run their plain PyTorch version; it is held against
the JAX package's Pallas kernels in interpret mode (run by the workers of
``tests/_jax_refs.py``), at the shapes of ``tests/test_kernels.py`` plus a
pruned width and a ragged plane.  The NMS
plain version in the kernel's formulation is held here against the greedy
loop and the argsort compaction over edge cases, and against the JAX
package in tests/test_torch_ops.py.
The tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card and skip without one.  JAX is imported inside the fixture that needs it, so
the ``cuda`` tests also run where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from yolofastest_torch.kernels import nms as tnms_kernel
from yolofastest_torch.kernels import res_block as rb
from yolofastest_torch.ops import nms as tnms

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


# the inputs of each layout's cases: _case(shape, seed, scale)
CASE_ARGS = {"cf": (0,), "rows": (1, 0.2)}


def _pallas(layout, shape):
    """The JAX package's Pallas chain kernel in interpret mode on the case of
    ``shape`` (the channels-first K1 or the row-major K2)."""
    from yolofastest_tpu.kernels import res_block as jrb

    fn = jrb.fused_res_chain if layout == "cf" else jrb.fused_res_chain_nhwc
    x, st = _case(shape, *CASE_ARGS[layout])
    return np.asarray(fn(x, *st, interpret=True))


for _layout, _shapes in (("cf", CF_SHAPES), ("rows", ROWS_SHAPES)):
    for _shape in _shapes:
        register(f"kernels/{_layout}{_shape}", _pallas, lambda l=_layout, s=_shape: (l, s))


@pytest.mark.parametrize("shape", CF_SHAPES)
def test_plain_cf_matches_pallas(shape, jax_refs):  # noqa: F811
    x, st = _case(shape, *CASE_ARGS["cf"])
    ref = jax_refs[f"kernels/cf{shape}"]
    got = rb.fused_res_chain(torch.from_numpy(x), *map(torch.from_numpy, st))
    # fp32, summation order only: the tolerance of tests/test_kernels.py:49
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", ROWS_SHAPES)
def test_plain_rows_matches_pallas(shape, jax_refs):  # noqa: F811
    x, st = _case(shape, *CASE_ARGS["rows"])
    ref = jax_refs[f"kernels/rows{shape}"]
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


def _nms_inputs(seed, b, k, n_cls=2, device="cpu", strided=True):
    """(boxes, conf, cls_score, cls_idx, valid) of :func:`_nms_case`, with
    boxes, conf and cls_score as views of one (B, K, 7) tensor, as decode
    gives them (row stride 7), unless ``strided`` is False."""
    boxes, cls, valid = _nms_case(seed, b, k, n_cls)
    rng = np.random.default_rng(seed + 1000)
    conf = -np.sort(-rng.random((b, k)).astype(np.float32), axis=1)
    score = rng.random((b, k)).astype(np.float32)
    rows = torch.from_numpy(np.concatenate(
        [boxes, conf[..., None], score[..., None], cls[..., None].astype(np.float32)], -1)).to(device)
    if not strided:
        rows = rows.contiguous()
        return (rows[..., 0:4].contiguous(), rows[..., 4].contiguous(), rows[..., 5].contiguous(),
                torch.from_numpy(cls).to(device), torch.from_numpy(valid).to(device))
    return (rows[..., 0:4], rows[..., 4], rows[..., 5], torch.from_numpy(cls).to(device),
            torch.from_numpy(valid).to(device))


def _nms_edge(name, device="cpu"):
    """One edge case, B=3, K=37: its inputs and threshold."""
    boxes, conf, score, cls, valid = _nms_inputs(11, 3, 37, device=device, strided=False)
    thr = 0.45
    if name == "thr0":  # any overlap suppresses; disjoint boxes (iou 0) do not
        thr = 0.0
    elif name == "thr1":  # iou > 1 never holds: nothing is suppressed
        thr = 1.0
    elif name == "all_invalid":
        valid[:] = False
    elif name == "one_class":
        cls[:] = 0
    elif name == "identical":  # iou 1: the first valid row of each class stays
        boxes[:] = torch.tensor([3.0, 4.0, 20.0, 17.0], device=device)
    elif name == "nan_corners":
        boxes[:, ::4, 1] = float("nan")
        boxes[1, 2::5, 2] = float("nan")
    elif name == "zero_area":  # 0 / 0 with pixel_offset 0: a NaN iou
        boxes[:, ::3, 2] = boxes[:, ::3, 0]
    return (boxes, conf, score, cls, valid), thr


NMS_EDGES = ["thr0", "thr1", "all_invalid", "one_class", "identical", "nan_corners", "zero_area"]
# (B, K) on the CPU: every B in {1, 3, 64} with every K in {1, 37, 128, 1024},
# but B=64 at K=1024, whose (B, K, K) IOU temporaries take GBs on the CPU
# (the card takes it: NMS_CUDA_BK).
NMS_CPU_BK = [(b, k) for b in (1, 3, 64) for k in (1, 37, 128, 1024) if (b, k) != (64, 1024)]
NMS_CUDA_BK = NMS_CPU_BK + [(64, 1024)]


def _max_dets(k):
    """max_det 1, 64, K and above K (K=1024: 64 and above K)."""
    return sorted({64, k + 7} if k > 128 else {1, 64, k, k + 7})


def _compaction(boxes, conf, cls_score, cls_idx, keep, max_det):
    """The stable argsort of ~keep and the gather of the packed rows, as
    ``batched_nms`` compacted before the kernel did."""
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :max_det]
    stacked = torch.cat([boxes, conf[..., None], cls_score[..., None],
                         cls_idx.to(torch.float32)[..., None],
                         keep.to(torch.float32)[..., None]], dim=-1)
    return torch.gather(stacked, 1, order[..., None].expand(-1, -1, 8))


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _check_packed_plain(args, thr, offsets=(0.0, 1.0)):
    """nms_packed_plain against the greedy loop and the argsort compaction,
    every pixel offset and max_det."""
    boxes, conf, score, cls, valid = args
    for off in offsets:
        want_keep = tnms_kernel.nms_keep_plain(boxes, cls, valid, thr, off)
        for max_det in _max_dets(valid.shape[1]):
            packed, keep = tnms_kernel.nms_packed_plain(*args, thr, max_det, off)
            assert torch.equal(keep, want_keep), (off, max_det)
            assert _same_bits(packed, _compaction(boxes, conf, score, cls, want_keep, max_det)), \
                (off, max_det)


@pytest.mark.parametrize("b,k", NMS_CPU_BK)
def test_nms_packed_plain_matches_loop(b, k):
    """Word layout, scan, ranks and places of the kernel's formulation give
    the greedy loop's mask and the argsort compaction's rows, bit for bit."""
    _check_packed_plain(_nms_inputs(b * 7 + k, b, k), 0.45)


@pytest.mark.parametrize("name", NMS_EDGES)
def test_nms_packed_plain_edge_cases(name):
    args, thr = _nms_edge(name)
    _check_packed_plain(args, thr)
    if name == "all_invalid":
        packed, keep = tnms_kernel.nms_packed_plain(*args, thr, 64)
        assert not keep.any() and not packed[..., 7].any()
    if name == "identical":
        keep = tnms_kernel.nms_packed_plain(*args, thr, 64)[1]
        assert (keep.sum(1) <= 2).all()


@pytest.mark.parametrize("what", ["corners", "cls_shape", "valid_1d", "k_over_max", "k_zero",
                                  "max_det_0", "cls_int64", "meta"])
def test_nms_wrappers_raise(what):
    """The checks that run before the kernel or its plain version, on the CPU."""
    boxes, conf, score, cls, valid = _nms_inputs(5, 2, 40, strided=False)
    max_det, error, match = 64, ValueError, "want boxes"
    if what == "corners":
        boxes = boxes[..., :3]
    elif what == "cls_shape":
        cls = cls[:, :39]
    elif what == "valid_1d":
        valid = valid[0]
    elif what in ("k_over_max", "k_zero"):
        k = tnms_kernel.MAX_ROWS + 1 if what == "k_over_max" else 0
        boxes, conf, score, cls, valid = _nms_inputs(5, 2, k, strided=False)
        match = "at most 1024"
    elif what == "max_det_0":
        max_det, match = 0, "max_det"
    elif what == "cls_int64":
        cls, error, match = cls.long(), TypeError, "cls_idx must be torch.int32"
    elif what == "meta":
        boxes, conf, score, cls, valid = (t.to("meta") for t in (boxes, conf, score, cls, valid))
        error, match = RuntimeError, "cuda"
    before = dict(rb.LAUNCHES)
    with pytest.raises(error, match=match):
        tnms_kernel.nms_packed(boxes, conf, score, cls, valid, 0.45, max_det)
    if what != "max_det_0":
        with pytest.raises(error, match=match):
            tnms_kernel.nms_keep(boxes, cls, valid, 0.45)
    assert rb.LAUNCHES == before


def test_nms_packed_on_cpu_is_the_plain_version():
    args = _nms_inputs(6, 3, 50)
    before = dict(rb.LAUNCHES)
    packed, keep = tnms_kernel.nms_packed(*args, 0.45, 20)
    want_packed, want_keep = tnms_kernel.nms_packed_plain(*args, 0.45, 20)
    assert _same_bits(packed, want_packed) and torch.equal(keep, want_keep)
    assert packed.shape == (3, 20, 8) and packed.is_contiguous()
    # batched_nms: the packed rows, and the dict built from them and keep
    assert _same_bits(tnms.batched_nms(*args, iou_thre=0.45, max_det=20, packed=True), packed)
    d = tnms.batched_nms(*args, iou_thre=0.45, max_det=20)
    assert torch.equal(d["count"], keep.sum(1).clamp(0, 20).to(torch.int32))
    assert torch.equal(d["valid"], packed[..., 7] > 0.5)
    assert rb.LAUNCHES == before  # no kernel on the CPU


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
        before = rb.LAUNCHES["nms"]
        got = tnms_kernel.nms_keep(boxes, cls, valid, 0.45, pixel_offset)
        assert rb.LAUNCHES["nms"] == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", NMS_CUDA_BK)
@pytest.mark.parametrize("strided", [True, False])
def test_nms_packed_kernel_matches_plain(cuda_device, b, k, strided):
    """Bit for bit on the card: packed rows and keep against nms_packed_plain
    (and keep against the greedy loop), from decode's strided views and from
    contiguous tensors, every pixel offset and max_det."""
    args = _nms_inputs(b * 7 + k, b, k, device=cuda_device, strided=strided)
    boxes, conf, score, cls, valid = args
    for off in (0.0, 1.0):
        loop = tnms_kernel.nms_keep_plain(boxes, cls, valid, 0.45, off)
        for max_det in _max_dets(k):
            before = rb.LAUNCHES["nms"]
            packed, keep = tnms_kernel.nms_packed(*args, 0.45, max_det, off)
            assert rb.LAUNCHES["nms"] == before + 1
            want_packed, want_keep = tnms_kernel.nms_packed_plain(*args, 0.45, max_det, off)
            torch.cuda.synchronize()
            assert torch.equal(keep, want_keep) and torch.equal(keep, loop), (off, max_det)
            assert _same_bits(packed, want_packed), (off, max_det)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NMS_EDGES)
def test_nms_packed_kernel_edge_cases(cuda_device, name):
    args, thr = _nms_edge(name, cuda_device)
    for off in (0.0, 1.0):
        for max_det in _max_dets(37):
            packed, keep = tnms_kernel.nms_packed(*args, thr, max_det, off)
            want_packed, want_keep = tnms_kernel.nms_packed_plain(*args, thr, max_det, off)
            torch.cuda.synchronize()
            assert torch.equal(keep, want_keep) and _same_bits(packed, want_packed), (off, max_det)


@pytest.mark.cuda
def test_batched_nms_is_one_launch(cuda_device):
    """One batched_nms call on the card is one kernel launch: the launch
    count, and the profiler's device events between two marker kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]

    args = _nms_inputs(3, 64, 128, device=cuda_device)
    tnms.batched_nms(*args, iou_thre=0.45, packed=True)  # built and warm
    markers = set(device_kernels(lambda: torch.cuda._sleep(1000)))
    before = rb.LAUNCHES["nms"]

    def marked():
        torch.cuda._sleep(1000)
        tnms.batched_nms(*args, iou_thre=0.45, packed=True)
        torch.cuda._sleep(1000)

    between = [name for name in device_kernels(marked) if name not in markers]
    assert rb.LAUNCHES["nms"] == before + 1
    assert len(between) == 1 and "nms_packed" in between[0], between


@pytest.mark.cuda
def test_nms_kernel_rejects_what_it_does_not_take(cuda_device):
    boxes, conf, score, cls, valid = _nms_inputs(4, 2, 40, device=cuda_device)
    with pytest.raises(ValueError, match="last stride"):
        tnms_kernel.nms_packed(boxes.transpose(1, 2).contiguous().transpose(1, 2), conf, score,
                               cls, valid, 0.45, 64)
    with pytest.raises(TypeError, match="valid"):
        tnms_kernel.nms_packed(boxes, conf, score, cls, valid.to(torch.uint8), 0.45, 64)
    with pytest.raises(ValueError, match="cpu"):
        tnms_kernel.nms_packed(boxes, conf.cpu(), score, cls, valid, 0.45, 64)
