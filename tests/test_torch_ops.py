"""The port's ops (preprocess, boxes, decode, NMS) against the JAX package's,
on the CPU, from the same numpy inputs."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolofastest_torch.configs import get_config
from yolofastest_torch.inference.detector import _merge_tta
from yolofastest_torch.kernels import nms as tnms_kernel
from yolofastest_torch.ops import boxes as tboxes
from yolofastest_torch.ops import decode as tdecode
from yolofastest_torch.ops import nms as tnms
from yolofastest_torch.ops import preprocess as tpre
from yolofastest_tpu.ops import boxes as jboxes
from yolofastest_tpu.ops import decode as jdecode
from yolofastest_tpu.ops import nms as jnms
from yolofastest_tpu.ops import preprocess as jpre

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

# The JAX references run jitted, as the JAX Detector runs them: one XLA
# program each instead of one compile per primitive, with the same bits.
# (preprocess_device stays op by op: XLA's fused (x - 128) / 255 rounds
# differently, and the port holds the eager bits; its integer steps are
# exact either way.)
_jgray = jax.jit(jpre.bgr_to_gray)
_jdown2x = jax.jit(jpre.downsample2x)
_jresize = jax.jit(jpre.resize_bilinear, static_argnums=(1,))
_jiou_matrix = jax.jit(jboxes.box_iou_matrix, static_argnums=(2,))
_jiou_pairwise = jax.jit(jboxes.iou_pairwise, static_argnums=(2,))
_jdecode = jax.jit(jdecode.decode_heads, static_argnums=(1, 2, 3, 4))
_jbatched_nms = jax.jit(jnms.batched_nms, static_argnames=("iou_thre", "max_det", "packed"))
_jkeep_mask = jax.jit(jnms.nms_keep_mask, static_argnums=(4, 5))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ----------------------------------------------------------------- preprocess
@pytest.mark.parametrize("src_hw", [(128, 192), (64, 96), (150, 190), (40, 50)],
                         ids=["2x", "same", "non2x-down", "up"])
def test_preprocess_bitwise(src_hw):
    """uint8 BGR -> gray -> resize -> normalise gives the same bits."""
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (2, *src_hw, 3), dtype=np.uint8)
    ours = tpre.preprocess_device(torch.from_numpy(bgr), (64, 96))
    theirs = jpre.preprocess_device(jnp.asarray(bgr), (64, 96))
    assert ours.shape == (2, 64, 96, 1) and ours.dtype == torch.float32
    np.testing.assert_array_equal(_np(ours), np.asarray(theirs))


def test_preprocess_steps_bitwise():
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (2, 30, 42, 3), dtype=np.uint8)
    gray = tpre.bgr_to_gray(torch.from_numpy(bgr))
    np.testing.assert_array_equal(_np(gray), np.asarray(_jgray(jnp.asarray(bgr))))
    g = _np(gray)
    np.testing.assert_array_equal(_np(tpre.downsample2x(gray)),
                                  np.asarray(_jdown2x(jnp.asarray(g))))
    for out_hw in [(17, 23), (45, 70)]:
        np.testing.assert_array_equal(
            _np(tpre.resize_bilinear(gray, out_hw)),
            np.asarray(_jresize(jnp.asarray(g), out_hw)))
    for dst in (7, 30, 61):
        for a, b in zip(tpre._cv2_linear_taps(30, dst), jpre._cv2_linear_taps(30, dst)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("out_hw", [(12, 20), (45, 70)], ids=["down", "up"])
def test_resize_float_path(out_hw):
    """Float inputs: antialiased bilinear vs jax.image.resize(linear); float32
    arithmetic in another order, so 1e-5 of the unit-range input."""
    rng = np.random.default_rng(2)
    img = rng.random((2, 30, 42)).astype(np.float32)
    ours = tpre.resize_bilinear(torch.from_numpy(img), out_hw)
    theirs = jpre.resize_bilinear(jnp.asarray(img), out_hw)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), atol=1e-5)


# ----------------------------------------------------------------------- boxes
@pytest.mark.parametrize("pixel_offset", [0.0, 1.0])
def test_iou_matrix(pixel_offset):
    rng = np.random.default_rng(3)
    xy = rng.integers(0, 50, (2, 9, 2)).astype(np.float32)
    wh = rng.integers(1, 30, (2, 9, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + wh], -1)
    ours = tboxes.box_iou_matrix(torch.from_numpy(b), torch.from_numpy(b), pixel_offset)
    theirs = _jiou_matrix(jnp.asarray(b), jnp.asarray(b), pixel_offset)
    # the same IEEE operations in the same order: equal bits
    np.testing.assert_array_equal(_np(ours), np.asarray(theirs))
    pair = tboxes.iou_pairwise(torch.from_numpy(b[0]), torch.from_numpy(b[1]), pixel_offset)
    np.testing.assert_array_equal(
        _np(pair), np.asarray(_jiou_pairwise(jnp.asarray(b[0]), jnp.asarray(b[1]),
                                             pixel_offset)))


def test_box_formats():
    rng = np.random.default_rng(4)
    b = rng.random((3, 5, 4)).astype(np.float32) * 100
    np.testing.assert_array_equal(_np(tboxes.xyxy2xywh(torch.from_numpy(b))),
                                  np.asarray(jboxes.xyxy2xywh(jnp.asarray(b))))
    np.testing.assert_array_equal(_np(tboxes.xywh2xyxy(torch.from_numpy(b))),
                                  np.asarray(jboxes.xywh2xyxy(jnp.asarray(b))))


# ---------------------------------------------------------------- decode + NMS
def _fixture_heads(res):
    fx = np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
    # the fixture logits are NCHW; the decode takes NHWC heads
    return [fx["logits_large"].transpose(0, 2, 3, 1), fx["logits_small"].transpose(0, 2, 3, 1)]


def _tie_heads():
    """All-zero logits but a fixed objectness: every candidate has the same
    conf (ties), sigmoid(0) = 0.5 and exp(0) = 1, so with the 33- and 13-pixel
    anchors the box corners land on exact .5 values (half-to-even)."""
    cfg = get_config("256x320").io
    heads = []
    for (h, w) in cfg.head_hw:
        a = np.zeros((2, h, w, cfg.num_out), np.float32)
        a[..., 4::8] = 1.0  # tobj of every anchor
        a[0, 0, 1, 8 + 4] = 3.0  # one higher-conf candidate in image 0
        heads.append(a)
    return heads


@functools.lru_cache(maxsize=None)
def _decode_both(case):
    """Both decodes of one case's heads, computed once per test module: the
    decode and NMS tests share them (the JAX decode, op by op, is the slow
    part).  Returns the case's preset and the two candidate sets."""
    res = "256x320" if case == "ties" else case
    heads = _tie_heads() if case == "ties" else _fixture_heads(case)
    io = get_config(res).io
    ours = tdecode.decode_heads([torch.from_numpy(h) for h in heads], io.anchors,
                                io.input_hw, io.conf_thre, io.max_decode)
    theirs = _jdecode([jnp.asarray(h) for h in heads], io.anchors,
                      io.input_hw, io.conf_thre, io.max_decode)
    return res, [_np(t) for t in ours], [np.asarray(t) for t in theirs]


@pytest.mark.parametrize("case", ["256x320", "512x640", "ties"])
def test_decode_heads_matches(case):
    _, ours, theirs = _decode_both(case)
    (ob, oc, os_, oi, ov), (jb, jc, js, ji, jv) = ours, theirs
    # equal candidate sets in equal order: same valid mask, boxes, classes
    np.testing.assert_array_equal(ov, jv)
    np.testing.assert_array_equal(ob, jb)
    np.testing.assert_array_equal(oi, ji)
    # sigmoid may differ by an ulp between XLA and torch
    np.testing.assert_allclose(oc, jc, rtol=1e-6, atol=0)
    np.testing.assert_allclose(os_, js, rtol=1e-6, atol=0)
    if case == "ties":
        assert ov.all()  # 1200 candidates tie for 128 rows
        # image 1 keeps index order; rows 0 and 2 are cell (0, 0) with the
        # (10, 13) and (33, 23) anchors: corners 8 -+ 5, 8 -+ 6.5, 8 -+ 16.5
        # and 8 -+ 11.5, the .5 ones rounded half-to-even
        np.testing.assert_array_equal(ob[1, 0], [3, 2, 13, 14])
        np.testing.assert_array_equal(ob[1, 2], [-8, -4, 24, 20])
        assert oc[0, 0] == oc[0, 1] > oc[0, 2]  # one higher-conf candidate per scale leads


def test_round_half_to_even():
    v = np.array([-8.5, -7.5, -0.5, 0.5, 1.5, 2.5, 3.5, 100.5], np.float32)
    np.testing.assert_array_equal(_np(torch.round(torch.from_numpy(v))),
                                  np.asarray(jnp.round(jnp.asarray(v))))
    np.testing.assert_array_equal(_np(torch.round(torch.from_numpy(v))),
                                  [-8.0, -8.0, -0.0, 0.0, 2.0, 2.0, 4.0, 100.0])


def _nms_candidates(case):
    """The JAX decode's candidates of one case, and its preset; ``tta``: the
    256x320 fixture's four images merged in pairs as the TTA merge merges an
    image and its mirror (K=256)."""
    res, _, cand = _decode_both("256x320" if case == "tta" else case)
    cand = [torch.from_numpy(np.array(c)) for c in cand]
    if case == "tta":
        cand = list(_merge_tta(*cand, float(get_config(res).io.input_hw[1])))
    return get_config(res).io, cand


@pytest.mark.parametrize("case", ["256x320", "512x640", "tta", "ties"])
def test_batched_nms_packed_matches(case):
    """The same candidates (the JAX decode's) through both NMS: equal packed
    output bit for bit, kept rows first; the keep mask equal to the greedy
    loop's; and the dict form (built from the packed rows and keep) equal to
    the unpacked rows."""
    io, cand = _nms_candidates(case)
    ours = tnms.batched_nms(*cand, iou_thre=io.nms_thre, max_det=io.max_det, packed=True)
    theirs = np.asarray(_jbatched_nms(*(jnp.asarray(c.numpy()) for c in cand),
                                      iou_thre=io.nms_thre, max_det=io.max_det, packed=True))
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(_np(ours).view(np.int32), theirs.view(np.int32))
    _, keep = tnms_kernel.nms_packed_plain(*cand, io.nms_thre, io.max_det)
    np.testing.assert_array_equal(
        _np(keep), _np(tnms_kernel.nms_keep_plain(cand[0], cand[3], cand[4], io.nms_thre)))
    d = tnms.batched_nms(*cand, iou_thre=io.nms_thre, max_det=io.max_det)
    u = tnms.unpack_detections(theirs)
    for key in ("boxes", "conf", "cls_score", "cls_idx", "valid", "count"):
        np.testing.assert_array_equal(_np(d[key]), u[key])
    if case == "tta":
        assert keep.shape == (2, 256)


def test_nms_keep_mask_pixel_offset():
    """Random overlapping boxes of two classes, both IOU conventions."""
    rng = np.random.default_rng(5)
    k = 40
    xy = rng.integers(0, 60, (k, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + rng.integers(5, 40, (k, 2))], -1).astype(np.float32)
    conf = np.sort(rng.random(k).astype(np.float32))[::-1].copy()
    cls = rng.integers(0, 2, k).astype(np.int32)
    valid = rng.random(k) < 0.8
    for off in (0.0, 1.0):
        ours = tnms.nms_keep_mask(torch.from_numpy(b), torch.from_numpy(conf),
                                  torch.from_numpy(cls), torch.from_numpy(valid), 0.3, off)
        theirs = _jkeep_mask(jnp.asarray(b), jnp.asarray(conf), jnp.asarray(cls),
                             jnp.asarray(valid), 0.3, off)
        np.testing.assert_array_equal(_np(ours), np.asarray(theirs))
