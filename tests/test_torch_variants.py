"""The port's model variants and detection modes against the JAX package's,
on the CPU, from the same numpy inputs: the lite graph, pruning, flip TTA and
sliced detection."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import box_iou
from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from yolofastest_torch.configs import get_config
from yolofastest_torch.inference import Detector, detections_to_lists
from yolofastest_torch.inference import detector as tdetector
from yolofastest_torch.inference import sliced as tsliced
from yolofastest_torch.models import (Executor, fold_batchnorm, folded_apply_lite, load_variables,
                                      prune as tprune, torch_params_from_folded,
                                      unfold_to_variables, walk_topology_lite, zoo_path)
from yolofastest_torch.models.graph import RES_CHAINS
from yolofastest_tpu.configs import get_config as jget_config
from yolofastest_tpu.inference import Detector as JDetector
from yolofastest_tpu.inference import detector as jdetector
from yolofastest_tpu.inference import sliced as jsliced
from yolofastest_tpu.models import graph as jgraph
from yolofastest_tpu.models import prune as jprune

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PRUNED = os.path.join(ROOT, "weights", "yolofastest_pruned040_256x320.npz")


def _golden(res):
    return np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))


def _net(pre_imgs):
    return (pre_imgs.astype(np.float32)[..., None] - 128.0) / 255.0


def _recall_iou(rows, golden, thre=0.5, strict=True):
    """Golden boxes found by a detection of the same class with IoU > thre
    (>= thre where ``strict`` is False)."""
    found = 0
    for g in golden:
        ious = [box_iou(r[:4], g[1:5]) for r in rows[int(g[0])] if int(r[6]) == int(g[7])]
        found += any(v > thre if strict else v >= thre for v in ious)
    return found


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------------ lite
def _lite_inputs():
    return np.random.default_rng(0).uniform(-0.5, 0.5, (2, 64, 96, 1)).astype(np.float32)


def _jax_folded_apply_lite():
    """The JAX lite forward on :func:`_lite_inputs`, jitted, in a worker of
    tests/_jax_refs.py."""
    folded = fold_batchnorm(load_variables(zoo_path("lite_256x320")))
    return np.asarray(jax.jit(jgraph.folded_apply_lite)(jax.tree.map(jnp.asarray, folded),
                                                        jnp.asarray(_lite_inputs())))


register("variants/folded_apply_lite", _jax_folded_apply_lite)


def test_folded_apply_lite_matches_jax(jax_refs):  # noqa: F811
    """Real lite 256x320 weights on random 64x96 inputs, fp32 both sides, sums
    in another order: atol 1e-4.  The lite walk groups its 18 res blocks into
    the six chains of the full graph."""
    folded = fold_batchnorm(load_variables(zoo_path("lite_256x320")))
    params = torch_params_from_folded(folded, "cpu")
    ours = folded_apply_lite(params, torch.from_numpy(_lite_inputs()))
    theirs = jax_refs["variants/folded_apply_lite"]
    assert tuple(ours.shape) == theirs.shape == (2, 2, 3, 24)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-4)

    class Chains(Executor):
        def __init__(self):
            self.chains = []

        def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
            return x

        def head(self, x, name):
            return x

        def res_chain(self, x, names):
            self.chains.append(tuple(names))
            return x

    ex = Chains()
    walk_topology_lite(None, ex)
    assert ex.chains == list(RES_CHAINS)


@pytest.mark.parametrize("res", ["256x320", "512x640"])
def test_lite_golden_recall(res):
    """The lite zoo recovers >= 90% of the golden boxes (same class, IoU >
    0.5: tests/test_lite_zoo.py:48-58), through the port's Detector."""
    fx = _golden(res)
    cfg = get_config(f"lite-{res}")
    assert cfg.io.anchors == jget_config(f"lite-{res}").io.anchors
    assert len(cfg.io.anchors) == 1
    det = Detector(cfg, variables=load_variables(zoo_path(f"lite_{res}")), arch="lite",
                   device="cpu")
    rows = detections_to_lists(det.run(_net(fx["pre_imgs"])))
    assert _recall_iou(rows, fx["boxes"]) >= 0.9 * len(fx["boxes"])


def test_lite_512_preset_uses_anchor_group_2():
    from yolofastest_torch.configs.config import _ANCHOR_GROUPS

    assert get_config("lite-512x640").io.anchors == _ANCHOR_GROUPS[2:3]
    assert get_config("lite-256x320").io.anchors == _ANCHOR_GROUPS[1:2]


@pytest.mark.parametrize("name", ["256x320", "lite_256x320"])
def test_unfold_to_variables_matches_jax(name):
    folded = fold_batchnorm(load_variables(zoo_path(name)))
    ours = unfold_to_variables(folded)
    _assert_trees_equal(ours, jgraph.unfold_to_variables(folded))
    # re-folding gives the folded tree back to within one float32 ulp
    again = fold_batchnorm(ours)
    for layer, p in folded.items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(again[layer][leaf], p[leaf], rtol=2.0 ** -23, atol=0)


# ---------------------------------------------------------------------- prune
def test_infer_inner_widths_matches_jax():
    variables = load_variables(PRUNED)
    widths = tprune.infer_inner_widths(variables)
    assert widths == jprune.infer_inner_widths(variables)
    assert dict(widths)["res5_1"] == 136 and dict(widths)["res1_1"] == 8
    assert tprune.infer_inner_widths(variables["params"]) == widths


def test_channel_scores_and_keep_count_match_jax():
    variables = load_variables(PRUNED)
    ours, theirs = tprune.channel_scores(variables), jprune.channel_scores(variables)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    for cmid in (8, 20, 136, 224):
        for ratio in (0.0, 0.3, 0.5, 0.9):
            for min_keep, round_to in ((4, 4), (8, 8), (1, 1)):
                assert (tprune._keep_count(cmid, ratio, min_keep, round_to)
                        == jprune._keep_count(cmid, ratio, min_keep, round_to))


@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5])
def test_prune_variables_matches_jax(ratio):
    """Pruning the pruned040 zoo again: equal trees and reports."""
    variables = load_variables(PRUNED)
    ours, rep = tprune.prune_variables(variables, ratio)
    theirs, jrep = jprune.prune_variables(variables, ratio)
    assert rep == jrep
    _assert_trees_equal(ours, theirs)
    ours["params"]["res1_1"]["conv1"]["conv"]["kernel"][...] = 7.0  # a deep copy
    assert not (variables["params"]["res1_1"]["conv1"]["conv"]["kernel"] == 7.0).all()
    with pytest.raises(ValueError):
        tprune.prune_variables(variables, 1.0)


# ------------------------------------------------------------------------ TTA
def _merge_case(case):
    rng = np.random.default_rng(7)
    if case == "fixture":  # tests/test_tta.py:21-43
        boxes = np.array([[[10, 5, 20, 15], [30, 8, 40, 18]],
                          [[60, 5, 70, 15], [0, 0, 0, 0]]], np.float32)
        conf = np.array([[0.9, 0.5], [0.7, 0.1]], np.float32)
        score = np.array([[0.8, 0.6], [0.4, 0.2]], np.float32)
        cls = np.array([[0, 1], [2, 0]], np.int32)
        valid = np.array([[True, True], [True, False]])
        return boxes, conf, score, cls, valid
    b, k = 4, 16  # two images and their mirrors
    boxes = np.sort(rng.integers(0, 96, (b, k, 4)).astype(np.float32).reshape(b, k, 2, 2),
                    axis=2).transpose(0, 1, 3, 2).reshape(b, k, 4)
    if case == "ties":  # every confidence tied: index order decides
        conf = np.full((b, k), 0.5, np.float32)
    else:
        conf = -np.sort(-rng.random((b, k)).astype(np.float32), axis=1)
    score = rng.random((b, k)).astype(np.float32)
    cls = rng.integers(0, 3, (b, k)).astype(np.int32)
    valid = rng.random((b, k)) < 0.7
    return boxes, conf, score, cls, valid


# jitted, as inside the JAX Detector: one compile instead of one per primitive
_jmerge_tta = jax.jit(jdetector._merge_tta, static_argnums=(5,))


@pytest.mark.parametrize("case", ["fixture", "ties", "random"])
def test_merge_tta_matches_jax(case):
    args = _merge_case(case)
    ours = tdetector._merge_tta(*(torch.from_numpy(a) for a in args), 96.0)
    theirs = _jmerge_tta(*(jnp.asarray(a) for a in args), 96.0)
    for o, t in zip(ours, theirs):
        assert o.numpy().dtype == np.asarray(t).dtype
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))


@pytest.fixture(scope="module")
def tta_detector():
    return Detector(get_config("256x320"), variables=load_variables(zoo_path("256x320")),
                    tta=True, device="cpu")


def _jax_tta_run_packed():
    """The JAX TTA Detector's run_packed on 2 golden frames (a worker of
    tests/_jax_refs.py)."""
    jdet = JDetector(jget_config("256x320"), variables=load_variables(zoo_path("256x320")),
                     fold_bn=True, tta=True)
    return np.asarray(jdet.run_packed(jnp.asarray(_net(_golden("256x320")["pre_imgs"][:2]))))


register("variants/tta_run_packed", _jax_tta_run_packed)


def test_tta_run_packed_matches_jax(tta_detector, jax_refs):  # noqa: F811
    """B=2 frames through both TTA detectors (fp32, the same numpy weights):
    equal counts, validity and classes; boxes within 1 px and confidences
    within 1e-4 (summation order only), as test_torch_detector.py holds the
    plain detector."""
    x = _net(_golden("256x320")["pre_imgs"][:2])
    ours = tta_detector.run_packed(x).numpy()
    theirs = jax_refs["variants/tta_run_packed"]
    assert ours.shape == theirs.shape == (2, 64, 8)
    np.testing.assert_array_equal(ours[..., 7], theirs[..., 7])
    np.testing.assert_array_equal(ours[..., 6], theirs[..., 6])
    np.testing.assert_allclose(ours[..., :4], theirs[..., :4], atol=1.0)
    np.testing.assert_allclose(ours[..., 4:6], theirs[..., 4:6], atol=1e-4)
    assert ours[..., 7].sum() >= 4


def test_tta_keeps_golden_recall(tta_detector):
    """34/34 golden boxes by class and IoU >= 0.5 (tests/test_tta.py:107-115)."""
    fx = _golden("256x320")
    rows = detections_to_lists(tta_detector.run(_net(fx["pre_imgs"])))
    assert _recall_iou(rows, fx["boxes"], strict=False) == len(fx["boxes"]) == 34


def test_tta_is_flip_equivariant(tta_detector):
    """TTA(x) and TTA(mirror(x)) see the same candidates, mirrored, so their
    detections mirror each other (tests/test_tta.py:63-79)."""
    x = _net(_golden("256x320")["pre_imgs"][:4])
    a = detections_to_lists(tta_detector.run(x))
    bm = detections_to_lists(tta_detector.run(x[:, :, ::-1, :].copy()))
    w = 320

    def matches(da, db):
        mirrored = [w - db[2], db[1], w - db[0], db[3]]
        return (int(da[6]) == int(db[6]) and np.allclose(da[4:6], db[4:6], rtol=1e-3)
                and np.allclose(da[:4], mirrored, atol=1.0))

    for ra, rb in zip(a, bm):
        assert len(ra) == len(rb) > 0
        for da in ra:
            assert any(matches(da, db) for db in rb), (da, rb)


def test_detector_rejects_unknown_arch():
    with pytest.raises(ValueError, match="unknown arch"):
        Detector(get_config("256x320"), variables=load_variables(zoo_path("256x320")),
                 arch="tiny", device="cpu")


# --------------------------------------------------------------------- sliced
@pytest.mark.parametrize("origin_hw,grid,overlap", [
    ((100, 200), (1, 1), 0.2), ((100, 200), (2, 2), 0.2), ((1024, 1280), (2, 2), 0.2),
    ((512, 640), (3, 2), 0.35), ((97, 131), (4, 5), 0.0)])
def test_tile_grid_matches_jax(origin_hw, grid, overlap):
    assert tsliced.tile_grid(origin_hw, grid, overlap) == jsliced.tile_grid(origin_hw, grid,
                                                                           overlap)


def test_tile_grid_rejects_bad_arguments():
    for bad in (((100, 200), (2, 2), 1.0), ((100, 200), (0, 2), 0.2)):
        with pytest.raises(ValueError):
            tsliced.tile_grid(*bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_nms_matches_jax(seed):
    """Random overlapping boxes of three classes, with tied scores, under the
    +1 px IOU of the JAX merge."""
    rng = np.random.default_rng(seed)
    n = 60
    xy = rng.integers(0, 80, (n, 2)).astype(np.float64)
    boxes = np.concatenate([xy, xy + rng.integers(2, 40, (n, 2))], 1)
    scores = np.round(rng.random(n), 1).astype(np.float32)  # many ties
    cls = rng.integers(0, 3, n).astype(np.int32)
    ours = tsliced._greedy_nms(boxes, scores, cls, 0.4)
    theirs = jsliced._greedy_nms(boxes, scores, cls, 0.4)
    assert ours.dtype == theirs.dtype and len(ours) > 3
    np.testing.assert_array_equal(ours, theirs)


class _FixedPacked:
    """A stub detector whose run_packed returns one fixed packed array,
    whatever the tiles: duplicates across tiles, several classes, invalid
    rows between valid ones."""

    def __init__(self, config, n_tiles, seed=3):
        self.config = config
        io = config.io
        rng = np.random.default_rng(seed)
        out = np.zeros((n_tiles, io.max_det, 8), np.float32)
        for k in range(n_tiles):
            n = 12
            xy = rng.integers(0, 280, (n, 2)).astype(np.float32)
            out[k, :n, 0:2] = xy
            out[k, :n, 2:4] = xy + rng.integers(4, 60, (n, 2))
            out[k, :n, 4] = rng.random(n)
            out[k, :n, 5] = rng.random(n)
            out[k, :n, 6] = rng.integers(0, 3, n)
            out[k, :n, 7] = rng.random(n) < 0.8
        out[1, :6] = out[0, :6]  # the same boxes from two tiles
        self.packed = out

    def run_packed(self, batch):
        assert batch.shape[0] == self.packed.shape[0]
        return self.packed


@pytest.mark.parametrize("grid,overlap", [((2, 2), 0.2), ((2, 3), 0.4)])
def test_sliced_detect_matches_jax(grid, overlap):
    ori = np.zeros((512, 768, 3), np.uint8)
    n = grid[0] * grid[1]
    ours = tsliced.sliced_detect(_FixedPacked(get_config("256x320"), n), ori, grid, overlap)
    theirs = jsliced.sliced_detect(_FixedPacked(jget_config("256x320"), n), ori, grid, overlap)
    assert ours["count"] == theirs["count"] > 0
    for key in ("boxes", "conf", "cls_score", "cls_idx"):
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key])
