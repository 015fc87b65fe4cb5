"""The port's deployment tools (``yolofastest_torch.eval.golden``,
``eval.golden_suite``, ``quant.recipes``, ``models.zoo.lite_seed`` and the
``tools/torch_*.py`` shells around them) on the CPU, held against the JAX
tools they port.

What is held, and how closely:

* the matching rule (``iou``, ``recall_vs_golden`` and the native engine's
  form over ``detect()`` rows) against ``tools/run_golden_suite.py``'s own
  functions, exactly, on seeded detections and on the edges: IoU exactly
  0.5, a class mismatch, rows past ``count``, an image without golden rows;
* the scale-set grammar against both JAX tools' regular expressions, and
  the bad-name exits against theirs, message for message;
* ``build_shipped("512x640")`` against the committed artifact: the folded
  weights bit for bit; the scales within 3e-2 relative of the committed
  ones (JAX computed those on a TPU, whose default-precision fp32
  convolutions round otherwise: the largest distance measured on the CPU
  is 2.85e-2) and within 1e-5 of JAX's own ``calibrate`` of the same 16
  frames on the CPU (``tests/test_torch_quant.py``'s amax tolerance);
* both searches with stub scorers: the candidate order, the stop rules,
  the fewest kept layers over scale sets, and nothing written but ``out``;
  one real ``qat_finetune`` of 4 steps at 64x96 through the QAT search;
* the lite seed against ``tools/make_lite_seed.py --out``, leaf for leaf;
* the matrix on 2 frames at 256x320: JAX's row names (``jax-`` read as
  ``torch-``) and every row's recall full, as the port's tests of those
  backends find on all 20 frames.

The port's heavier runs (the matrix, the 512x640 recipe, the lite seed) run
in a process of ``tests/_torch_recipes.py`` started with the first port
module, beside the JAX lite seed tool (``tests/_jax_recipes.py``); JAX's
``calibrate`` at 512x640 in a worker of ``tests/_jax_refs.py``.
"""

import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest

from tests._background import recipe_outputs  # noqa: F401 (a fixture)
from tests._jax_refs import jax_refs, register  # noqa: F401 (a fixture)
from tests._torch_recipes import MATRIX_FRAMES
from yolofastest_torch.configs import get_config
from yolofastest_torch.eval import golden as tgolden
from yolofastest_torch.models import fold_batchnorm, load_variables, zoo_path
from yolofastest_torch.quant import load_int8_zoo
from yolofastest_torch.quant import recipes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
WEIGHTS = os.path.join(ROOT, "weights")
pytestmark = pytest.mark.usefixtures("jax_refs", "recipe_outputs")


def jax_tool(name):
    """A JAX tool of ``tools/`` imported as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_tool(name):
    sys.path.insert(0, TOOLS)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(TOOLS)


def _weights_state():
    """The committed weights' files and times (other commands may leave
    ``*.calib.json`` caches there, which git ignores)."""
    return {f: os.stat(os.path.join(WEIGHTS, f)).st_mtime_ns for f in os.listdir(WEIGHTS)
            if f.endswith(".npz")}


WEIGHTS_AT_IMPORT = _weights_state()


def _jax_calibrate_512():
    """JAX's ``calibrate(method="amax")`` of the 512x640 zoo on its first 16
    golden frames: what ``tools/make_int8_zoo.py`` computes for 512x640."""
    from yolofastest_tpu.quant import calibrate

    imgs, _ = tgolden.golden_inputs("512x640")
    folded = fold_batchnorm(load_variables(zoo_path("512x640")))
    return {k: float(v) for k, v in calibrate(folded, [imgs[:16]], method="amax").items()}


register("recipes/calibrate_512x640", _jax_calibrate_512,
         tests=("test_build_shipped_512x640_scales_match_jax_calibrate",))


# ------------------------------------------------------ the matching rule
def matching_case(name):
    """(det, golden) of one case: 3 images, 6 detections each."""
    rng = np.random.default_rng(0)
    golden = np.array([[0, 10, 10, 60, 50, 0.9, 0.8, 1], [0, 100, 40, 160, 90, 0.8, 0.7, 0],
                       [1, 30, 30, 80, 70, 0.7, 0.9, 2]], np.float32)
    boxes = rng.uniform(0, 200, (3, 6, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(5, 60, (3, 6, 2)).astype(np.float32)
    cls_idx = rng.integers(0, 3, (3, 6)).astype(np.int32)
    count = np.array([6, 4, 5], np.int32)
    if name == "seeded":  # each golden box jittered among the rows
        for j, row in enumerate(golden):
            b = int(row[0])
            boxes[b, j] = row[1:5] + rng.uniform(-6, 6, 4)
            cls_idx[b, j] = int(row[7])
    elif name == "iou_half":  # IoU exactly 0.5: not found (the rule is > 0.5)
        boxes[0, 0] = [10, 10, 60, 30]  # 50 x 20 inside 50 x 40
        cls_idx[0, 0] = 1
        boxes[0, 1] = [100, 40, 160, 65.5]  # just over half of row 1's box: found
        cls_idx[0, 1] = 0
        boxes[1, 0] = [30, 30, 80, 50]
        cls_idx[1, 0] = 2
    elif name == "class_mismatch":
        for j, row in enumerate(golden):
            b = int(row[0])
            boxes[b, j] = row[1:5]
            cls_idx[b, j] = (int(row[7]) + 1) % 3
    elif name == "past_count":  # exact boxes after the image's count
        for j, row in enumerate(golden):
            b = int(row[0])
            boxes[b, 5] = row[1:5]
            cls_idx[b, 5] = int(row[7])
        count[:] = [4, 5, 5]
        boxes[0, 3] = golden[0, 1:5]
        cls_idx[0, 3] = int(golden[0, 7])
    elif name == "no_golden_rows":  # image 2 has no golden row, detections everywhere
        boxes[2, :3] = golden[:, 1:5]
        cls_idx[2, :3] = golden[:, 7]
        boxes[1, 2] = golden[2, 1:5]
        cls_idx[1, 2] = 2
    return {"boxes": boxes, "cls_idx": cls_idx, "count": count}, golden


MATCH_CASES = {"seeded": 3, "iou_half": 1, "class_mismatch": 0, "past_count": 1,
               "no_golden_rows": 1}


@pytest.mark.parametrize("name", sorted(MATCH_CASES))
def test_matching_rule_matches_jax_tool(name):
    """The port's ``iou``, ``recall_vs_golden`` and ``recall_rows`` against
    ``tools/run_golden_suite.py``'s ``iou``, ``recall_vs_golden`` and its
    native loop (``:190-201``) on the same detections."""
    jax = jax_tool("run_golden_suite")
    det, golden = matching_case(name)
    for b in range(3):
        for box in det["boxes"][b]:
            for row in golden:
                assert tgolden.iou(box, row[1:5]) == jax.iou(box, row[1:5])
    assert tgolden.iou([10, 10, 60, 30], [10, 10, 60, 50]) == 0.5
    theirs = jax.recall_vs_golden(det, golden)
    assert tgolden.recall_vs_golden(det, golden) == theirs == (MATCH_CASES[name], 3)
    rows = [[[*det["boxes"][b, i], 0.5, 0.5, det["cls_idx"][b, i]] for i in range(det["count"][b])]
            for b in range(3)]
    native = 0
    for b in range(3):  # tools/run_golden_suite.py:193-201
        for w in golden[golden[:, 0] == b]:
            native += any(int(r[6]) == int(w[7]) and jax.iou(r[:4], w[1:5]) > 0.5 for r in rows[b])
    assert tgolden.recall_rows(rows, golden) == (native, 3) == theirs


# --------------------------------------------------------- the scale sets
def _jax_scale_regexes():
    out = []
    for tool in ("search_int8_recipe2", "search_pruned_int8"):
        with open(os.path.join(TOOLS, f"{tool}.py")) as f:
            src = f.read()
        out.append(re.search(r're\.fullmatch\(r"([^"]+)"', src).group(1))
        assert '{"amax": "amax", "mse": "mse", "pct": "percentile"}' in src
    return out


SCALE_NAMES = ["amax8", "mse12", "pctF", "amaxF", "mseF", "pct12", "amax0", "amax016", "amax",
               "mse12x", "AMAX8", "entropy8", "amax-8", "amaxf", " amax8", ""]


@pytest.mark.parametrize("spec", SCALE_NAMES)
def test_scale_set_grammar_matches_jax_tools(spec):
    """``parse_scale_set`` accepts what both JAX tools' expressions accept,
    with their method names and frame counts, and refuses the rest."""
    regexes = _jax_scale_regexes()
    assert regexes[0] == regexes[1] == recipes.SCALE_SET.pattern
    m = re.fullmatch(regexes[0], spec)
    if m is None:
        with pytest.raises(ValueError, match=f"unknown scale set {re.escape(spec)}"):
            recipes.parse_scale_set(spec)
        return
    method = {"amax": "amax", "mse": "mse", "pct": "percentile"}[m.group(1)]
    count = None if m.group(2) == "F" else int(m.group(2))
    assert recipes.parse_scale_set(spec) == (method, count)


def test_bad_scale_set_exits_as_jax(capsys):
    """The two search tools exit with their JAX tools' lines on a bad scale
    set: ``search_int8_recipe2.make_scales`` raises before it calibrates;
    ``search_pruned_int8.py`` exits at the bad set (the port's checks every
    set before any work)."""
    with pytest.raises(SystemExit) as theirs:
        jax_tool("search_int8_recipe2").make_scales(None, None, "bad8")
    with pytest.raises(SystemExit) as ours:
        port_tool("torch_search_int8_recipe2").main(["--res", "256x320", "--scales", "bad8",
                                                     "--device", "cpu"])
    assert str(ours.value) == str(theirs.value) == "unknown scale set bad8"
    argv, sys.argv = sys.argv, ["search_pruned_int8.py", "--scale-sets", "bad8"]
    try:
        with pytest.raises(SystemExit) as theirs:
            jax_tool("search_pruned_int8").main()
    finally:
        sys.argv = argv
    with pytest.raises(SystemExit) as ours:
        port_tool("torch_search_pruned_int8").main(["--scale-sets", "mse12,bad8",
                                                    "--device", "cpu"])
    assert str(ours.value) == str(theirs.value) == "bad scale set bad8"
    with pytest.raises(ValueError, match="unknown scale set bad8"):
        recipes.make_scales(None, None, "bad8")


# --------------------------------------------------- the 512x640 recipe
def test_build_shipped_512x640_reproduces_committed(recipe_outputs):  # noqa: F811
    """The folded weights of ``build_shipped("512x640")`` on the CPU equal
    the committed artifact's bit for bit; its scales, keyed alike, are
    within 3e-2 relative of the committed ones, which a TPU computed."""
    root = recipe_outputs.wait()
    folded, scales, keep = load_int8_zoo(str(root / "int8" / "yolofastest_int8_512x640.npz"))
    c_folded, c_scales, c_keep = load_int8_zoo("512x640")
    assert keep == c_keep == ()
    assert sorted(folded) == sorted(c_folded)
    for name, layer in c_folded.items():
        for leaf, a in layer.items():
            assert folded[name][leaf].dtype == a.dtype
            np.testing.assert_array_equal(folded[name][leaf], a)
    assert list(scales) == list(c_scales)
    rel = max(abs(scales[k] - s) / s for k, s in c_scales.items())
    assert 0 < rel <= 3e-2, rel


def test_build_shipped_512x640_scales_match_jax_calibrate(recipe_outputs, jax_refs):  # noqa: F811
    """The recipe's scales against the JAX package's ``calibrate`` of the
    same 16 frames on the CPU (a worker of ``tests/_jax_refs.py``): keys in
    its order, within 1e-5 relative."""
    root = recipe_outputs.wait()
    _, scales, _ = load_int8_zoo(str(root / "int8" / "yolofastest_int8_512x640.npz"))
    theirs = jax_refs["recipes/calibrate_512x640"]
    assert list(scales) == list(theirs)
    for k, s in theirs.items():
        assert abs(scales[k] - s) <= 1e-5 * s, (k, scales[k], s)


def test_nothing_written_to_weights(recipe_outputs):  # noqa: F811
    """The recipe wrote its artifact under ``out`` and nothing in
    ``weights/``; ``.gitignore`` lists the tools' default directories."""
    root = recipe_outputs.wait()
    assert os.listdir(root / "int8") == ["yolofastest_int8_512x640.npz"]
    assert _weights_state() == WEIGHTS_AT_IMPORT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = f.read().split()
    assert {"int8_artifacts/", "golden_suite_results/"} <= set(ignored)


# ------------------------------------------------------ the QAT search
def _qat_case():
    """The 256x320 artifact's weights and scales, two seeded 64x96 frames
    (one batch) and two golden rows: a real fine-tune at a small size."""
    folded, scales, _ = load_int8_zoo("256x320")
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-0.5, 0.5, (2, 64, 96, 1)).astype(np.float32)
    golden = np.array([[0, 1, 1, 9, 9, 1, 1, 0], [1, 1, 1, 9, 9, 1, 1, 0]], np.float32)
    return folded, scales, imgs, golden


def test_search_recall_qat_candidate_order_and_stop(tmp_path):
    """PTQ first, then ``best-loss``, then the snapshots in step order; the
    first whose smallest recall reaches the target ships to ``out`` (and
    nothing else is written), the later ones are never scored."""
    folded, scales, imgs, golden = _qat_case()
    canned = iter([(0, 0, 0), (2, 1, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)])
    seen, log, record = [], [], {}

    def score(tree):
        seen.append(tree)
        return next(canned)

    out = str(tmp_path / "art" / "a.npz")
    found = recipes.search_recall_qat(
        folded, get_config("256x320"), scales, spec="amax8", imgs=imgs, golden=golden, steps=4,
        snap=1, lr=1e-4, conf_weight=4.0, out=out, device="cpu", log=log.append, score=score,
        record=record)
    labels = [label for label, _ in record["scores"]]
    assert labels == ["ptq-amax8", "qat-amax8-cw4.0-best-loss", "qat-amax8-cw4.0-step1",
                      "qat-amax8-cw4.0-step2"]
    assert seen[0] is folded and found[0] == "step2" and found[1] is seen[-1]
    assert len(record["history"]) == 4 and np.all(np.isfinite(record["history"]))
    assert log[-2:] == ["[256x320] TARGET RECALL (2/2) at step2", f"shipped {out}"]
    assert os.listdir(tmp_path) == ["art"] and os.listdir(tmp_path / "art") == ["a.npz"]
    s_folded, s_scales, keep = load_int8_zoo(out)
    assert s_scales == scales and keep == ()
    for name, layer in found[1].items():
        for leaf, a in layer.items():
            np.testing.assert_array_equal(s_folded[name][leaf], a)
    assert not all(np.array_equal(found[1][n]["kernel"], folded[n]["kernel"]) for n in folded)


def test_search_recall_qat_none_ships_nothing(tmp_path):
    """No candidate reaches the target: None, JAX's last line, no file."""
    folded, scales, imgs, golden = _qat_case()
    log = []
    found = recipes.search_recall_qat(
        folded, get_config("256x320"), scales, spec="mse12", imgs=imgs, golden=golden, steps=2,
        snap=1, target=2, out=str(tmp_path / "a.npz"), device="cpu", log=log.append,
        score=lambda tree: (2, 2, 1))
    assert found is None
    assert log[-1] == "[256x320] no snapshot reached 2/2"
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------- the keep-fp search
class StubScorer:
    """A scale set where golden row i (of image i) is missed by the
    per-layer apply unless ``pl[i]`` is kept, by the fused apply unless
    ``fu[i]`` is kept, and native is full once ``native`` is kept."""

    def __init__(self, spec, ranking, pl=(), fu=(), native=None):
        self.scales = {"spec": spec}
        self.ranking, self.pl, self.fu, self.native_needs = ranking, dict(pl), dict(fu), native
        self.calls = []

    def rank(self):
        return list(self.ranking)

    def _found(self, need, keep, images):
        return sum(need.get(i) is None or need[i] in keep for i in images)

    def recalls(self, keep, images=None):
        images = range(4) if images is None else images
        self.calls.append(("recalls", tuple(keep), tuple(images)))
        return self._found(self.pl, keep, images), self._found(self.fu, keep, images)

    def missed(self, keep):
        return [np.array([i, 0, 0, 1, 1, 1, 1, 0]) for need in (self.pl, self.fu)
                for i in range(4) if need.get(i) is not None and need[i] not in keep]

    def native(self, keep):
        self.calls.append(("native", tuple(keep)))
        return 4 if self.native_needs is None or self.native_needs in keep else 3


def test_search_hybrid_keep_fp_fewest_over_scale_sets():
    """The fewest kept layers over the scale sets wins (the first found on a
    tie); a set of at most one layer ends the search."""
    rank = ["r0", "r1", "r2", "r3", "r4", "r5"]
    stubs = {"A": StubScorer("A", rank, pl={0: "r2"}, fu={1: "r4", 2: "r0"}),
             "B": StubScorer("B", rank, pl={0: "r3"}, fu={3: "r1"}),
             "C": StubScorer("C", rank, pl={1: "r0", 2: "r5"}),
             "D": StubScorer("D", rank, fu={2: "r3"}),
             "E": StubScorer("E", rank)}
    made, log = [], []

    def scorer(spec):
        made.append(spec)
        return stubs[spec]

    golden = np.array([[i, 0, 0, 1, 1, 1, 1, 0] for i in range(4)], np.float32)
    best = recipes.search_hybrid_keep_fp(None, get_config("256x320"), np.zeros((4, 1)), golden,
                                         ["A", "B", "C", "D", "E"], device="cpu",
                                         log=log.append, scorer=scorer)
    assert made == ["A", "B", "C", "D"]
    assert best == (1, "D", ("r3",), (4, 4, 4), {"spec": "D"})
    assert "[A] keep=3 ['r0', 'r2', 'r4']: pl 4/4 fused 4/4 native 4/4" in log
    assert "[B] keep=2 ['r1', 'r3']: pl 4/4 fused 4/4 native 4/4" in log
    assert "[C] keep=2 ['r0', 'r5']: pl 4/4 fused 4/4 native 4/4" in log
    assert "[A] keep=0 []: pl 3/4 fused 2/4 native skipped/4" in log
    # native is scored only where both flagged applies are full
    for stub in stubs.values():
        for call in list(stub.calls):
            if call[0] == "native":
                assert stub.recalls(list(call[1])) == (4, 4)


def test_search_hybrid_keep_fp_scan_rules():
    """A step scans the first ``scan_width`` unkept layers of the ranking
    on the frames of the missed rows (all frames where only native is
    short), verifies the best five on all frames in the scan's stable
    order, and stops where none raises the joint recall."""
    golden = np.array([[i, 0, 0, 1, 1, 1, 1, 0] for i in range(4)], np.float32)
    cfg = get_config("256x320")
    far = StubScorer("far", ["r0", "r1", "r2", "r3"], pl={1: "r3"})
    log = []
    assert recipes.search_hybrid_keep_fp(None, cfg, np.zeros((4, 1)), golden, ["far"],
                                         scan_width=3, device="cpu", log=log.append,
                                         scorer=lambda spec: far) is None
    scans = [c for c in far.calls if c[0] == "recalls" and c[2] == (1,)]
    assert [c[1] for c in scans] == [("r0",), ("r1",), ("r2",)]
    assert log[-2:] == ["[far]   scan (imgs [1]): r0=1/2, r1=1/2, r2=1/2",
                        "[far] no scanned addition improves joint recall; stopping"]
    short = StubScorer("short", ["r0", "r1"], native="r1")
    log = []
    assert recipes.search_hybrid_keep_fp(None, cfg, np.zeros((4, 1)), golden, ["short"],
                                         device="cpu", log=log.append,
                                         scorer=lambda spec: short) is None
    assert log[0] == "[short] keep=0 []: pl 4/4 fused 4/4 native 3/4"
    assert log[1] == "[short]   scan (imgs [0, 1, 2, 3]): r0=8/8, r1=8/8"
    capped = StubScorer("capped", ["r0", "r1", "r2"], pl={0: "r0", 1: "r1", 2: "r2"})
    log = []
    assert recipes.search_hybrid_keep_fp(None, cfg, np.zeros((4, 1)), golden, ["capped"],
                                         max_keep=2, device="cpu", log=log.append,
                                         scorer=lambda spec: capped) is None
    assert log[-1] == "[capped] keep=2 ['r0', 'r1']: pl 3/4 fused 4/4 native skipped/4"


# ---------------------------------------------------------- the lite seed
def test_lite_seed_matches_jax_tool(recipe_outputs):  # noqa: F811
    """``tools/torch_make_lite_seed.py --out`` against ``python
    tools/make_lite_seed.py --out`` (run by ``tests/_background.py``): the
    same keys, dtypes and values, leaf for leaf."""
    root = recipe_outputs.wait()
    with np.load(recipe_outputs.wait_jax() / "jax_lite_seed.npz") as theirs, \
            np.load(root / "lite_seed.npz") as ours:
        assert sorted(ours.files) == sorted(theirs.files) and len(theirs.files) == 392
        for k in theirs.files:
            assert ours[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


# ------------------------------------------------------------- the matrix
with open(os.path.join(ROOT, "docs", "golden_suite_summary.json")) as _f:
    COMMITTED = {k.replace("jax-", "torch-"): v
                 for k, v in json.load(_f)["256x320"].items()}


def _matrix(outputs):
    with open(outputs.wait() / "matrix.json") as f:
        matrix = json.load(f)
    if not matrix["native"]:
        pytest.skip("native library not built (neither cpp/build/libyf.so nor build/native)")
    return matrix["rows"]


def test_matrix_row_names_match_committed(recipe_outputs):  # noqa: F811
    """JAX's rows, in its order, ``jax-`` read as ``torch-``."""
    assert list(_matrix(recipe_outputs)) == list(COMMITTED)


@pytest.mark.parametrize("row", list(COMMITTED))
def test_matrix_rows_on_two_frames(recipe_outputs, row):  # noqa: F811
    """Every row finds all golden rows of the first two frames, as the
    port's tests of its backend find all 34 of the 20 (``test_torch_quant``,
    ``test_torch_variants``, ``test_torch_native``); the int8 rows' layers,
    source and keep-fp set are the committed summary's."""
    rows = _matrix(recipe_outputs)
    _, golden = tgolden.golden_inputs("256x320", MATRIX_FRAMES)
    got, want = rows[row], COMMITTED[row]
    assert got["recall"] == f"{len(golden)}/{len(golden)}" and got["detection_rate"] == 1.0
    assert set(got) == set(want)
    for key in ("int8_layers", "int8_source", "keep_fp"):
        assert got.get(key) == want.get(key)
    timing = "ms_per_img_batched" if "ms_per_img_batched" in want else "ms_per_img"
    assert got[timing] > 0
