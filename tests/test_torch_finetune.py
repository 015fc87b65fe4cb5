"""The pseudo-GT fine-tune set, the round-4 training recipes and the
deterministic train and QAT steps of the port, on the CPU.

What is held, and how closely:

* ``tools/torch_make_finetune_set.py`` against JAX's own
  ``tools/make_finetune_set.py``, run on the same frames (the fixture's
  ``pre_imgs`` written losslessly under their ``image_names``, which JAX's
  tool copies; both tools run in a process of ``tests/_finetune_sets.py``
  started with the first port module): the file names and counts at both
  sizes, the XML files byte for byte, the decoded images exactly; each
  copy a hard link to one file a frame;
* the port's ``DetectionLoader`` over each val set: net inputs equal to the
  fixture's ``pre_imgs`` at that size bit for bit (``(x - 128) / 255``),
  and targets equal to JAX's ``DetectionLoader`` over the same tree;
* every ``python3 -m yolofastest_torch`` line of the two recipe scripts
  parses with the port's CLI, with the flags and values of the matching
  line of JAX's script (``yolofastest_tpu`` read as ``yolofastest_torch``,
  the output paths apart);
* ``Trainer.step`` and a QAT step run under cuDNN's deterministic flags
  and put back the flags they found;
* ``eval.golden.fp_recall`` (the pruned recipe's golden check): the
  committed pruned040 checkpoint keeps all 34 golden rows through the
  folded graph.
"""

import dataclasses
import json
import os
import re
import shlex

import numpy as np
import pytest
import torch

from tests._background import finetune_sets  # noqa: F401 (a fixture)
from yolofastest_torch.configs import get_config
from yolofastest_torch.data import DetectionLoader, VOCIndex
from yolofastest_torch.models import load_variables, zoo_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
RESOLUTIONS = ("256x320", "512x640")
# (train, val) entries at --copies 2: 20 frames at 256x320, 19 at 512x640
COUNTS = {"256x320": (40, 20), "512x640": (38, 19)}


@pytest.fixture(scope="module")
def sets(finetune_sets):
    """Both tools' sets at --copies 2 for both sizes, ``{res: (jax_dir,
    port_dir)}``, and what the port's tool printed (the 512x640 set written
    twice, the second time over the first), from ``tests/_finetune_sets.py``
    (started with the first port module)."""
    root = finetune_sets.wait()
    done = json.loads((root / "done.json").read_text())
    return ({res: (root / f"jax_{res}", root / f"port_{res}") for res in RESOLUTIONS},
            done["printed"])


def test_set_tool_prints_jax_lines(sets):
    assert sets[1] == ["train: 40 entries", "val: 20 entries"] + 2 * [
        "train: 38 entries", "val: 19 entries"]


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_set_matches_jax_tool(sets, res):
    """Names, counts and XML bytes equal to JAX's tool's; every image of a
    frame is one file (hard links), whose decoded pixels equal JAX's copy
    of the same frame."""
    import cv2

    jdir, pdir = sets[0][res]
    by_frame = {}  # frame stem -> the port's image files and JAX's
    for split, want in zip(("train", "val"), COUNTS[res]):
        for sub in ("img", "xml"):
            names = sorted(os.listdir(jdir / split / sub))
            assert sorted(os.listdir(pdir / split / sub)) == names
            assert len(names) == want
        for name in os.listdir(jdir / split / "xml"):
            assert (pdir / split / "xml" / name).read_bytes() == \
                (jdir / split / "xml" / name).read_bytes(), name
        for name in os.listdir(jdir / split / "img"):
            files = by_frame.setdefault(name[:-len("_c00.jpg")], ([], []))
            files[0].append(pdir / split / "img" / name)
            files[1].append(jdir / split / "img" / name)
    assert len(by_frame) == COUNTS[res][1]
    for stem, (port, jax) in by_frame.items():
        assert len({os.stat(p).st_ino for p in port}) == 1, stem
        assert len({p.read_bytes() for p in jax}) == 1, stem
        got = cv2.imread(str(port[0]))
        assert got is not None and np.array_equal(got, cv2.imread(str(jax[0]))), stem


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_loader_sees_the_fixture_frames(sets, res):
    """The val set through the port's loader gives the fixture's net inputs
    bit for bit, and JAX's loader's targets."""
    from yolofastest_tpu.data import DetectionLoader as JDetectionLoader
    from yolofastest_tpu.data import VOCIndex as JVOCIndex

    jdir, pdir = sets[0][res]
    cfg = get_config(res)
    fx = np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
    by_stem = {os.path.splitext(str(n))[0]: i for i, n in enumerate(fx["image_names"])}
    index = VOCIndex(str(pdir / "val"), cfg.io.class_names)
    loader = DetectionLoader(index, cfg, batch_size=8, augment=False, shuffle=False,
                             drop_last=False)
    imgs, tgts = (np.concatenate(a) for a in zip(*loader))
    order = [by_stem[os.path.basename(p)[:-len("_c00.jpg")]] for p, _ in index.items]
    want = (fx["pre_imgs"][order].astype(np.float32)[..., None] - 128.0) / 255.0
    assert imgs.shape == want.shape == (COUNTS[res][1], *cfg.io.input_hw, 1)
    assert np.array_equal(imgs, want)
    from yolofastest_tpu.configs import get_config as jget_config

    jloader = JDetectionLoader(JVOCIndex(str(jdir / "val"), cfg.io.class_names),
                               jget_config(res), batch_size=8, augment=False, shuffle=False,
                               drop_last=False)
    jtgts = np.concatenate([t for _, t in jloader])
    assert np.array_equal(tgts, jtgts)
    assert int((tgts[..., 5] > 0).sum()) == len(fx["boxes"])


# ------------------------------------------------------------ the recipes
RECIPES = {"torch_run_fullscale_train.sh": "run_fullscale_train.sh",
           "torch_run_prune040_zoo.sh": "run_prune040_zoo.sh"}
# the flags whose values are paths the scripts write or read from their output
OUTPUT_DESTS = {"train_dir", "val_dir", "checkpoint_dir", "log_dir", "out", "pretrained"}


def _commands(path, marker):
    """The script's command lines (continuations joined) that contain
    ``marker``, split as the shell splits them (variables left as text)."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    return [shlex.split(ln) for ln in text.splitlines()
            if marker in ln and not ln.lstrip().startswith("#")]


@pytest.mark.parametrize("script", sorted(RECIPES))
def test_recipe_lines_parse_as_jax(script):
    from yolofastest_torch.cli import build_parser

    parser = build_parser()
    port = _commands(os.path.join(TOOLS, script), "-m yolofastest_torch")
    jax = _commands(os.path.join(TOOLS, RECIPES[script]), "-m yolofastest_tpu")
    assert len(port) == len(jax) >= 1
    for p, j in zip(port, jax):
        p_args = p[p.index("yolofastest_torch") + 1:]
        j_args = j[j.index("yolofastest_tpu") + 1:]
        assert p_args[0] == j_args[0]  # the command
        assert ({a for a in p_args if a.startswith("--")}
                == {a for a in j_args if a.startswith("--")})
        pn, jn = vars(parser.parse_args(p_args)), vars(parser.parse_args(j_args))
        assert pn.keys() == jn.keys()
        assert {k: v for k, v in pn.items() if k not in OUTPUT_DESTS} == \
            {k: v for k, v in jn.items() if k not in OUTPUT_DESTS}
        for k in OUTPUT_DESTS & pn.keys():  # under the one output root, never weights/
            if pn[k]:
                assert pn[k].startswith("$OUT/"), (k, pn[k])
    # the set tool's flags are JAX's, its output under the root too
    port_set = _commands(os.path.join(TOOLS, script), "torch_make_finetune_set.py")
    jax_set = _commands(os.path.join(TOOLS, RECIPES[script]), "make_finetune_set.py")
    assert len(port_set) == len(jax_set) == 1
    p, j = port_set[0], jax_set[0]
    assert p[p.index("--copies") + 1] == j[j.index("--copies") + 1]
    assert p[p.index("--out") + 1].startswith("$OUT/")


def test_recipes_write_under_their_root():
    """Nothing of either script names ``weights/`` as a destination or a
    ``/tmp`` path; the default root is git-ignored."""
    for script in RECIPES:
        with open(os.path.join(TOOLS, script)) as f:
            text = f.read()
        assert "/tmp" not in text
        assert 'OUT=${1:-train_runs}' in text
        assert not re.search(r"(--out|save_variables\([^)]*,)\s*\"?weights/", text)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "train_runs/" in f.read().split()


# ------------------------------------------------ the deterministic steps
def _flags():
    c = torch.backends.cudnn
    return (c.deterministic, c.benchmark, torch.are_deterministic_algorithms_enabled())


@pytest.fixture
def odd_flags():
    """cuDNN flags set away from the step's, restored after the test."""
    c = torch.backends.cudnn
    saved = (c.deterministic, c.benchmark)
    c.deterministic, c.benchmark = False, True
    try:
        yield _flags()
    finally:
        c.deterministic, c.benchmark = saved


def test_train_step_scope_does_not_leak(odd_flags):
    from yolofastest_torch.train import Trainer

    cfg = get_config("256x320")
    cfg = dataclasses.replace(cfg, io=dataclasses.replace(cfg.io, input_shape=(64, 96, 1)))
    t = Trainer(cfg, batch_per_epoch=1, variables=load_variables(zoo_path("256x320")),
                device="cpu")
    seen = []
    t.model.register_forward_pre_hook(lambda *_: seen.append(_flags()))
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-0.5, 0.5, (2, 64, 96, 1)).astype(np.float32)
    tgts = np.zeros((2, cfg.train.max_boxes, 6), np.float32)
    tgts[:, 0] = (0.5, 0.5, 0.2, 0.3, 1.0, 255.0)
    metrics = t.step(imgs, tgts)
    assert np.isfinite(float(metrics["total"]))
    assert seen == [(True, False, odd_flags[2])]
    assert _flags() == odd_flags


def test_qat_step_scope_does_not_leak(odd_flags):
    from yolofastest_torch.quant import load_int8_zoo
    from yolofastest_torch.quant.qat import QatRun

    folded, scales, _ = load_int8_zoo("256x320")
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 64, 96, 1)).astype(np.float32)
    run = QatRun(folded, scales, [x], arch="fastest", targets=None, anchors=None,
                 input_hw=None, num_cls=3, lr=5e-5, conf_weight=4.0, device=torch.device("cpu"),
                 dtype=torch.float32)
    seen, loss_fn = [], run.loss_fn
    run.loss_fn = lambda *a: (seen.append(_flags()), loss_fn(*a))[1]
    zeros = torch.zeros_like(run.theta0)
    out = run.step(run.theta0, zeros, zeros.clone(), torch.zeros((), dtype=torch.int32), 0)
    assert torch.isfinite(out[4])
    assert seen == [(True, False, odd_flags[2])]
    assert _flags() == odd_flags


# ------------------------------------------------- the recipe's golden check
def test_fp_recall_of_the_pruned_checkpoint():
    """The committed pruned040 checkpoint (JAX's recipe's result) keeps
    every golden row through the folded graph, the recipe's check."""
    from yolofastest_torch.eval.golden import fp_recall

    variables = load_variables(zoo_path("pruned040_256x320"))
    assert fp_recall(variables, "256x320", "cpu") == (34, 34)
