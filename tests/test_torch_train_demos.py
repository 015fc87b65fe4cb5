"""The training demos' driver (``tools/torch_run_train_demos.py``) against
the JAX package's committed records, on the CPU, with no training; and the
resume fault the ``scratch`` demo found.

What is held, and how closely:

* every ``python3 -m yolofastest_torch train`` line that ``--print`` shows,
  parsed by the port's ``build_parser``, equals JAX's command for the demo
  parsed by ``yolofastest_tpu/cli/parser.py``'s (the commands written down
  in ``docs/train_demo_{distill,scratch}/NOTES.md``, the others as the
  recipe derives them from JAX's logs); only the paths, which are mapped,
  and ``--device`` differ, and the extra distillation seeds differ only in
  ``--config-json``, the preset with ``train.seed`` changed;
* the port's ``make_lr_schedule`` with each recipe's epochs, batches an
  epoch and warmup equals the ``lr`` column of JAX's ``metrics.jsonl`` at
  every logged step (after a resume, at its global step), to 1e-6 relative;
* each recipe's set (frames with golden rows x copies, and the val frames)
  has the sizes of the ``dataset contains N items`` lines of JAX's log;
* a resumed run continues the loader's stream: ``DetectionLoader.
  skip_epochs(n)`` then gives the batches of an uninterrupted run's epoch
  ``n``, and ``train --resume latest`` from the first of two epochs ends
  with the uninterrupted run's state bit for bit (before the repair the
  resumed epoch drew the loader's first epoch again).
"""

import contextlib
import dataclasses
import io
import os
import re
import shlex
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_run_train_demos as demos  # noqa: E402

from yolofastest_torch.configs import Config, get_config  # noqa: E402
from yolofastest_torch.train import make_lr_schedule  # noqa: E402

NAMES = sorted(demos.DEMOS)
# the dests whose values are paths the recipe reads or writes
PATH_DESTS = {"train_dir", "val_dir", "checkpoint_dir", "log_dir", "pretrained",
              "distill_teacher"}


def _printed(name, out, *flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert demos.main(["--print", "--demo", name, "--out", out, *flags]) == 0
    return buf.getvalue().splitlines()


def _notes_commands(folder):
    """The ``python -m yolofastest_tpu`` commands written down in a NOTES.md
    (continuations joined, the set's placeholder read as ``SET``), and its
    ``...`` lines (flags added to the command before them)."""
    with open(os.path.join(demos.DOCS, folder, "NOTES.md")) as f:
        code = "\n".join(f.read().split("```")[1::2])
    code = re.sub(r"<pseudo-GT[^>]*>", "SET", code).replace("\\\n", " ")
    cmds, extra = [], []
    for ln in code.splitlines():
        ln = ln.strip()
        if ln.startswith("python -m yolofastest_tpu "):
            cmds.append(shlex.split(ln)[3:])
        elif ln.startswith("... "):
            extra.append(shlex.split(ln[4:]))
    return cmds, extra


def _jax_commands(name):
    """``{label: JAX argv}`` of a demo's runs: written down in its NOTES.md
    (distill, scratch), else the recipe's derived command."""
    r = demos.DEMOS[name]
    derived = shlex.split(r.jax.split("yolofastest_tpu ", 1)[1])
    if name == "distill":
        (control,), (teacher,) = _notes_commands(r.record)
        return derived, {"seed0/control": control, "seed0/distill": control + teacher}
    if name == "scratch":
        (cmd,), _ = _notes_commands(r.record)
        return derived, {"uninterrupted": cmd, "stopped": cmd,
                         "resumed": cmd + ["--resume", "latest"]}
    return derived, {"run": derived}


def _dest_rule(ours, theirs, out):
    if ours is None or theirs is None:
        return ours is None and theirs is None
    if "weights/" in theirs:  # a committed zoo file, read where it is
        return ours == os.path.join(demos.WEIGHTS, theirs.rsplit("weights/", 1)[1])
    return ours.startswith(out + "/")  # a made set, seed or output, under --out


@pytest.mark.parametrize("name", NAMES)
def test_printed_commands_parse_as_jax(name, tmp_path):
    from yolofastest_torch.cli import build_parser
    from yolofastest_tpu.cli.parser import build_parser as jax_build_parser

    out = str(tmp_path / "out")
    lines = _printed(name, out)
    assert not os.path.exists(out)  # --print runs nothing
    ours = [shlex.split(ln.split("yolofastest_torch ", 1)[1]) for ln in lines
            if "-m yolofastest_torch train " in ln]
    labels = [label for label, _ in demos.runs(name, out)]
    assert ours == [argv for _, argv in demos.runs(name, out)]
    parser, jax_parser = build_parser(), jax_build_parser()
    derived, jax = _jax_commands(name)
    # the recipe's own record of JAX's command says the same (paths apart)
    first = vars(jax_parser.parse_args(next(iter(jax.values()))))
    assert {k: v for k, v in vars(jax_parser.parse_args(derived)).items()
            if k not in PATH_DESTS | {"fn"}} == {k: v for k, v in first.items()
                                                 if k not in PATH_DESTS | {"fn"}}
    for label, argv in zip(labels, ours):
        pn = vars(parser.parse_args(argv))
        seed = int(label[4]) if label.startswith("seed") else 0
        if seed:  # the extra seeds: the preset through --config-json
            assert pn.pop("config_json") == demos.config_json(out, seed)
            pn["config"], pn["config_json"] = "lite-256x320", None
            label = label.replace(f"seed{seed}", "seed0")
        jn = vars(jax_parser.parse_args(jax[label]))
        assert pn.pop("device") == "cuda" and pn.pop("float64") is False
        assert pn.keys() == jn.keys()
        for dest in PATH_DESTS:
            assert _dest_rule(pn.pop(dest), jn.pop(dest), out), (label, dest)
        pn.pop("fn"), jn.pop("fn")
        assert pn == jn, label
    # the set and start commands: the tools' flags, outputs under --out
    r = demos.DEMOS[name]
    tools = [shlex.split(ln)[1:] for ln in lines if ln.startswith("python3 tools/")]
    assert tools[0] == ["tools/torch_make_finetune_set.py", "--out",
                        demos.set_dir(out, r.res, r.copies), "--copies", str(r.copies),
                        "--res", r.res]
    if r.start == "lite_seed":
        assert tools[1] == ["tools/torch_make_lite_seed.py", "--out",
                            demos.seed_path(out, name), "--res", r.res]
    assert all(t[t.index("--out") + 1].startswith(out + "/") for t in tools)
    # --float64 adds train's --float64 to each run and changes nothing else
    lines64 = _printed(name, out, "--float64")
    assert not os.path.exists(out)
    assert len(lines64) == len(lines)
    for ln, ln64 in zip(lines, lines64):
        if "-m yolofastest_torch train " in ln:
            argv64 = shlex.split(ln64)
            assert argv64.count("--float64") == 1
            argv64.remove("--float64")
            assert argv64 == shlex.split(ln)
        else:
            assert ln64 == ln


def test_seed_configs_change_only_the_seed(tmp_path):
    preset = get_config("lite-256x320")
    for seed in demos.SEEDS[1:]:
        path = demos.write_seed_config(str(tmp_path), seed)
        assert path == demos.config_json(str(tmp_path), seed)
        with open(path) as f:
            cfg = Config.from_json(f.read())
        assert cfg == dataclasses.replace(preset, train=dataclasses.replace(preset.train,
                                                                            seed=seed))


@pytest.mark.parametrize("name", NAMES)
def test_lr_schedule_matches_jax_log(name):
    r = demos.DEMOS[name]
    preset = get_config(r.config)
    warmup = int(r.flag("--warmup-min-iters", preset.train.warmup_min_iters))
    for folder, rec in demos.jax_record(name).items():
        sched = make_lr_schedule(preset.train.lr0, r.epochs, rec["bpe"], warmup)
        steps = np.array([s for s, _ in rec["lr"]])
        assert len(steps) >= 7 and steps.max() <= r.epochs * rec["bpe"]
        ours = sched(torch.from_numpy(steps - 1)).numpy()  # the step's update: step - 1 before it
        np.testing.assert_allclose(ours, [lr for _, lr in rec["lr"]], rtol=1e-6, err_msg=folder)


@pytest.mark.parametrize("name", NAMES)
def test_set_sizes_match_jax_log(name):
    r = demos.DEMOS[name]
    boxes = np.load(os.path.join(ROOT, "tests", "fixtures", f"golden_{r.res}.npz"))["boxes"]
    frames = len(np.unique(boxes[:, 0]))
    assert frames == {"256x320": 20, "512x640": 19}[r.res]
    for folder, rec in demos.jax_record(name).items():
        assert rec["items"] == [frames * r.copies, frames], folder
        assert rec["bpe"] == frames * r.copies // r.batch, folder


# ------------------------------------------------------ the resume fault
def test_skip_epochs_continues_the_stream(tmp_path):
    """Two epochs of a loader against a fresh loader that skipped the first:
    the second epoch's batches (order, augmentation) bit for bit."""
    from tests.test_train import tiny_config
    from yolofastest_torch.data import DetectionLoader, VOCIndex, write_synthetic_voc

    cfg = Config.from_json(tiny_config().to_json())
    root = str(tmp_path / "voc")
    write_synthetic_voc(root, 8, cfg.io.origin_img_shape[:2], cfg.io.class_names)
    index = VOCIndex(root, cfg.io.class_names)
    first = DetectionLoader(index, cfg, batch_size=4, seed=5)
    epochs = [list(first) for _ in range(2)]
    resumed = DetectionLoader(index, cfg, batch_size=4, seed=5)
    resumed.skip_epochs(1)
    again = list(resumed)
    assert len(again) == len(epochs[1]) == 2
    for (a, ta), (b, tb) in zip(again, epochs[1]):
        assert np.array_equal(a, b) and np.array_equal(ta, tb)
    assert not np.array_equal(epochs[0][0][0], epochs[1][0][0])


def test_cli_resume_equals_uninterrupted(tmp_path):
    """``train --resume latest`` from epoch_0 of a two-epoch run ends with
    the uninterrupted run's state (weights, statistics, both moments, step)
    bit for bit, and logs its metrics."""
    from tests.test_train import tiny_config
    from yolofastest_torch.cli import main
    from yolofastest_torch.data import write_synthetic_voc

    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, batch_size=4, total_epochs=2, val_after_epoch=99, log_every=1,
        ema_decay=0.0))
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(jcfg.to_json())
    data = str(tmp_path / "voc")
    write_synthetic_voc(data, 8, jcfg.io.origin_img_shape[:2], jcfg.io.class_names)

    def train(run, *extra):
        return main(["train", "--config-json", str(cfg_json), "--train-dir", data,
                     "--checkpoint-dir", str(tmp_path / run / "ck"), "--log-dir",
                     str(tmp_path / run / "logs"), "--max-to-keep", "0", "--device", "cpu",
                     *extra])

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one rounding for both runs
    try:
        assert train("full") == 0
        os.makedirs(tmp_path / "resumed" / "ck")
        shutil.copytree(tmp_path / "full" / "ck" / "epoch_0",
                        tmp_path / "resumed" / "ck" / "epoch_0")
        assert train("resumed", "--resume", "latest") == 0
    finally:
        torch.set_num_threads(threads)
    state = demos.bit_equal_checkpoints(str(tmp_path / "full" / "ck" / "epoch_1"),
                                        str(tmp_path / "resumed" / "ck" / "epoch_1"))
    assert state["equal"], state
    full = demos.read_metrics(str(tmp_path / "full" / "logs" / "metrics.jsonl"))
    resumed = demos.read_metrics(str(tmp_path / "resumed" / "logs" / "metrics.jsonl"))
    assert len(full) == 4 and len(resumed) == 2
    for a, b in zip(full[2:], resumed):
        assert {k: a[k] for k in demos.CHECKED_FIELDS if k in a} == \
            {k: b[k] for k in demos.CHECKED_FIELDS if k in b}
    # the driver's and chip_smoke.py's rule says the same
    res = demos.resume_check(str(tmp_path / "full"), str(tmp_path / "resumed"), bpe=2,
                             start_epoch=1)
    assert res["final_state"] == state and res["metric_lines_after_resume"] == 2
    assert res["metric_lines_differ"] == [] and res["validations_after_resume"] == 0


def _tiny_train(tmp_path, run, *extra, **train_fields):
    """``train`` of the tiny config from the 256x320 zoo for one epoch of two
    B=4 steps on 8 synthetic images, validating on them; returns its rc."""
    from tests.test_train import tiny_config
    from yolofastest_torch.cli import main
    from yolofastest_torch.data import write_synthetic_voc

    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, batch_size=4, total_epochs=1, val_after_epoch=-1, log_every=1,
        warmup_min_iters=1, **train_fields))
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(jcfg.to_json())
    data = str(tmp_path / "voc")
    if not os.path.isdir(data):
        write_synthetic_voc(data, 8, jcfg.io.origin_img_shape[:2], jcfg.io.class_names)
    return main(["train", "--config-json", str(cfg_json), "--train-dir", data, "--val-dir", data,
                 "--pretrained", os.path.join(demos.WEIGHTS, "yolofastest_256x320.npz"),
                 "--checkpoint-dir", str(tmp_path / run / "ck"), "--log-dir",
                 str(tmp_path / run / "logs"), "--device", "cpu", *extra])


def test_freeze_check_pins_the_backbone(tmp_path):
    """The driver's and chip_smoke.py's freeze rule on a ``--freeze
    backbone`` run: the 48 modules that the log names are bit-equal to the
    zoo in the checkpoint, and both heads moved."""
    assert _tiny_train(tmp_path, "freeze", "--freeze", "backbone", lr0=1e-2) == 0
    f = demos.freeze_check(str(tmp_path / "freeze" / "logs" / "train_info.log"),
                           str(tmp_path / "freeze" / "ck" / "epoch_0"),
                           os.path.join(demos.WEIGHTS, "yolofastest_256x320.npz"))
    assert len(f["pinned"]) == f["pinned_bit_equal"] == 48
    assert f["others"] == f["moved"] == ["head_4", "head_5"]


def test_train_float64_runs_in_float64(tmp_path):
    """``train --float64``: the steps and the checkpointed state in float64,
    validation as in fp32; not with ``--bf16``."""
    from yolofastest_torch.train.trainer import CHECKPOINT_FILE

    assert _tiny_train(tmp_path, "f64", "--float64") == 0
    state = torch.load(tmp_path / "f64" / "ck" / "epoch_0" / CHECKPOINT_FILE, weights_only=True)
    floats = [t for t in _tensors(state) if t.is_floating_point()]
    assert floats and {t.dtype for t in floats} == {torch.float64}
    assert len(demos.read_validations(str(tmp_path / "f64" / "logs" / "train_info.log"))) == 1
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        _tiny_train(tmp_path, "both", "--float64", "--bf16")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
