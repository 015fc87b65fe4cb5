"""The port's training path against the JAX package's, on the CPU, from the
same numpy inputs: the trainable model (eval and train mode, the BatchNorm
statistics), the weights bridge, the YOLOv3 loss and its gradient, the LR
schedule, the data loader, the train step (Adam, the skipped non-finite
step, clip, EMA, freeze, the multi-scale bucket sizes), checkpoints,
distillation, ``Detector(fold_bn=False)`` and the ``train``/``eval``
commands.

The JAX references that need a compile (the train step in fp32 and in
float64, the forwards, the detector, the ``eval`` command) run in the worker
processes of ``tests/_jax_refs.py``; the tests that read them come last.
The data-parallel run (two gloo ranks of ``tests/_torch_ranks.py``, each
on half of every batch) is held to the same float64 JAX run as the
one-process run; ``tests/_background.py`` starts its ranks some modules
earlier.

fp32 gradients of this model are ill-conditioned per leaf: train-mode
BatchNorm over few samples (24 a channel at stride 32) turns the rounding of
the forward into relative errors of up to a few 1e-2 per leaf, so two fp32
implementations differ by far more than the loss does.  The arbiter is the
JAX Trainer run in float64 (``_jax_trajectory(..., float64=True)``): the
port's own float64 run must equal it to ``FLOAT64_TOL`` per leaf, which
holds the formulas, and the port's fp32 leaves are then judged against it
(:func:`_judge`): a leaf matches directly when it is within the stated
tolerance of JAX's fp32 leaf or of the float64 one; else it may only be as
far from float64 as fp32 rounding takes JAX's own fp32 run
(``FLOAT64_SLACK`` times, with JAX there within ``NOISE_CAP``; after
several steps, JAX's typical distance over the part).  Each part
also needs a share of direct matches (``DIRECT_FLOOR``), and taken as one
vector it must be within the tolerance of float64 or as close as JAX's.
Leaves whose float64 gradient is zero (the BatchNorm biases of linear layers that
only feed train-mode BatchNorm) carry rounding noise in both fp32 runs and
are held to being noise.
"""

import atexit
import dataclasses
import importlib
import os
import re
import shutil
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from chip_smoke import make_frames
from tests._background import two_rank_processes  # noqa: F401 (a fixture)
from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from tests.test_train import tiny_config
from yolofastest_torch.configs import Config, get_config
from yolofastest_torch.data import DetectionLoader, VOCIndex, write_synthetic_voc
from yolofastest_torch.inference import Detector, detections_to_lists
from yolofastest_torch.losses import build_targets, decode_for_eval, total_loss, yolo_loss
from yolofastest_torch.models import load_variables, zoo_path
from yolofastest_torch.models.convert import module_state_from_variables, variables_from_module
from yolofastest_torch.models.yolo_fastest import build_model
from yolofastest_torch.train import (Trainer, checkpoint_variables,
                                     clip_by_global_norm, distill_loss, freeze_masks,
                                     make_lr_schedule, make_teacher_fn)
from yolofastest_torch.train.trainer import ema_decay_at
from yolofastest_tpu.data import DetectionLoader as JDetectionLoader
from yolofastest_tpu.data import VOCIndex as JVOCIndex
from yolofastest_tpu.losses import decode_for_eval as jdecode_for_eval
from yolofastest_tpu.losses import yolo_loss as jyolo_loss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
ZOO_FP = ("256x320", "512x640", "pruned040_256x320", "lite_256x320", "lite_512x640")
FLOAT64_TOL = 1e-9  # the port's float64 run against JAX's, relative L2 a leaf
FLOAT64_SLACK = 4.0  # a fallback leaf: at most this many times JAX's fp32 noise (_judge)
NOISE_CAP = 0.25  # ... where JAX's fp32 leaf is within this of float64
# the share of leaves a part must match directly (measured: grad 0.38, the
# moments 0.14-0.15, the rest 1.0)
DIRECT_FLOOR = {"grad": 0.3, "params": 0.95, "batch_stats": 0.95, "ema": 0.95, "mu": 0.1,
                "nu": 0.1}
COMPONENTS = ("total", "x", "y", "w", "h", "conf", "cls")
PARTS = ("params", "batch_stats", "ema", "mu", "nu")


def _jcfg():
    """The tiny 64x96 config, trained from the zoo weights at lr0 1e-4 with a
    2-step warmup floor (one batch an epoch: num_warm 3, so the LR is
    non-zero from the second accepted update), EMA 0.9 ramped over 2."""
    cfg = tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr0=1e-4, warmup_min_iters=2, ema_decay=0.9, ema_ramp=2, batch_size=4))


def _cfg(jcfg=None) -> Config:
    return Config.from_json((jcfg or _jcfg()).to_json())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _rel_all(a, b, keys):
    """Relative L2 over the leaves ``keys`` taken as one vector."""
    d = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in keys)
    return float(np.sqrt(d / sum(float(np.sum(b[k] ** 2)) for k in keys)))


def _judge(part, port, ref, exact, tol, skip=(), trajectory=False):
    """Judge the port's fp32 leaves of ``part`` by the rule of the module
    docstring (``ref``: JAX fp32, ``exact``: JAX float64); prints and returns
    the counts, and asserts the rule, the part's direct floor and that over
    the whole part the port is within ``tol`` of float64 or as close as JAX.

    A fallback leaf's noise is JAX's fp32 distance from float64 on that
    leaf.  With ``trajectory`` (a state after several steps, whose later
    gradients were taken at weights that already differ by rounding, so the
    divergence lands on different leaves in each run) it is the larger of
    that and JAX's median distance over the part."""
    keys = [k for k in exact if k not in skip]
    dist = {k: (_rel(port[k], exact[k]), _rel(ref[k], exact[k])) for k in keys}
    typical = float(np.median([rj for _, rj in dist.values()])) if trajectory else 0.0
    direct, fallback, bad = [], [], []
    for k in keys:
        rp, rj = dist[k]
        if min(_rel(port[k], ref[k]), rp) <= tol:
            direct.append(k)
        elif rj <= NOISE_CAP and rp <= FLOAT64_SLACK * max(rj, typical):
            fallback.append(rp / max(rj, typical))
        else:
            bad.append((k, rp, rj))
    whole = (_rel_all(port, exact, keys), _rel_all(ref, exact, keys))
    median = [float(np.median([d[i] for d in dist.values()])) for i in (0, 1)]
    print(f"{part}: {len(direct)}/{len(keys)} leaves within {tol:g} directly, "
          f"{len(fallback)} by the float64 rule (worst ratio to the noise "
          f"{max(fallback, default=0.0):.2f}); from float64, median leaf: port "
          f"{median[0]:.3g}, JAX {median[1]:.3g}; whole part: port {whole[0]:.3g}, "
          f"JAX {whole[1]:.3g}")
    assert not bad, (part, bad[:5])
    assert len(direct) >= DIRECT_FLOOR[part] * len(keys), (part, len(direct), len(keys))
    assert whole[0] <= max(whole[1], tol), (part, whole)
    return len(direct), len(fallback)


def _zero_leaves(grad):
    """Leaves whose float64 gradient is zero up to rounding."""
    norm = np.sqrt(sum(float(np.sum(v ** 2)) for v in grad.values()))
    return {k for k, v in grad.items() if np.linalg.norm(v) < 1e-9 * norm}


# ---------------------------------------------------------- shared inputs
_INPUTS = {}


def train_inputs():
    """Made once per process, in a temporary directory removed at exit: 16
    synthetic VOC images (128x192), four augmented B=4 batches of the JAX
    loader over them, the 256x320 zoo weights, and the golden frames as a
    VOC set."""
    if not _INPUTS:
        root = tempfile.mkdtemp(prefix="yf_torch_train_")
        atexit.register(shutil.rmtree, root, True)
        jcfg = _jcfg()
        dataset = os.path.join(root, "voc")
        write_synthetic_voc(dataset, 16, jcfg.io.origin_img_shape[:2], jcfg.io.class_names)
        _INPUTS.update(
            root=root, dataset=dataset,
            batches=list(JDetectionLoader(JVOCIndex(dataset, jcfg.io.class_names), jcfg,
                                          batch_size=4, seed=3)),
            zoo=load_variables(zoo_path("256x320")),
            golden_voc=_write_golden_voc(os.path.join(root, "golden_voc")))
    return _INPUTS


@pytest.fixture(scope="module")
def dataset():
    return train_inputs()["dataset"]


@pytest.fixture(scope="module")
def batches():
    return train_inputs()["batches"]


@pytest.fixture(scope="module")
def zoo():
    return train_inputs()["zoo"]


@pytest.fixture(scope="module")
def golden_voc():
    return train_inputs()["golden_voc"]


def _sequence(batches):
    """A, a non-finite batch, B, C: three accepted steps and one skipped."""
    nan = batches[1][0].copy()
    nan[0, 0, 0, 0] = np.nan
    return [batches[0], (nan, batches[1][1]), batches[1], batches[2]]


def _jax_trajectory(batches, zoo, float64=False, mesh_shape=None, jcfg=None):
    """The JAX Trainer over :func:`_sequence` on one CPU device: metrics of
    each step, the gradient of step 0 (its Adam first moment / 0.1), and the
    state after the last step.  With ``mesh_shape`` ``(n_data, n_spatial)``
    the Trainer runs over ``batches`` themselves on a ``("data",
    "spatial")`` mesh of the first virtual devices, with
    ``shard_spatial=True``; with ``jcfg`` (a JAX config in place of
    :func:`_jcfg`), over ``batches`` themselves on one device.

    ``float64``: the same with x64 enabled, float64 weights, inputs and
    compute dtype.  The loss module casts to float32 by name
    (``jnp.float32``), so for this run its ``jnp`` is a copy whose
    ``float32`` is float64; the EMA decay and the LR schedule stay float32,
    as the port computes them too."""
    from yolofastest_tpu.train import Trainer as JTrainer

    loss_module = importlib.import_module("yolofastest_tpu.losses.yolo_loss")
    saved = loss_module.jnp
    dt = np.float64 if float64 else np.float32
    if float64:
        loss_module.jnp = types.SimpleNamespace(
            **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
        loss_module.jnp.float32 = jnp.float64
        zoo = jax.tree.map(lambda a: np.asarray(a, dt), zoo)
    try:
        with jax.enable_x64(float64):
            if mesh_shape is None:
                mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
                steps = _sequence(batches) if jcfg is None else batches
            else:
                devs = np.array(jax.devices()[:mesh_shape[0] * mesh_shape[1]])
                mesh, steps = Mesh(devs.reshape(mesh_shape), ("data", "spatial")), batches
            jt = JTrainer(jcfg or _jcfg(), mesh=mesh, batch_per_epoch=1, variables=zoo,
                          compute_dtype=jnp.dtype(dt), shard_spatial=mesh_shape is not None)
            out = {"metrics": []}
            for i, (imgs, tgts) in enumerate(steps):
                m = jt.step(imgs.astype(dt), tgts.astype(dt))
                out["metrics"].append({k: float(v) for k, v in m.items()})
                adam = jt.state.opt_state.inner_state[0][0]
                if i == 0:
                    out["grad"] = {k: v / 0.1 for k, v in _flat(jax.device_get(adam.mu)).items()}
            assert jax.tree.leaves(jt.state.params)[0].dtype == dt
            out["state"] = {
                "params": _flat(jax.device_get(jt.state.params)),
                "batch_stats": _flat(jax.device_get(jt.state.batch_stats)),
                "mu": _flat(jax.device_get(adam.mu)), "nu": _flat(jax.device_get(adam.nu)),
                "ema": _flat(jax.device_get(jt.state.ema["params"]))}
            return out
    finally:
        loss_module.jnp = saved


def _ms_jcfg():
    """The 256x320 preset as the multiscale demo trains it (``--multiscale
    1``: buckets 224x288, 256x320 and 288x352), at B=2 with :func:`_jcfg`'s
    learning rate, warmup floor and EMA, the bucket redrawn every batch."""
    from yolofastest_tpu.configs import get_config as jget_config

    cfg = jget_config("256x320")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr0=1e-4, warmup_min_iters=2, ema_decay=0.9, ema_ramp=2, batch_size=2,
        multiscale_steps=1, multiscale_every=1))


def multiscale_batches():
    """One batch at each bucket shape of the multiscale demo, in its order
    of first use (288x352, 256x320, 224x288): the first batch of each shape
    that JAX's loader gives over the synthetic set (seed 0, augmentation
    on)."""
    if "multiscale" not in _INPUTS:
        jcfg = _ms_jcfg()
        loader = JDetectionLoader(JVOCIndex(train_inputs()["dataset"], jcfg.io.class_names),
                                  jcfg, batch_size=2, seed=0)
        found = {}
        for _ in range(4):
            for imgs, tgts in loader:
                found.setdefault(imgs.shape[1:3], (imgs, tgts))
        _INPUTS["multiscale"] = [found[hw] for hw in ((288, 352), (256, 320), (224, 288))]
    return _INPUTS["multiscale"]


def _jax_forwards(zoo):
    """JAX ``model.apply`` on 2 random 64x96 inputs: the eval heads of the
    five fp zoo files (one jit per structure), and the train-mode heads and
    new batch_stats of the 256x320 weights on 4 inputs, in fp32 and (x64,
    float64 weights, inputs and compute dtype) in float64."""
    from yolofastest_tpu.models import build_model as jbuild_model

    rng = np.random.default_rng(0)
    x2 = rng.uniform(-0.5, 0.5, (2, 64, 96, 1)).astype(np.float32)
    x4 = rng.uniform(-0.5, 0.5, (4, 64, 96, 1)).astype(np.float32)
    out = {"x2": x2, "x4": x4, "eval": {}}
    fns = {}
    for name in ZOO_FP:
        v = load_variables(zoo_path(name))
        arch = "lite" if name.startswith("lite") else "fastest"
        model = jbuild_model(3, 3, arch=arch, variables=v)
        key = (arch, model.inner_widths)
        if key not in fns:
            fns[key] = jax.jit(lambda v, x, m=model: m.apply(v, x, train=False))
        heads = fns[key](v, jnp.asarray(x2))
        out["eval"][name] = [np.asarray(h) for h in (heads if isinstance(heads, tuple)
                                                     else (heads,))]
    model = jbuild_model(3, 3, variables=zoo)
    heads, upd = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(
        zoo, jnp.asarray(x4))
    out["train_heads"] = [np.asarray(h) for h in heads]
    out["train_stats"] = _flat(jax.device_get(upd["batch_stats"]))
    with jax.enable_x64(True):
        z64 = jax.tree.map(lambda a: np.asarray(a, np.float64), zoo)
        model = jbuild_model(3, 3, compute_dtype=jnp.float64, variables=z64)
        heads, upd = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(
            z64, jnp.asarray(x4.astype(np.float64)))
        assert heads[0].dtype == jnp.float64
        out["train_heads64"] = [np.asarray(h) for h in heads]
        out["train_stats64"] = _flat(jax.device_get(upd["batch_stats"]))
    return out


def _teacher_input():
    return np.random.default_rng(1).uniform(-0.5, 0.5, (2, 64, 96, 1)).astype(np.float32)


def _student_head(teacher_small):
    """A stand-in student head: the teacher's small head plus seeded noise."""
    noise = np.random.default_rng(2).standard_normal(teacher_small.shape).astype(np.float32)
    return np.asarray(teacher_small) + 0.5 * noise


def _jax_teacher(zoo):
    from yolofastest_tpu.train import distill_loss as jdistill_loss
    from yolofastest_tpu.train import make_teacher_fn as jmake_teacher_fn

    heads = jax.jit(jmake_teacher_fn(zoo))(jnp.asarray(_teacher_input()))
    student = jnp.asarray(_student_head(heads[1]))
    return [np.asarray(h) for h in heads], float(jdistill_loss((student,), heads))


def _golden_frames(n):
    return make_frames(np.load(os.path.join(FIXTURES, "golden_256x320.npz"))["pre_imgs"][:n])


def _jax_detector_unfolded(zoo):
    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.inference import Detector as JDetector

    det = JDetector(jget_config("256x320"), variables=zoo, fold_bn=False)
    return {k: np.asarray(v) for k, v in det.run_raw(jnp.asarray(_golden_frames(2))).items()}


def _jax_cli_eval(val_dir, log_dir, json_out):
    """The JAX ``eval`` command on the golden VOC set with the zoo weights;
    its metrics come back through --json-out."""
    import json

    from yolofastest_tpu.cli import main as jmain

    rc = jmain(["eval", "--config", "256x320", "--weights", zoo_path("256x320"),
                "--val-dir", val_dir, "--log-dir", log_dir, "--json-out", json_out])
    with open(json_out) as f:
        return rc, json.load(f)


def _write_golden_voc(root):
    """The 20 golden frames (512x640 BGR) as a VOC set under ``root``,
    labelled with the golden_map.npz targets."""
    import cv2

    from yolofastest_torch.data import write_voc_xml

    os.makedirs(os.path.join(root, "img"))
    os.makedirs(os.path.join(root, "xml"))
    targets = np.load(os.path.join(FIXTURES, "golden_map.npz"))["targets"]
    names = get_config("256x320").io.class_names
    for i, frame in enumerate(_golden_frames(20)):
        cv2.imwrite(os.path.join(root, "img", f"g{i:02d}.jpg"), frame)
        rows = targets[i][targets[i][:, 5] > 1]
        boxes = [(names[int(c)], (xc - w / 2) * 640, (yc - h / 2) * 512, (xc + w / 2) * 640,
                  (yc + h / 2) * 512) for xc, yc, w, h, c, _ in rows]
        write_voc_xml(os.path.join(root, "xml", f"g{i:02d}.xml"), f"g{i:02d}.jpg", (512, 640),
                      boxes)
    return root


def _cli_eval_args():
    out = os.path.join(train_inputs()["root"], "jax_eval")
    return (train_inputs()["golden_voc"], os.path.join(out, "logs"),
            os.path.join(out, "metrics.json"))


register("train/trajectory", _jax_trajectory,
         lambda: (train_inputs()["batches"], train_inputs()["zoo"]))
register("train/trajectory64", _jax_trajectory,
         lambda: (train_inputs()["batches"], train_inputs()["zoo"], True), early=True)
register("train/multiscale64", _jax_trajectory,
         lambda: (multiscale_batches(), train_inputs()["zoo"], True, None, _ms_jcfg()),
         tests=("test_float64_steps_at_the_multiscale_buckets_match_jax",), early=True)
register("train/forwards", _jax_forwards, lambda: (train_inputs()["zoo"],))
register("train/detector", _jax_detector_unfolded, lambda: (train_inputs()["zoo"],))
register("train/teacher", _jax_teacher, lambda: (train_inputs()["zoo"],))
register("train/cli_eval", _jax_cli_eval, _cli_eval_args)


@pytest.fixture(scope="module")
def port_trajectories(batches, zoo):
    """The port's Trainer over :func:`_sequence`, in fp32 and in float64, on
    the CPU; the leaves are read out in the run's dtype."""
    return {dt: _port_run(_cfg(), _sequence(batches), zoo, dt)
            for dt in (torch.float32, torch.float64)}


def _port_run(cfg, steps, zoo, dt):
    """The port's Trainer over ``steps`` on the CPU in ``dt``, recorded as
    :func:`_jax_trajectory` records JAX's, with the state before and after
    each step."""
    t = Trainer(cfg, batch_per_epoch=1, variables=zoo, device="cpu")
    if dt == torch.float64:
        t.to_float64()
    run = {"metrics": [], "states": []}
    fields = ("params", "batch_stats", "mu", "nu", "count")
    for i, (imgs, tgts) in enumerate(steps):
        before = {f: getattr(t.state, f).clone() for f in fields}
        m = t.step(torch.from_numpy(imgs).to(dt), torch.from_numpy(tgts).to(dt))
        run["metrics"].append({k: float(v) for k, v in m.items()})
        run["states"].append((before, {f: getattr(t.state, f).clone() for f in fields},
                              t.state.step))
        if i == 0:
            run["grad"] = _port_tree(t, t.state.mu * 10.0, t.state.batch_stats)["params"]
    s = t.state
    run["state"] = {
        **_port_tree(t, s.params, s.batch_stats),
        "mu": _port_tree(t, s.mu, s.batch_stats)["params"],
        "nu": _port_tree(t, s.nu, s.batch_stats)["params"],
        "ema": _port_tree(t, s.ema[0], s.ema[1])["params"]}
    return run


@pytest.fixture(scope="module")
def two_ranks(two_rank_processes):  # noqa: F811
    """Each rank's record (``trajectory_rank``), once both have exited."""
    procs, outs = two_rank_processes
    for p in procs:
        p.join(timeout=300)
    assert [p.exitcode for p in procs] == [0, 0], [p.exitcode for p in procs]
    return [torch.load(o, weights_only=False) for o in outs]


def _port_tree(trainer, params, stats):
    """Flat {"params": {path: array}, "batch_stats": ...} in the vectors' dtype."""
    return {k: _flat(v) for k, v in trainer._tree(params, stats).items()}


# ------------------------------------------------------- model and weights
@pytest.mark.parametrize("name", ZOO_FP)
def test_state_round_trip_bitwise(name, jax_refs):
    """flax tree -> state_dict -> flax tree is bitwise, and the model loads it
    with every key and shape."""
    v = load_variables(zoo_path(name))
    model = build_model(3, 3, arch="lite" if name.startswith("lite") else "fastest",
                        variables=v)
    want, back = _flat(v), _flat(variables_from_module(model))
    assert back.keys() == want.keys()
    for k, a in want.items():
        assert a.shape == back[k].shape
        np.testing.assert_array_equal(a, back[k])
    assert module_state_from_variables(v).keys() == model.state_dict().keys()


def test_init_layout_matches_jax():
    """A fresh init has the JAX init's tree (names, shapes, dtypes), the
    flax statistics (mean 0, var 1) and BN scale ~ N(1, 0.02)."""
    from yolofastest_tpu.models import build_model as jbuild_model

    jtree = jax.eval_shape(lambda: jbuild_model(3, 3).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 1)), train=False))
    ours = variables_from_module(build_model(3, 3, seed=1))
    want = {k: v.shape for k, v in _flat(jax.tree.map(lambda s: np.zeros(s.shape), jtree)).items()}
    assert {k: v.shape for k, v in _flat(ours).items()} == want
    scales = np.concatenate([v for k, v in _flat(ours["params"]).items() if k.endswith("scale")])
    assert abs(scales.mean() - 1.0) < 0.01 and 0.015 < scales.std() < 0.025
    assert all((v == 0).all() for k, v in _flat(ours["batch_stats"]).items() if k.endswith("mean"))


# -------------------------------------------------------------------- loss
def _golden_loss():
    return np.load(os.path.join(FIXTURES, "golden_loss.npz"))


def _nhwc(head_nchw):
    return np.ascontiguousarray(np.transpose(head_nchw, (0, 2, 3, 1)))


@pytest.mark.parametrize("scale", [0, 1])
def test_loss_matches_golden(scale):
    """The reference's 7 loss numbers of each scale (golden_loss.npz) at the
    JAX test's tolerance (tests/test_loss_parity.py:52)."""
    cfg = get_config("256x320")
    g = _golden_loss()
    tot, comps = yolo_loss(torch.from_numpy(_nhwc(g[f"head{scale}"])),
                           torch.from_numpy(g["targets"]), cfg.io.anchors[scale],
                           cfg.io.input_hw, cfg.train.iou_loss_thre, cfg.io.num_cls)
    got = np.array([float(tot)] + [float(comps[k]) for k in COMPONENTS[1:]])
    np.testing.assert_allclose(got, g[f"scale{scale}"], rtol=2e-5, atol=2e-6)


def test_total_loss_sums_scales():
    cfg = get_config("256x320")
    g = _golden_loss()
    heads = [torch.from_numpy(_nhwc(g[f"head{s}"])) for s in (0, 1)]
    tot, comps = total_loss(heads, torch.from_numpy(g["targets"]), cfg.io.anchors,
                            cfg.io.input_hw, cfg.train.iou_loss_thre, cfg.io.num_cls)
    np.testing.assert_allclose(float(tot), g["scale0"][0] + g["scale1"][0], rtol=2e-5)
    assert set(comps) == {"x", "y", "w", "h", "conf", "cls", "total"}


@pytest.mark.parametrize("scale", [0, 1])
def test_decode_for_eval_matches_jax(scale):
    """Equal to the JAX decode up to an ulp of the exp and sigmoid, and to the
    reference's decode (golden_loss.npz) at the JAX test's 1e-4."""
    cfg = get_config("256x320")
    g = _golden_loss()
    head = _nhwc(g[f"head{scale}"])
    ours = decode_for_eval(torch.from_numpy(head), cfg.io.anchors[scale], cfg.io.input_hw).numpy()
    theirs = np.asarray(jax.jit(jdecode_for_eval, static_argnums=(1, 2))(
        jnp.asarray(head), cfg.io.anchors[scale], cfg.io.input_hw))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours, g[f"decode{scale}"], rtol=1e-4, atol=1e-4)


def test_loss_gradient_matches_jax():
    """d(loss)/d(head) against jax.grad on the golden heads, both scales
    (rtol 1e-5 of the largest entry), and finite at sigmoid saturation."""
    cfg = get_config("256x320")
    g = _golden_loss()
    tg = g["targets"]
    for scale in (0, 1):
        head = _nhwc(g[f"head{scale}"])
        args = (cfg.io.anchors[scale], cfg.io.input_hw, cfg.train.iou_loss_thre, cfg.io.num_cls)
        jg = np.asarray(jax.jit(jax.grad(lambda h: jyolo_loss(h, jnp.asarray(tg), *args)[0]))(
            jnp.asarray(head)))
        h = torch.from_numpy(head).requires_grad_(True)
        yolo_loss(h, torch.from_numpy(tg), *args)[0].backward()
        np.testing.assert_allclose(h.grad.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())
    sat = np.full_like(head, 40.0)
    sat[..., 4::8] = -40.0  # conf channels: sigmoid == 0.0 exactly in float32
    h = torch.from_numpy(sat).requires_grad_(True)
    yolo_loss(h, torch.from_numpy(tg), *args)[0].backward()
    assert torch.isfinite(h.grad).all()


def test_tcls_sticky_and_last_box_wins():
    """Two GTs in one cell with the same best anchor: both class bits set,
    tx/ty from the LATER box (tests/test_loss_parity.py:78-103)."""
    anchors = torch.tensor([[1.0, 1.0], [3.0, 3.0], [9.0, 9.0]])
    h = w = 8
    targets = np.zeros((1, 4, 6), np.float32)
    targets[0, 0] = [2.5 / w, 3.5 / h, 3.0 / w, 3.0 / h, 0, 255.0]
    targets[0, 1] = [2.6 / w, 3.6 / h, 3.0 / w, 3.0 / h, 2, 255.0]
    tgt = build_targets(torch.from_numpy(targets), anchors, (h, w), 0.5, 3)
    assert float(tgt["mask"][0, 1, 3, 2]) == 1.0 and float(tgt["mask"].sum()) == 1.0
    np.testing.assert_array_equal(tgt["tcls"][0, 1, 3, 2].numpy(), [1.0, 0.0, 1.0])
    np.testing.assert_allclose(float(tgt["tx"][0, 1, 3, 2]), 0.6, rtol=1e-5)
    np.testing.assert_allclose(float(tgt["ty"][0, 1, 3, 2]), 0.6, rtol=1e-5)
    # an invalid slot ends the assignment: a valid box after it is not assigned
    targets[0, 1, 5] = 0.0
    targets[0, 2] = [6.5 / w, 6.5 / h, 3.0 / w, 3.0 / h, 1, 255.0]
    tgt = build_targets(torch.from_numpy(targets), anchors, (h, w), 0.5, 3)
    assert float(tgt["mask"].sum()) == 1.0 and float(tgt["mask"][0, 1, 3, 2]) == 1.0


def test_no_positives_gives_zero_cls_loss():
    cfg = get_config("256x320")
    head = torch.from_numpy(_nhwc(_golden_loss()["head0"]))
    tot, comps = yolo_loss(head, torch.zeros(head.shape[0], 64, 6), cfg.io.anchors[0],
                           cfg.io.input_hw, cfg.train.iou_loss_thre, cfg.io.num_cls)
    assert float(comps["cls"]) == 0.0 and float(comps["x"]) == 0.0
    assert np.isfinite(float(tot)) and float(comps["conf"]) > 0


# ---------------------------------------------------------- schedule, data
def test_lr_schedule_matches_reference_formula():
    import math

    lr0, epochs, bpe = 1e-3, 30, 500
    sched = make_lr_schedule(lr0, epochs, bpe, warmup_min_iters=1000)
    num_warm = max(3 * bpe, 1000)
    for it in [0, 1, 100, 1499, 1500, 1501, 5000, 14999]:
        lf = ((1 + math.cos((it // bpe) * math.pi / epochs)) / 2) * 0.8 + 0.2
        np.testing.assert_allclose(float(sched(it)), lr0 * lf * min(it / num_warm, 1.0),
                                   rtol=1e-6)
    assert float(sched(torch.tensor(1500, dtype=torch.int32))) == float(sched(1500))


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_matches_jax(dataset, workers):
    """Batches equal to JAX's DetectionLoader under one seed: blur and flip,
    mosaic, multi-scale buckets and a short last batch (drop_last=False)."""
    jcfg = dataclasses.replace(_jcfg(), augment=dataclasses.replace(_jcfg().augment, mosaic=0.5))
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, multiscale_steps=1, multiscale_every=2))
    cfg = _cfg(jcfg)
    kw = dict(batch_size=6, seed=5, drop_last=False, num_workers=workers, cache=True)
    ours = list(DetectionLoader(VOCIndex(dataset, cfg.io.class_names), cfg, **kw))
    theirs = list(JDetectionLoader(JVOCIndex(dataset, jcfg.io.class_names), jcfg, **kw))
    assert [a[0].shape for a in ours] == [b[0].shape for b in theirs]
    assert [a[0].shape[0] for a in ours] == [6, 6, 4]
    for (ai, at), (bi, bt) in zip(ours, theirs):
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(at, bt)


# ------------------------------------------------------- port-only trainer
def test_ema_first_step_matches_hand_lerp(zoo, batches):
    """ema' = d * ema + (1 - d) * p' with d = decay * (1 - exp(-(step+1) /
    ramp)) at the step before it moves, on params and statistics."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema_decay=0.5,
                                                             ema_ramp=1, lr0=1e-2))
    t = Trainer(cfg, batch_per_epoch=1, variables=zoo, device="cpu")
    for step, (imgs, tgts) in enumerate(batches[:2]):
        ema0 = (t.state.ema[0].clone(), t.state.ema[1].clone())
        t.step(imgs, tgts)
        d = float(ema_decay_at(step, 0.5, 1))
        for e0, new, e1 in zip(ema0, (t.state.params, t.state.batch_stats), t.state.ema):
            np.testing.assert_allclose(e1.numpy(), (d * e0 + (1 - d) * new).numpy(),
                                       rtol=1e-5, atol=1e-7)
    assert not torch.equal(t.state.params, t.state.ema[0])  # the second step moved params
    np.testing.assert_array_equal(_flat(t.eval_variables)["params/head_5/kernel"],
                                  _flat(t.ema_variables)["params/head_5/kernel"])


def test_freeze_masks_match_jax_and_pin_frozen(zoo, batches):
    """The port's freeze_masks gives JAX's names and masks; two steps with
    --freeze backbone leave every frozen weight and statistic bit for bit,
    move the heads, keep the Adam moments of frozen leaves at zero and the
    checkpoint layout of an unfrozen run."""
    from yolofastest_tpu.train import freeze_masks as jfreeze_masks

    for spec in ("backbone", "conv0,res1", "head_4"):
        assert freeze_masks(zoo["params"], zoo["batch_stats"], spec) == jfreeze_masks(
            zoo["params"], zoo["batch_stats"], spec)
    for spec, err in (("nosuchmodule", "matches no module"), (" , ", "empty"),
                      (",".join(zoo["params"]), "every module")):
        with pytest.raises(ValueError, match=err):
            freeze_masks(zoo["params"], zoo["batch_stats"], spec)

    cfg = dataclasses.replace(_cfg(), train=dataclasses.replace(_cfg().train, lr0=1e-2))
    t = Trainer(cfg, batch_per_epoch=1, variables=zoo, freeze="backbone", device="cpu")
    for imgs, tgts in batches[:2]:
        t.step(imgs, tgts)
    after = _flat(t.variables)
    frozen = set(t.frozen_modules)
    assert frozen == {n for n in zoo["params"] if not n.startswith("head")}
    moved = [k for k, v in _flat(zoo).items() if not np.array_equal(v, after[k])]
    assert moved and all(k.split("/")[1].startswith("head") for k in moved)
    ck = t.checkpoint_state()
    assert all(not v.any() for k, v in ck["opt_state"]["mu"].items() if k.split(".")[0] in frozen)
    plain = Trainer(cfg, batch_per_epoch=1, variables=zoo, device="cpu").checkpoint_state()
    assert {k: v.shape for k, v in ck["opt_state"]["mu"].items()} == {
        k: v.shape for k, v in plain["opt_state"]["mu"].items()}


def test_bf16_step_tracks_fp32(zoo, batches):
    """compute_dtype=bfloat16: the weights stay fp32 and the loss is within
    5% of the fp32 step's (tests/test_train.py:288-309)."""
    imgs, tgts = batches[0]
    losses = {}
    for dt in (torch.float32, torch.bfloat16):
        t = Trainer(_cfg(), batch_per_epoch=1, variables=zoo, compute_dtype=dt, device="cpu")
        losses[dt] = float(t.step(imgs, tgts)["total"])
        assert t.state.params.dtype == torch.float32 and np.isfinite(losses[dt])
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) < 0.05 * abs(losses[torch.float32])


def test_checkpoint_restore_then_step_equals_uninterrupted(zoo, batches, tmp_path):
    """Save after two steps, restore into a fresh Trainer (another seed),
    step: the state equals the uninterrupted run's bit for bit."""
    a = Trainer(_cfg(), batch_per_epoch=1, variables=zoo, device="cpu")
    for imgs, tgts in batches[:2]:
        a.step(imgs, tgts)
    path = a.save_checkpoint(str(tmp_path), epoch=0)
    assert os.listdir(path) == ["state.pt"]
    b = Trainer(_cfg(), batch_per_epoch=1, seed=7, device="cpu")
    b.restore_checkpoint(path)
    assert b.state.step == 2
    for t in (a, b):
        t.step(*batches[2])
    for f in ("params", "batch_stats", "mu", "nu", "count", "notfinite_count"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert all(torch.equal(x, y) for x, y in zip(a.state.ema, b.state.ema))


def test_fit_rotates_checkpoints(dataset, tmp_path):
    cfg = dataclasses.replace(_cfg(), train=dataclasses.replace(_cfg().train, max_to_keep=2,
                                                                val_after_epoch=99))
    loader = DetectionLoader(VOCIndex(dataset, cfg.io.class_names), cfg, batch_size=8, seed=4)
    t = Trainer(cfg, batch_per_epoch=len(loader), seed=0, device="cpu")
    history = t.fit(loader, total_epochs=3, checkpoint_dir=str(tmp_path), log_every=1000)
    assert sorted(os.listdir(tmp_path)) == ["epoch_1", "epoch_2"]
    assert [h["epoch"] for h in history] == [0, 1, 2] and t.state.step == 6


def test_ema_checkpoint_elasticity(zoo, batches, tmp_path):
    """EMA state round-trips; resuming across an EMA flip re-seeds or drops
    the average; checkpoint_variables prefers the EMA model."""
    ema_cfg = _cfg()
    plain_cfg = dataclasses.replace(ema_cfg, train=dataclasses.replace(ema_cfg.train,
                                                                       ema_decay=0.0))
    a = Trainer(ema_cfg, batch_per_epoch=1, variables=zoo, device="cpu")
    for imgs, tgts in batches[:2]:
        a.step(imgs, tgts)
    path = a.save_checkpoint(str(tmp_path / "ema"), epoch=0)
    b = Trainer(ema_cfg, batch_per_epoch=1, seed=3, device="cpu")
    b.restore_checkpoint(path)
    assert all(torch.equal(x, y) for x, y in zip(a.state.ema, b.state.ema))
    np.testing.assert_array_equal(_flat(checkpoint_variables(path))["params/conv0/conv/kernel"],
                                  _flat(a.ema_variables)["params/conv0/conv/kernel"])
    np.testing.assert_array_equal(
        _flat(checkpoint_variables(path, prefer_ema=False))["params/conv0/conv/kernel"],
        _flat(a.variables)["params/conv0/conv/kernel"])
    c = Trainer(plain_cfg, batch_per_epoch=1, seed=3, device="cpu")
    c.restore_checkpoint(path)
    assert c.state.ema is None and torch.equal(c.state.params, a.state.params)
    path2 = c.save_checkpoint(str(tmp_path / "plain"), epoch=0)
    d = Trainer(ema_cfg, batch_per_epoch=1, seed=5, device="cpu")
    d.restore_checkpoint(path2)
    assert torch.equal(d.state.ema[0], d.state.params)
    assert torch.equal(d.state.ema[1], d.state.batch_stats)


def test_checkpoint_variables_deploy(zoo, batches, tmp_path):
    """A trained checkpoint through checkpoint_variables into the folded
    Detector: its heads equal the trainable model's eval forward (1e-4 of
    the largest logit), and the unfolded Detector gives the same boxes."""
    t = Trainer(_cfg(), batch_per_epoch=1, variables=zoo, device="cpu")
    for imgs, tgts in batches[:2]:
        t.step(imgs, tgts)
    v = checkpoint_variables(t.save_checkpoint(str(tmp_path), epoch=0))
    cfg = get_config("256x320")
    x = (np.load(os.path.join(FIXTURES, "golden_256x320.npz"))["pre_imgs"][:2].astype(
        np.float32)[..., None] - 128.0) / 255.0
    folded = Detector(cfg, variables=v, device="cpu")
    model = Detector(cfg, variables=v, fold_bn=False, device="cpu")
    for a, b in zip(folded.forward_heads(x), model.forward_heads(x)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4 * float(b.abs().max()))
    ra, rb = detections_to_lists(folded.run(x)), detections_to_lists(model.run(x))
    assert [len(r) for r in ra] == [len(r) for r in rb] and sum(map(len, ra)) > 0
    for r1, r2 in zip(ra, rb):
        np.testing.assert_allclose([r[:4] for r in r1], [r[:4] for r in r2], atol=1.0)


def test_trainer_needs_a_device_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_cfg(), batch_per_epoch=1, seed=0)


def test_clip_matches_optax():
    """clip_by_global_norm against optax's on one gradient, below and above
    the threshold."""
    import optax

    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((3, 3, 1, 8), (8,), (24,))]
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in leaves]))
    norm = float(np.linalg.norm(flat.numpy()))
    for max_norm in (0.5 * norm, 2.0 * norm):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in leaves],
                                                             None)
        got = clip_by_global_norm(flat, max_norm).numpy()
        np.testing.assert_allclose(got, np.concatenate([np.asarray(a).ravel() for a in want]),
                                   rtol=1e-6)
    assert torch.equal(clip_by_global_norm(flat, 2.0 * norm), flat)


# ------------------------------------------------------- against JAX, last
@pytest.mark.parametrize("name", ZOO_FP)
def test_eval_forward_matches_jax(name, jax_refs):
    """The five fp zoo files, eval mode (running statistics), against JAX
    model.apply: 1e-4 of each head's largest logit."""
    ref = jax_refs["train/forwards"]
    arch = "lite" if name.startswith("lite") else "fastest"
    model = build_model(3, 3, arch=arch, variables=load_variables(zoo_path(name))).eval()
    with torch.no_grad():
        heads = model(torch.from_numpy(ref["x2"]))
    heads = heads if isinstance(heads, tuple) else (heads,)
    assert len(heads) == len(ref["eval"][name])
    for ours, theirs in zip(heads, ref["eval"][name]):
        np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-4 * np.abs(theirs).max())


def test_train_mode_forward_and_statistics_match_jax(zoo, jax_refs):
    """Train mode: batch statistics normalise, and the running statistics
    move to 0.9 old + 0.1 batch with the BIASED batch variance, as flax's.

    The formulas: the port's model in float64 equals JAX's float64
    ``mutable=["batch_stats"]`` apply, heads and new statistics, to
    FLOAT64_TOL a leaf.  fp32: each head value within 1e-5 of the head's
    largest value of JAX's fp32 value or of the float64 one; else (the
    module docstring's rule, a value for a leaf) no further from float64
    than FLOAT64_SLACK times JAX's own fp32 head is at its worst.  Train-mode
    BatchNorm over 24 samples a channel lifts fp32 rounding near that
    tolerance: held to JAX's fp32 alone, 1 of the small head's 576 values
    missed (2.2e-4 against an allowed 2.1e-4) with 4 and 8 torch threads, and
    none with 1 and 2.  JAX's own fp32 heads are 8.8e-6 and 1.08e-5 (of the
    largest value) from float64; the port's, at 1, 2, 4 and 8 threads, 4.9e-6
    / 5.0e-6, 3.5e-6 / 3.4e-6, 8.0e-7 / 1.3e-6 and 1.3e-6 / 2.3e-6, so every
    value matches float64 directly.  The port's float64 heads are at most
    1.2e-14 and its statistics 8.9e-15 (relative L2) from JAX's.  The new
    statistics within 1e-5 of the largest value against JAX's fp32;
    nn.BatchNorm2d's unbiased update is far off."""
    ref = jax_refs["train/forwards"]
    model64 = build_model(3, 3, variables=zoo).double().train()
    heads64 = model64(torch.from_numpy(ref["x4"]).double())
    for ours, theirs in zip(heads64, ref["train_heads64"]):
        assert ours.dtype == torch.float64
        assert _rel(ours.detach().numpy(), theirs) <= FLOAT64_TOL
    stats64 = _flat(variables_from_module(model64)["batch_stats"])
    assert max(_rel(stats64[k], v) for k, v in ref["train_stats64"].items()) <= FLOAT64_TOL
    model = build_model(3, 3, variables=zoo).train()
    heads = model(torch.from_numpy(ref["x4"]))
    for ours, theirs, exact in zip(heads, ref["train_heads"], ref["train_heads64"]):
        ours, atol = ours.detach().numpy(), 1e-5 * np.abs(theirs).max()
        direct = np.minimum(np.abs(ours - theirs), np.abs(ours - exact)) <= atol
        noise = np.abs(theirs - exact).max()
        far = np.abs(ours - exact)[~direct]
        print(f"train heads {ours.shape}: {int(direct.sum())}/{direct.size} within {atol:.3g} "
              f"directly; from float64 (of the largest value): port "
              f"{np.abs(ours - exact).max() / np.abs(exact).max():.3g}, JAX "
              f"{noise / np.abs(exact).max():.3g}")
        assert np.all(far <= FLOAT64_SLACK * noise), (far.max(), noise)
    stats = _flat(variables_from_module(model)["batch_stats"])
    worst = max(np.abs(stats[k] - v).max() / np.abs(v).max() for k, v in ref["train_stats"].items())
    assert worst < 1e-5
    # the unbiased update would put n / (n - 1) on the batch variance (n = 24
    # samples a channel at stride 32): far outside that tolerance
    k, n = "conv5_6/bn/var", 4 * 2 * 3
    old, want = _flat(zoo["batch_stats"])[k], ref["train_stats"][k]
    unbiased = 0.9 * old + (want - 0.9 * old) * n / (n - 1)
    assert np.abs(unbiased - want).max() > 100 * np.abs(stats[k] - want).max()


def test_float64_step_matches_jax_float64(jax_refs, port_trajectories):
    """The formulas: the port's Trainer in float64 against the JAX Trainer
    in float64 over the same four steps: every loss component of the
    accepted steps, the step-0 gradient and, after the last step, params,
    statistics, EMA and both Adam moments, each leaf within FLOAT64_TOL
    (relative L2); the zero-gradient leaves are zero on both sides."""
    _assert_float64_matches(jax_refs["train/trajectory64"], port_trajectories[torch.float64])


def test_float64_steps_at_the_multiscale_buckets_match_jax(jax_refs):
    """Multi-scale training: the step at input sizes other than the
    config's.  The 256x320 preset with the multiscale demo's buckets, one
    step at each bucket shape in the demo's order of first use (288x352,
    256x320, 224x288), the port's Trainer in float64 against the JAX
    Trainer in float64 from the zoo on the same batches: every loss
    component of each step, the first step's gradient and, after the
    third, params, statistics, EMA and both Adam moments (which sum the
    gradients of all three shapes), each leaf within FLOAT64_TOL."""
    steps = multiscale_batches()
    assert [imgs.shape[1:3] for imgs, _ in steps] == [(288, 352), (256, 320), (224, 288)]
    ours = _port_run(_cfg(_ms_jcfg()), steps, train_inputs()["zoo"], torch.float64)
    _assert_float64_matches(jax_refs["train/multiscale64"], ours, steps=(0, 1, 2))


def test_two_ranks_match_jax_float64(jax_refs, two_ranks):
    """Data parallelism: two gloo ranks, each stepping on 2 of the 4 images
    of every batch (the NaN image on rank 0 only), equal JAX's one-device
    float64 run over the global batch as test_float64_step_matches_jax_float64
    holds the one-process run (FLOAT64_TOL a leaf, all four steps); both
    ranks skip the non-finite step, hold one state bit for bit, and the
    state restored from rank 0's checkpoint equals the saved one bit for
    bit, also after one more step."""
    from tests._torch_ranks import FIELDS

    r0, r1 = two_ranks
    for f in FIELDS:
        assert torch.equal(r0["final"][f], r1["final"][f]), f
    assert all(torch.equal(a, b) for a, b in zip(r0["final"]["ema"], r1["final"]["ema"]))
    trees = r0["trees"]
    ours = {"metrics": r0["metrics"], "grad": _flat(r0["grad"]),
            "state": {"params": _flat(trees["model"]["params"]),
                      "batch_stats": _flat(trees["model"]["batch_stats"]),
                      **{k: _flat(trees[k]) for k in ("mu", "nu", "ema")}}}
    _assert_float64_matches(jax_refs["train/trajectory64"], ours)
    for r in (r0, r1):
        before, after, step = r["states"][1]
        assert all(torch.equal(before[f], after[f])
                   for f in ("params", "batch_stats", "mu", "nu", "count"))
        assert int(after["count"]) == 1 and int(after["total_notfinite"]) == 1 and step == 2
        assert [m["nonfinite_streak"] for m in r["metrics"]] == [0, 1, 0, 0]
        np.testing.assert_equal(r["metrics"], r0["metrics"])  # reduced: one on every rank
        assert r["restored_step"] == 4
        for got, want in ((r["restored"], r["final"]), r["stepped"]):
            for f in FIELDS:
                assert torch.equal(got[f], want[f]), f
            assert all(torch.equal(a, b) for a, b in zip(got["ema"], want["ema"]))


def _assert_float64_matches(ref, ours, steps=(0, 2, 3), skip=()):
    """``ours`` (metrics of each step, the step-0 gradient and the final
    state, flat) against JAX's float64 trajectory ``ref``; the loss
    components of the accepted ``steps``; leaves in ``skip`` are left out
    of the gradient and the state."""
    for step in steps:
        for k in COMPONENTS:
            j, p = ref["metrics"][step][k], ours["metrics"][step][k]
            assert abs(p - j) <= FLOAT64_TOL * abs(j), (step, k, p, j)
    zero = _zero_leaves(ref["grad"])
    assert zero and all(k.endswith("bn/bias") for k in zero)
    norm = np.sqrt(sum(float(np.sum(v ** 2)) for v in ref["grad"].values()))
    for k in zero:
        assert np.linalg.norm(ours["grad"][k]) < 1e-9 * norm, k
    worst = {}
    for part, theirs, mine in [("grad", ref["grad"], ours["grad"])] + [
            (p, ref["state"][p], ours["state"][p]) for p in PARTS]:
        left_out = set(skip) | (set() if part == "batch_stats" else zero)
        worst[part] = max(_rel(mine[k], theirs[k]) for k in theirs if k not in left_out)
    print("float64, port against JAX, worst leaf:", worst)
    assert max(worst.values()) <= FLOAT64_TOL, worst


def test_step_losses_match_jax(jax_refs, port_trajectories):
    """Every loss component of the first step and of the step after the
    skipped one (same weights: the LR of step 0 is 0) within 1e-5 of JAX's
    fp32 or of the float64 loss."""
    ref, exact = jax_refs["train/trajectory"], jax_refs["train/trajectory64"]
    ours = port_trajectories[torch.float32]
    for step in (0, 2):
        for k in COMPONENTS:
            j, p, e = (r["metrics"][step][k] for r in (ref, ours, exact))
            assert min(abs(p - j) / abs(j), abs(p - e) / abs(e)) <= 1e-5, (step, k, p, j, e)


def test_step0_gradient_matches_jax(jax_refs, port_trajectories):
    """The step-0 gradient (Adam's first moment / 0.1), per leaf: relative
    L2 within 1e-4 of JAX's fp32 or of the float64 gradient, else by the
    float64 rule of the module docstring; the leaves whose float64 gradient
    is zero are rounding noise in both fp32 runs."""
    ref, exact = (jax_refs[k]["grad"] for k in ("train/trajectory", "train/trajectory64"))
    ours = port_trajectories[torch.float32]["grad"]
    zero = _zero_leaves(exact)
    norm = np.sqrt(sum(float(np.sum(v ** 2)) for v in exact.values()))
    for k in zero:
        assert max(np.linalg.norm(ours[k]), np.linalg.norm(ref[k])) < 1e-6 * norm, k
    _judge("grad", ours, ref, exact, 1e-4, skip=zero)


def test_nonfinite_step_skips_like_jax(jax_refs, port_trajectories):
    """The NaN batch: every tensor of the state bitwise unchanged, the
    counters equal to JAX's, and the next step's LR is schedule(step) while
    its update runs at the accepted count (the step after equals JAX's, as
    test_step_losses_match_jax holds)."""
    ref = jax_refs["train/trajectory"]["metrics"]
    ours = port_trajectories[torch.float32]
    before, after, step = ours["states"][1]
    for f, v in before.items():
        assert torch.equal(v, after[f]), f
    assert int(after["count"]) == 1 and step == 2
    for step in range(4):
        for k in ("skipped_nonfinite", "nonfinite_streak", "lr"):
            assert ours["metrics"][step][k] == pytest.approx(ref[step][k], rel=1e-6), (step, k)
    assert [m["nonfinite_streak"] for m in ref] == [0, 1, 0, 0]
    assert not np.isfinite(ours["metrics"][1]["total"])


def test_three_steps_state_matches_jax(jax_refs, port_trajectories):
    """After three accepted steps: params, statistics, EMA and both Adam
    moments per leaf within 1e-3 of JAX's fp32 or of float64 (relative L2),
    else by the float64 rule; the noise leaves of the gradient are left out
    of the weights and moments (Adam turns their noise into +-lr moves)."""
    ref, exact = jax_refs["train/trajectory"], jax_refs["train/trajectory64"]
    ours = port_trajectories[torch.float32]
    zero = _zero_leaves(exact["grad"])
    for part in PARTS:
        _judge(part, ours["state"][part], ref["state"][part], exact["state"][part], 1e-3,
               skip=() if part == "batch_stats" else zero, trajectory=True)


def test_distill_matches_jax(zoo, jax_refs):
    """The folded teacher's heads and the distillation loss of a lite-shaped
    student (the teacher's small head plus noise: only the last teacher head
    pairs with it) against JAX at 1e-4."""
    jheads, jloss = jax_refs["train/teacher"]
    teacher = make_teacher_fn(zoo, device="cpu")
    heads = teacher(torch.from_numpy(_teacher_input()))
    for ours, theirs in zip(heads, jheads):
        np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-4 * np.abs(theirs).max())
    student = torch.from_numpy(_student_head(heads[1].numpy()))
    assert float(distill_loss((student,), heads)) == pytest.approx(jloss, rel=1e-4)
    assert jloss == pytest.approx(0.25, rel=0.05)  # the noise's variance
    assert float(distill_loss((heads[1],), heads)) == 0.0
    with pytest.raises(ValueError, match="teacher produces"):
        distill_loss(heads, (heads[1],))


def test_detector_unfolded_run_raw_matches_jax(zoo, jax_refs):
    """Detector(fold_bn=False) (the trainable model's eval forward) on two
    golden frames equals the JAX Detector(fold_bn=False): counts, classes,
    boxes within 1 px, conf within 1e-4."""
    ours = {k: v.numpy() for k, v in Detector(get_config("256x320"), variables=zoo,
                                              fold_bn=False, device="cpu").run_raw(
                                                  _golden_frames(2)).items()}
    theirs = jax_refs["train/detector"]
    np.testing.assert_array_equal(ours["count"], theirs["count"])
    assert ours["count"].sum() == 4
    for b in range(2):
        n = int(theirs["count"][b])
        np.testing.assert_array_equal(ours["cls_idx"][b, :n], theirs["cls_idx"][b, :n])
        np.testing.assert_allclose(ours["boxes"][b, :n], theirs["boxes"][b, :n], atol=1.0)
        np.testing.assert_allclose(ours["conf"][b, :n], theirs["conf"][b, :n], atol=1e-4)


def test_cli_train_resume_and_eval(dataset, golden_voc, jax_refs, tmp_path, capsys):
    """`train` through --config-json on the synthetic set (64x96, 2 epochs,
    validation each epoch, --max-to-keep 1): the reference's log lines and
    epoch_<n> directories; `--resume latest` picks up at epoch 2; `eval`
    scores the checkpoint directory, and on the golden VOC set with the zoo
    weights prints the JAX `eval`'s mAP line; the unported formats, and
    native-int8 with nothing to calibrate on, exit with 2."""
    from yolofastest_torch.cli import main

    jcfg = _jcfg()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, batch_size=8, total_epochs=2, val_after_epoch=-1, log_every=1, lr0=1e-2,
        ema_decay=0.0))
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(jcfg.to_json())
    log_dir, ckpt = str(tmp_path / "logs"), str(tmp_path / "ckpt")
    base = ["train", "--config-json", str(cfg_json), "--train-dir", dataset, "--val-dir", dataset,
            "--log-dir", log_dir, "--checkpoint-dir", ckpt, "--max-to-keep", "1",
            "--device", "cpu"]
    assert main(base) == 0
    assert os.listdir(ckpt) == ["epoch_1"]
    log = open(os.path.join(log_dir, "train_info.log")).read()
    for line in (r"Start\.\.\.\.", r"initialize model",
                 r"epoch \[1\]: current_batch = 2/2, total_iter = 4, loss = [0-9.]+, "
                 r"example/sec = [0-9.]+, lr = [0-9.]+, remain = 0:00:00",
                 r"—————— epoch: 1 validation results —————",
                 r"class: carrier, target_num = \d+, AP = [0-9.]+", r"mean AP: [0-9.]+",
                 r"detection rate: [0-9.]+ \(\d+/\d+ targets\)"):
        assert re.search(line, log), line
    assert main(base + ["--epochs", "3", "--resume", "latest"]) == 0
    log = open(os.path.join(log_dir, "train_info.log")).read()
    assert "Resumed full state from" in log and "(epoch 2)" in log
    assert os.listdir(ckpt) == ["epoch_2"]
    assert len(open(os.path.join(log_dir, "metrics.jsonl")).read().splitlines()) == 6

    capsys.readouterr()
    ev = ["eval", "--config-json", str(cfg_json), "--val-dir", dataset,
          "--log-dir", str(tmp_path / "elogs"), "--device", "cpu"]
    assert main(ev + ["--weights", os.path.join(ckpt, "epoch_2")]) == 0
    assert re.search(r"^mAP: [0-9.]+$", capsys.readouterr().out, re.M)

    ev = ["eval", "--config", "256x320", "--val-dir", golden_voc, "--device", "cpu",
          "--log-dir", str(tmp_path / "elogs")]
    assert main(ev + ["--weights", zoo_path("256x320")]) == 0
    ours = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("mAP:")]
    rc, theirs = jax_refs["train/cli_eval"]
    assert rc == 0 and ours == [f"mAP: {theirs['mAP']:.4f}"] and theirs["mAP"] > 0.3
    for extra in (["--backend", "native-int8", "--calibration-cache", str(tmp_path / "n.json")],
                  ["--weights", str(tmp_path)]):
        args = ev + ["--weights", zoo_path("256x320")] if extra[0] == "--backend" else ev
        assert main(args + extra) == 2, extra
    # int8 is ported (tests/test_torch_quant.py): without calibration images or a
    # cache it exits 2 with the JAX command's message
    capsys.readouterr()
    assert main(ev + ["--weights", zoo_path("256x320"), "--backend", "int8",
                      "--calibration-cache", str(tmp_path / "c.json")]) == 2
    assert "int8 calibration needs images: pass --calib-data" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):  # in torch.load, as in the JAX package's loader
        main(ev + ["--weights", "w.pth"])
