"""The mesh's ``spatial`` axis in the port on the CPU: image rows split over
gloo ranks with halo exchanges (``yolofastest_torch/parallel/halo.py``), the
spatial executor of the folded graph, the sharded detect pipeline, the
Trainer with ``shard_spatial=True`` and the spatial dry run, held against
the unsharded functions and the JAX package.

Two spawns serve every multi-rank check: four gloo ranks
(``tests/_torch_ranks.py`` ``spatial_rank``: the dry run's worker on a (2, 2)
mesh, then the halos on (1, 4), the executor on (1, 4) and (2, 2), detect on
(4, 1) and (2, 2), the Trainer on (2, 2)), and the two ranks of
``tests/test_torch_train.py``'s data-parallel run, which end on the (1, 2)
mesh (``trajectory_rank``).  ``tests/_background.py`` starts both some
modules earlier, and they run beside the tests in between.  The
JAX references (the pipeline of ``tests/test_sharded_inference.py`` on four
of the eight virtual devices, the float64 Trainer on one device that
``tests/test_torch_train.py`` reads too, and, for the ``slow`` test, the
float64 Trainer with ``shard_spatial=True`` on the same meshes) run in the
pool of ``tests/_jax_refs.py``.

Four spatial ranks need 128-row images: 64 rows do not split into whole rows
at stride 32 over four ranks, which the port refuses
(``check_image_rows``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests._background import (SPATIAL_FRAMES, spatial_processes,  # noqa: F401 (fixtures)
                               two_rank_processes)
from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from tests._torch_ranks import (CONV_CASES, FIELDS, HALO_CASES, HALO_ROWS, conv_weight,
                                executor_heads, golden_frames, halo_input, spatial_input)
from tests.test_torch_train import FLOAT64_TOL as FLOAT64_TOL_TRAIN
from tests.test_torch_train import _sequence as _train_sequence
from tests.test_torch_train import (_assert_float64_matches, _flat, _jax_trajectory, _rel,
                                    _zero_leaves, train_inputs)
from yolofastest_torch.models import (fold_batchnorm, spatial_apply, torch_params_from_folded,
                                      zoo_path)
from yolofastest_torch.parallel import (Mesh, RowShard, batch_sharding, check_image_rows,
                                        shard_batch)

FP32_TOL = 1e-5  # the executor's fp32 heads: of max |head|
FLOAT64_TOL = 1e-12
BOX_TOL = 1e-3  # tests/test_sharded_inference.py's spatial tolerance


def _frames(res):
    return golden_frames(res, SPATIAL_FRAMES)


def _sequence():
    return _train_sequence(train_inputs()["batches"])


def _jax_pipelines():
    """JAX's sharded detect pipeline (``tests/test_sharded_inference.py``) on
    4 of the 8 virtual devices: the batch over ``data`` at 256x320, and batch
    and rows over a (2, 2) mesh at 512x640."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.models import YoloFastest
    from yolofastest_tpu.models import load_variables as jload_variables
    from yolofastest_tpu.ops import batched_nms, decode_heads, normalize
    from yolofastest_tpu.parallel import batch_sharding as jbatch_sharding
    from yolofastest_tpu.parallel import make_mesh as jmake_mesh
    from yolofastest_tpu.parallel import replicate

    devs = jax.devices()[:4]
    out = {}
    for name, res, mesh in (("4x1", "256x320", JMesh(np.array(devs), ("data",))),
                            ("2x2", "512x640", jmake_mesh(2, 2, devices=devs))):
        io = jget_config(res).io
        variables = jax.device_put(jax.tree.map(jnp.asarray, jload_variables(zoo_path(res))),
                                   replicate(mesh))
        model = YoloFastest(num_cls=io.num_cls, num_anchors=io.num_anchors)

        def pipeline(variables, frames, model=model, io=io):
            imgs = normalize(frames, jnp.float32)[..., None]
            heads = model.apply(variables, imgs, train=False)
            cand = decode_heads(heads, io.anchors, io.input_hw, io.conf_thre, io.max_decode)
            return batched_nms(*cand, iou_thre=io.nms_thre, max_det=io.max_det)

        pipeline = jax.jit(functools.partial(pipeline, model=model, io=io))
        frames = jax.device_put(jnp.asarray(_frames(res)), jbatch_sharding(mesh, spatial=True))
        out[name] = {k: np.asarray(v) for k, v in pipeline(variables, frames).items()}
    return out


register("spatial/detect", _jax_pipelines, tests=("test_sharded_detect_matches_jax",))
for _shape in ((1, 2), (2, 2)):
    register(f"spatial/trainer{_shape[0]}x{_shape[1]}", _jax_trajectory,
             lambda s=_shape: (_sequence(), train_inputs()["zoo"], True, s),
             tests=(f"test_spatial_trainer_matches_jax_mesh_float64[{_shape[0]}x{_shape[1]}",))


@pytest.fixture(scope="module")
def spatial_ranks(spatial_processes, two_rank_processes):  # noqa: F811
    """{(world, rank): the rank's record}, once every rank has exited: the
    four spatial ranks' and the (1, 2) part of the two training ranks'."""
    records = {}
    for world, started in ((4, spatial_processes), (2, two_rank_processes)):
        if started is None:  # no selected test reads the (1, 2) mesh
            continue
        procs, outs = started
        for p in procs:
            p.join(timeout=300)
        assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
        for r, out in enumerate(outs):
            rec = torch.load(out, weights_only=False)
            records[(world, r)] = rec if world == 4 else rec["spatial"]
    return records


# ------------------------------------------------------------ one process
def test_row_rule_and_layouts_without_a_group():
    """The row rule: 32 x n_spatial must divide an image's height (a
    shard_batch, a multi-scale bucket of a spatial Trainer, the executor's
    rows); a fake (1, 2) mesh's shardings and rank 0's rows and batch slice;
    one rank of the spatial axis exchanges nothing."""
    check_image_rows(64, 2)
    check_image_rows(96, 1)
    with pytest.raises(ValueError, match="64 must divide"):
        check_image_rows(96, 2)
    two = Mesh(group=None, ranks=(0, 1), device=torch.device("cpu"),
               axis_names=("data", "spatial"), n_spatial=2)
    assert (two.n_data, two.data_index, two.spatial_index) == (1, 0, 0)
    assert batch_sharding(two, spatial=True).spec == ("data", "spatial")
    assert batch_sharding(two).spec == ("data",)
    x = np.arange(2 * 64 * 3).reshape(2, 64, 3)
    t = np.arange(12).reshape(2, 6)
    got, tgt = shard_batch(two, x, t, spatial=True)
    assert torch.equal(got, torch.from_numpy(x[:, :32])) and torch.equal(tgt, torch.from_numpy(t))
    with pytest.raises(ValueError, match="a height of 96 rows does not split over 2"):
        shard_batch(two, np.zeros((2, 96, 3)), spatial=True)
    from yolofastest_torch.parallel.worker import tiny_config
    from yolofastest_torch.train import Trainer

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, multiscale_steps=1))
    with pytest.raises(ValueError, match="multi-scale bucket: a height of 96"):
        Trainer(cfg, mesh=two, shard_spatial=True)
    params = torch_params_from_folded(fold_batchnorm(train_inputs()["zoo"]), "cpu")
    with pytest.raises(ValueError, match="48 rows a rank"):
        spatial_apply(params, torch.zeros(1, 48, 96, 1), RowShard(None, 0, 2))
    x = torch.randn(1, 4, 3, 2)
    from yolofastest_torch.parallel import EXCHANGES, gather_rows, halo_rows

    EXCHANGES.clear()
    assert halo_rows(x, 2, 2, RowShard())[0] is x and gather_rows((x,), RowShard())[0] is x
    assert not EXCHANGES


# -------------------------------------------------------------- the ranks
def _ranks(records, world):
    return [records[(world, r)] for r in range(world)]


def test_mesh_places_and_halo_collectives(spatial_ranks):
    """Rank r sits at (r // n_spatial, r % n_spatial) on every mesh of the
    four ranks; a halo or a gather is one all_reduce, both ways; the
    spatial detect forward makes 17 halo exchanges and one gather (11 convs
    of kernel > 1, 6 chains), the data-only one none."""
    ranks = _ranks(spatial_ranks, 4)
    for r, rec in enumerate(ranks):
        assert rec["layout"] == {"1x4": (("data", "spatial"), 1, 4, 0, r),
                                 "4x1": (("data",), 4, 1, r, 0),
                                 "2x2": (("data", "spatial"), 2, 2, r // 2, r % 2)}
        n = len(HALO_CASES) + len(CONV_CASES)
        assert rec["exchanges_halo"] == {"halo": n, "halo_backward": n}
        assert rec["exchanges_detect"] == {"halo": 17, "gather": 1}
        assert rec["exchanges_data_only"] == {}


@pytest.mark.parametrize("case", HALO_CASES, ids=lambda c: f"before{c[0]}-after{c[1]}")
def test_halo_rows_match_slicing(spatial_ranks, case):
    """float64 rows of four ranks (4 rows each): each rank's rows with the
    halo are the whole tensor's rows sliced, clipped at both image edges
    (deeper halos come from two and three ranks away), and the backward of
    sum(w_r * rows_r) over the ranks equals autograd of the same sum of
    slices of the whole tensor, to 1e-12."""
    full = torch.from_numpy(halo_input()).requires_grad_(True)
    before, after = case
    loss, grads = 0.0, []
    for r, rec in enumerate(_ranks(spatial_ranks, 4)):
        got = rec["halo"][case]
        lo = max(0, r * HALO_ROWS - before)
        hi = min(full.shape[1], (r + 1) * HALO_ROWS + after)
        assert got["above"] == r * HALO_ROWS - lo
        assert torch.equal(got["y"], full.detach()[:, lo:hi])
        loss = loss + (full[:, lo:hi] * got["w"]).sum()
        grads.append(got["grad"])
    loss.backward()
    assert float((torch.cat(grads, 1) - full.grad).abs().max()) <= FLOAT64_TOL


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"k{c[0]}s{c[1]}")
def test_row_window_conv_matches_unsharded(spatial_ranks, case):
    """A float64 conv (kernel 3 or 5, stride 1 or 2) of row_window's rows
    with no row padding gives each rank its rows of the whole tensor's conv,
    and its gradient through the halo equals the whole conv's, to 1e-12."""
    k, s = case
    full = torch.from_numpy(halo_input()).requires_grad_(True)
    y = F.conv2d(full.permute(0, 3, 1, 2), torch.from_numpy(conv_weight(k)), None, s,
                 (k - 1) // 2).permute(0, 2, 3, 1)
    own = HALO_ROWS // s
    loss, grads = 0.0, []
    for r, rec in enumerate(_ranks(spatial_ranks, 4)):
        got = rec["halo"][case]
        mine = y[:, r * own:(r + 1) * own]
        assert float((got["y"] - mine.detach()).abs().max()) <= FLOAT64_TOL
        loss = loss + (mine * got["w"]).sum()
        grads.append(got["grad"])
    loss.backward()
    assert float((torch.cat(grads, 1) - full.grad).abs().max()) <= FLOAT64_TOL


@pytest.mark.parametrize("mesh", ["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("dtype", ["fp32", "float64"])
def test_spatial_executor_matches_folded_apply(spatial_ranks, mesh, dtype):
    """The spatial executor's gathered heads on each rank's rows (the plain
    chain on the extended rows; float64 through the float64 chain) against
    the folded graph on the whole images in one process: fp32 within 1e-5
    of max |head|, float64 within 1e-12.  (1, 2) and (2, 2) at 64x96,
    (1, 4) at 128x96."""
    n_data, n_spatial = map(int, mesh.split("x"))
    world = n_data * n_spatial
    seed = {"1x4": 1, "2x2": 2, "1x2": 3}[mesh]
    dt = torch.float32 if dtype == "fp32" else torch.float64
    params = torch_params_from_folded(fold_batchnorm(train_inputs()["zoo"]), "cpu", dt)
    x = torch.from_numpy(spatial_input(n_spatial, seed)).to(dt)
    with torch.no_grad():
        want = executor_heads(params, x, None, dt == torch.float64)
    per = x.shape[0] // n_data
    for r, rec in enumerate(_ranks(spatial_ranks, world)):
        d = r // n_spatial
        for got, ref in zip(rec["executor"][mesh][dtype], want):
            ref = ref[d * per:(d + 1) * per]
            assert got.shape == ref.shape and got.dtype == dt
            err = float((got - ref).abs().max())
            tol = FP32_TOL * float(ref.abs().max()) if dtype == "fp32" else FLOAT64_TOL
            assert err <= tol, (r, err, tol)


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_sharded_detect_matches_jax(spatial_ranks, jax_refs, mesh):
    """The port's sharded detect pipeline (``Detector(mesh=...)``: the
    folded graph over the spatial executor, the heads gathered, decode and
    NMS on each data slice) on 4 golden frames against JAX's pipeline of
    tests/test_sharded_inference.py on the same mesh of virtual devices:
    the batch over data at 256x320 (``run`` on the normalised shard), batch
    and rows over (2, 2) at 512x640 (``run_raw`` on the data slice's BGR
    frames, the rank's rows kept after the preprocess).  Counts equal,
    boxes within 1e-3; the spatial ranks of a data place return one
    result."""
    ref = jax_refs["spatial/detect"][mesh]
    n_spatial = int(mesh.split("x")[1])
    ranks = _ranks(spatial_ranks, 4)
    per_data = [ranks[r]["detect"][mesh] for r in range(0, 4, n_spatial)]
    for r, rec in enumerate(ranks):
        mine = rec["detect"][mesh]
        lead = per_data[r // n_spatial]
        assert all(torch.equal(mine[k], lead[k]) for k in mine)
    count = torch.cat([d["count"] for d in per_data]).numpy()
    boxes = torch.cat([d["boxes"] for d in per_data]).numpy()
    np.testing.assert_array_equal(count, ref["count"])
    assert count.sum() > 0
    for i, n in enumerate(count):
        np.testing.assert_allclose(boxes[i, :n], ref["boxes"][i, :n], atol=BOX_TOL)


def _trainer_ranks(spatial_ranks, mesh):
    """The Trainer records of the mesh's ranks, checked to hold one state
    bit for bit; rank 0's as flat trees."""
    n_data, n_spatial = map(int, mesh.split("x"))
    ranks = [rec["trainer"] for rec in _ranks(spatial_ranks, n_data * n_spatial)]
    for rec in ranks[1:]:
        for f in FIELDS:
            assert torch.equal(rec["final"][f], ranks[0]["final"][f]), f
        assert all(torch.equal(a, b) for a, b in zip(rec["final"]["ema"], ranks[0]["final"]["ema"]))
        np.testing.assert_equal(rec["metrics"], ranks[0]["metrics"])
    return _flat_run(ranks[0])


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_spatial_trainer_matches_jax_float64(spatial_ranks, jax_refs, mesh):
    """The Trainer with ``shard_spatial=True`` in float64: the port's ranks
    (each on its rows of its data slice of every 4-image batch at 64x96)
    over test_torch_train's four steps (A, a non-finite batch, B, C) equal
    JAX's x64 Trainer over the same steps on one device
    (``train/trajectory64``), as test_float64_step_matches_jax_float64 holds
    one process: losses, the step-0 gradient, params, statistics, EMA and
    both Adam moments within 1e-9 a leaf; the non-finite step is skipped;
    every rank holds one state bit for bit.  Splitting rows leaves the
    function as it is, so one device is its arbiter; JAX's own spatial mesh
    runs are held in test_spatial_trainer_matches_jax_mesh_float64."""
    ours = _trainer_ranks(spatial_ranks, mesh)
    assert [m["nonfinite_streak"] for m in ours["metrics"]] == [0, 1, 0, 0]
    _assert_float64_matches(jax_refs["train/trajectory64"], ours)


@pytest.mark.slow  # two JAX Trainer compiles over meshes, 45-55 s of a worker each
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_spatial_trainer_matches_jax_mesh_float64(spatial_ranks, jax_refs, mesh):
    """The same port runs against JAX's x64 Trainer with
    ``shard_spatial=True`` on the same mesh of virtual devices (1e-9 a leaf).

    JAX's own (2, 2) run departs from its one-device run on two leaves: its
    step-0 gradients of the 5x5 depthwise kernels ``conv5_5`` and
    ``conv4_1_4`` are twice the one-device gradients, where its (1, 2) and
    (2, 1) runs equal the one-device run to 3e-13 (XLA's partitioning of
    those convolutions' backward over both axes).  The leaves where JAX's
    mesh run leaves its one-device step-0 gradient by more than 1e-9 are
    left out here; test_spatial_trainer_matches_jax_float64 holds them."""
    ours = _trainer_ranks(spatial_ranks, mesh)
    ref = jax_refs[f"spatial/trainer{mesh}"]
    one_device = jax_refs["train/trajectory64"]["grad"]
    zero = _zero_leaves(one_device)
    departed = {k for k in one_device if k not in zero
                and _rel(ref["grad"][k], one_device[k]) > FLOAT64_TOL_TRAIN}
    print(f"JAX's {mesh} run departs from its one-device gradient on {sorted(departed)}")
    assert departed <= {"conv5_5/conv/kernel", "conv4_1_4/conv/kernel"}
    _assert_float64_matches(ref, ours, skip=departed)


def _flat_run(run):
    """A rank's Trainer record as flat trees, as _assert_float64_matches reads it."""
    trees = run["trees"]
    return {"metrics": run["metrics"], "grad": _flat(run["grad"]),
            "state": {"params": _flat(trees["model"]["params"]),
                      "batch_stats": _flat(trees["model"]["batch_stats"]),
                      **{k: _flat(trees[k]) for k in ("mu", "nu", "ema")}}}


def test_spatial_dryrun_four_processes(spatial_ranks):
    """The dry run's worker with four processes takes JAX's (2, 2) mesh with
    ``shard_spatial=True`` (32 of the 64 rows a rank): two finite steps with
    one state on every rank, save and resume bit for bit."""
    for r, rec in enumerate(_ranks(spatial_ranks, 4)):
        out = rec["dryrun_out"]
        assert rec["dryrun_rc"] == 0, out
        assert f"MP_OK rank={r} backend=gloo device=cpu mesh=2x2 rows=(32, 96)" in out, out
        assert f"MP_RESUME_OK rank={r}" in out, out
