"""Ranks of the port's multi-process runs in ``tests/test_torch_train.py``
(:func:`trajectory_rank`) and ``tests/test_torch_spatial.py``
(:func:`spatial_rank`).

Spawned processes run them; they import only torch and the port, so a rank
starts without loading JAX.  Their arguments are small (file paths, JSON):
``Process.start`` blocks until the child has read arguments larger than a
pipe's buffer, and a child reads them only once its interpreter is up, so
large arguments would start the ranks one after another.
"""

import contextlib
import io
import os

import numpy as np
import torch
import torch.nn.functional as F

FIELDS = ("params", "batch_stats", "mu", "nu", "count", "notfinite_count", "total_notfinite")


def _snapshot(state):
    out = {f: getattr(state, f).clone() for f in FIELDS}
    out["ema"] = tuple(e.clone() for e in state.ema)
    return out


def _trees(trainer, state):
    """Flax-layout numpy trees of the state's vectors, in their dtype."""
    return {"model": trainer._tree(state.params, state.batch_stats),
            "mu": trainer._tree(state.mu, state.batch_stats)["params"],
            "nu": trainer._tree(state.nu, state.batch_stats)["params"],
            "ema": trainer._tree(*state.ema)["params"]}


def save_batches(path, batches):
    """Write ``(imgs, targets)`` batches to ``path`` (.npz) for the ranks."""
    np.savez(path, *[a for batch in batches for a in batch])
    return path


def load_batches(path):
    with np.load(path) as f:
        arrays = [f[f"arr_{i}"] for i in range(len(f.files))]
    return list(zip(arrays[::2], arrays[1::2]))


def trajectory_rank(rank, world, port, cfg_json, batches_path, ckpt_dir, out):
    """Rank ``rank`` of ``world`` gloo ranks on the CPU (one torch thread):
    the Trainer in float64 over ``batches`` (global batches; this rank
    steps on its shard), recording each step's metrics, the state around
    each step and the step-0 gradient (Adam's first moment / 0.1); then rank
    0 saves, a fresh Trainer (another seed) restores on every rank, and
    both step once more on the third batch.  Last, on the (1, 2) mesh of
    the same ranks (the rows split), the checks of
    ``tests/test_torch_spatial.py``: the spatial executor and the float64
    spatial Trainer over ``batches`` (``run["spatial"]``).  Everything is
    written to ``out`` with ``torch.save``."""
    torch.set_num_threads(1)
    from yolofastest_torch.configs import Config
    from yolofastest_torch.models import load_variables, zoo_path
    from yolofastest_torch.parallel import init_distributed, make_mesh, shard_batch
    from yolofastest_torch.train import Trainer

    zoo = load_variables(zoo_path("256x320"))
    batches = load_batches(batches_path)
    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(devices=["cpu"])
    cfg = Config.from_json(cfg_json)
    t = Trainer(cfg, mesh=mesh, batch_per_epoch=1, variables=zoo).to_float64()
    run = {"metrics": [], "states": []}
    for i, (imgs, tgts) in enumerate(batches):
        imgs, tgts = shard_batch(mesh, imgs.astype(np.float64), tgts.astype(np.float64))
        before = _snapshot(t.state)
        m = t.step(imgs, tgts)
        run["metrics"].append({k: float(v) for k, v in m.items()})
        run["states"].append((before, _snapshot(t.state), t.state.step))
        if i == 0:
            run["grad"] = t._tree(t.state.mu * 10.0, t.state.batch_stats)["params"]
    run["trees"] = _trees(t, t.state)
    run["final"] = _snapshot(t.state)

    path = t.save_checkpoint(ckpt_dir, epoch=0)
    fresh = Trainer(cfg, mesh=mesh, batch_per_epoch=1, seed=7).to_float64()
    fresh.restore_checkpoint(path)
    run["restored"] = _snapshot(fresh.state)
    run["restored_step"] = fresh.state.step
    imgs, tgts = shard_batch(mesh, *(a.astype(np.float64) for a in batches[2]))
    for trainer in (t, fresh):
        trainer.step(imgs, tgts)
    run["stepped"] = (_snapshot(t.state), _snapshot(fresh.state))
    rows = make_mesh(1, 2, devices=["cpu"])
    run["spatial"] = {"executor": {"1x2": _executor_checks(rows, 3)},
                      "trainer": _spatial_trainer(rows, cfg_json, batches)}
    torch.save(run, out)
    torch.distributed.destroy_process_group()


# (before, after) halos of the spatial rank test: shallow, one-sided, and
# deeper than a 4-row shard (from two and three ranks away)
HALO_CASES = ((1, 1), (1, 0), (2, 2), (5, 5), (9, 2))
# (kernel, stride) of the convolutions held through row_window
CONV_CASES = ((3, 1), (3, 2), (5, 1))
HALO_ROWS = 4  # rows a rank holds in the halo checks


def halo_input(seed=0):
    """The halo checks' float64 NHWC images: 2 images of 4 x HALO_ROWS rows."""
    return np.random.default_rng(seed).standard_normal((2, 4 * HALO_ROWS, 5, 3))


def conv_weight(kernel, seed=1):
    return np.random.default_rng(seed + kernel).standard_normal((3, 3, kernel, kernel))


def _halo_checks(mesh):
    """Each halo and convolution case on this rank's rows: the rows out, the
    rows added above, and the gradient of ``sum(w * out)`` for a weight
    ``w`` seeded by the rank (the test rebuilds the unsharded function)."""
    from yolofastest_torch.parallel import halo_rows, row_window

    mine = torch.from_numpy(halo_input())[:, mesh.rank * HALO_ROWS:(mesh.rank + 1) * HALO_ROWS]
    out = {}
    for i, case in enumerate(HALO_CASES + CONV_CASES):
        x = mine.clone().requires_grad_(True)
        if case in HALO_CASES:
            y, above = halo_rows(x, *case, mesh.rows)
        else:
            k, s = case
            ext = row_window(x, k, s, mesh.rows)
            y = F.conv2d(ext.permute(0, 3, 1, 2), torch.from_numpy(conv_weight(k)), None, s,
                         (0, (k - 1) // 2)).permute(0, 2, 3, 1)
            above = None
        w = torch.from_numpy(np.random.default_rng(100 * i + mesh.rank).standard_normal(y.shape))
        (y * w).sum().backward()
        out[case] = {"y": y.detach(), "above": above, "grad": x.grad, "w": w}
    return out


def _chain64(x, w1, b1, w2, b2, w3, b3):
    from yolofastest_torch.kernels.res_block import res_chain_float64

    return res_chain_float64(x, w1, b1, w2, b2, w3, b3)


def executor_heads(params, x, rows=None, float64=False):
    """The folded graph's heads of ``x``: on the rank's rows over the spatial
    executor (gathered) where ``rows`` is given, else on whole images; in
    float64 through the float64 chain (the plain chain rounds to fp32)."""
    from yolofastest_torch.models import (FoldedExecutor, SpatialExecutor, folded_apply,
                                          spatial_apply)
    from yolofastest_torch.models.graph import walk_topology
    from yolofastest_torch.parallel import gather_rows

    if not float64:
        return folded_apply(params, x) if rows is None else spatial_apply(params, x, rows)
    cls = FoldedExecutor if rows is None else SpatialExecutor
    ex = type("Float64Executor", (cls,), {"chain_fn": staticmethod(_chain64)})
    heads = walk_topology(x, ex(params, *(() if rows is None else (rows,)), torch.float64))
    return heads if rows is None else gather_rows(heads, rows)


def _executor_checks(mesh, seed):
    """The spatial executor's gathered heads on this rank's rows of seeded
    64-row (two spatial ranks) or 128-row (four) images, fp32 and float64."""
    from yolofastest_torch.models import (fold_batchnorm, load_variables,
                                          torch_params_from_folded, zoo_path)
    from yolofastest_torch.parallel import shard_batch

    folded = fold_batchnorm(load_variables(zoo_path("256x320")))
    x = spatial_input(mesh.n_spatial, seed)
    out = {}
    for name, dt in (("fp32", torch.float32), ("float64", torch.float64)):
        params = torch_params_from_folded(folded, "cpu", dt)
        rows = shard_batch(mesh, torch.from_numpy(x).to(dt), spatial=True)
        with torch.no_grad():
            out[name] = [h.clone() for h in executor_heads(params, rows, mesh.rows,
                                                           dt == torch.float64)]
    return out


def spatial_input(n_spatial, seed):
    """2 seeded net inputs of 32 rows a spatial rank (at least 64)."""
    h = 32 * max(n_spatial, 2)
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (2, h, 96, 1)).astype(np.float32)


def golden_frames(res, n):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                        f"golden_{res}.npz")
    return np.load(path)["pre_imgs"][:n]


def _detect(mesh, res, frames, raw=False):
    """The sharded detect pipeline on this rank's shard of ``frames``
    (uint8 net-size gray) with the ``res`` preset and zoo weights:
    normalise, the Detector over the mesh, decode and NMS of the rank's data
    slice.  ``raw``: the rank's data slice as BGR frames at twice the size
    (``chip_smoke.make_frames``, which the preprocess maps back exactly)
    through ``run_raw``, which keeps the rank's rows of the net input."""
    from chip_smoke import make_frames
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.models import load_variables, zoo_path
    from yolofastest_torch.ops import normalize
    from yolofastest_torch.parallel import shard_batch

    det = Detector(get_config(res), load_variables(zoo_path(res)), mesh=mesh)
    if raw:
        out = det.run_raw(shard_batch(mesh, make_frames(frames)))
    else:
        out = det.run(normalize(shard_batch(mesh, frames, spatial=True))[..., None])
    return {k: v.clone() for k, v in out.items()}


def _spatial_trainer(mesh, cfg_json, batches):
    """The float64 Trainer with ``shard_spatial=True`` over ``batches``
    (test_torch_train's four steps, the second one non-finite):
    each step's metrics, the step-0 gradient, the final state's trees and
    its vectors (for the ranks' bitwise agreement)."""
    from yolofastest_torch.configs import Config
    from yolofastest_torch.models import load_variables, zoo_path
    from yolofastest_torch.parallel import shard_batch
    from yolofastest_torch.train import Trainer

    t = Trainer(Config.from_json(cfg_json), mesh=mesh, batch_per_epoch=1,
                variables=load_variables(zoo_path("256x320")), shard_spatial=True).to_float64()
    run = {"metrics": []}
    for i, (imgs, tgts) in enumerate(batches):
        x = shard_batch(mesh, imgs.astype(np.float64), spatial=True)
        m = t.step(x, shard_batch(mesh, tgts.astype(np.float64)))
        run["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            run["grad"] = t._tree(t.state.mu * 10.0, t.state.batch_stats)["params"]
    run["trees"] = _trees(t, t.state)
    run["final"] = _snapshot(t.state)
    return run


def spatial_rank(rank, world, port, args, out):
    """Rank ``rank`` of four gloo ranks on the CPU (one torch thread) for
    ``tests/test_torch_spatial.py``: first the dry run's worker (its own
    process group: a (2, 2) mesh, shard_spatial), then in one group the halo
    checks on a (1, 4) mesh, the spatial executor on (1, 4) and (2, 2), the
    sharded detect pipeline on (4, 1) (data only, 256x320) and (2, 2)
    (512x640), and the float64 spatial Trainer on (2, 2).  (The (1, 2) mesh
    runs in :func:`trajectory_rank`.)  Everything is written to ``out`` with
    ``torch.save``."""
    torch.set_num_threads(1)
    from yolofastest_torch.parallel import EXCHANGES, init_distributed, make_mesh
    from yolofastest_torch.parallel import worker

    res = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res["dryrun_rc"] = worker.main([str(args["dryrun_port"]), str(rank), str(world),
                                        os.path.join(args["dir"], "dryrun_ckpt"),
                                        "--device", "cpu"])
    res["dryrun_out"] = buf.getvalue()
    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    one_axis = make_mesh(1, 4, devices=["cpu"])
    data_only = make_mesh(4, 1, devices=["cpu"])
    mesh = make_mesh(2, 2, devices=["cpu"])
    res["layout"] = {name: (m.axis_names, m.n_data, m.n_spatial, m.data_index,
                            m.spatial_index)
                     for name, m in (("1x4", one_axis), ("4x1", data_only), ("2x2", mesh))}
    EXCHANGES.clear()
    res["halo"] = _halo_checks(one_axis)
    res["exchanges_halo"] = dict(EXCHANGES)
    res["executor"] = {"1x4": _executor_checks(one_axis, 1), "2x2": _executor_checks(mesh, 2)}
    EXCHANGES.clear()
    res["detect"] = {"4x1": _detect(data_only, "256x320",
                                    golden_frames("256x320", args["frames"]))}
    res["exchanges_data_only"] = dict(EXCHANGES)
    EXCHANGES.clear()
    res["detect"]["2x2"] = _detect(mesh, "512x640", golden_frames("512x640", args["frames"]),
                                   raw=True)
    res["exchanges_detect"] = dict(EXCHANGES)
    res["trainer"] = _spatial_trainer(mesh, args["cfg_train"], load_batches(args["batches"]))
    torch.save(res, out)
    torch.distributed.destroy_process_group()
