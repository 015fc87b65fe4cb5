"""One rank of the port's two-rank training runs in ``tests/test_torch_train.py``.

Spawned processes run :func:`trajectory_rank`; it imports only torch and
the port, so a rank starts without loading JAX.
"""

import numpy as np
import torch

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


def trajectory_rank(rank, world, port, cfg_json, zoo, batches, ckpt_dir, out):
    """Rank ``rank`` of ``world`` gloo ranks on the CPU (one torch thread):
    the Trainer in float64 over ``batches`` (global batches; this rank
    steps on its shard), recording each step's metrics, the state around
    each step and the step-0 gradient (Adam's first moment / 0.1); then rank
    0 saves, a fresh Trainer (another seed) restores on every rank, and
    both step once more on the third batch.  Everything is written to
    ``out`` with ``torch.save``."""
    torch.set_num_threads(1)
    from yolofastest_torch.configs import Config
    from yolofastest_torch.parallel import init_distributed, make_mesh, shard_batch
    from yolofastest_torch.train import Trainer

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
    torch.save(run, out)
    torch.distributed.destroy_process_group()
