"""One rank of the multi-process dry run (:mod:`yolofastest_torch.parallel.dryrun`).

    python -m yolofastest_torch.parallel.worker PORT RANK N CKPT_DIR [--device D] [--backend B]

The rank joins a process group of N at ``localhost:PORT``, builds the
Trainer over the group's mesh on a 64x96 config, and takes two steps on its
shard of a seeded global batch (two images a data place).  The mesh follows
JAX's multi-chip dry run (``__graft_entry__.dryrun_multichip``): from four
ranks on, when N is even, ``(N/2, 2)`` with ``shard_spatial=True`` (each
rank steps on its rows of its data place's images, the row halos exchanged
over the spatial axis); otherwise the data axis alone.  It checks that the
ranks hold one state, and prints ``MP_OK rank=<r>`` with the mesh's shape.
Then rank 0 saves a checkpoint into CKPT_DIR (shared by the ranks), a fresh
Trainer with another seed restores it on every rank, its state equals the
saved one bit for bit, and it steps: ``MP_RESUME_OK rank=<r>``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from yolofastest_torch.configs import Config, IOConfig
from yolofastest_torch.parallel import init_distributed, make_mesh, replicate, shard_batch
from yolofastest_torch.parallel.distributed import host_to_global
from yolofastest_torch.train import Trainer

FIELDS = ("params", "batch_stats", "mu", "nu", "count", "notfinite_count", "total_notfinite")


def tiny_config() -> Config:
    """The dry run's 64x96 config (JAX's ``tools/mp_dryrun_worker.py``)."""
    io = IOConfig(input_shape=(64, 96, 1), origin_img_shape=(128, 192, 3),
                  anchors=(((10.0, 13.0), (16.0, 30.0), (33.0, 23.0)),
                           ((60.0, 40.0), (50.0, 50.0), (40.0, 60.0))))
    return Config(io=io)


def mesh_shape(n: int):
    """JAX's rule: ``(n/2, 2)`` with a spatial axis from four ranks on when
    ``n`` is even, else ``(n, 1)``."""
    return (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)


def local_batch(cfg: Config, rank: int, per_rank: int = 2):
    """A data place's batch, from its index as the seed."""
    rng = np.random.default_rng(rank)
    imgs = rng.standard_normal((per_rank, 64, 96, 1)).astype(np.float32) * 0.2
    tgts = np.zeros((per_rank, cfg.train.max_boxes, 6), np.float32)
    tgts[:, 0] = [0.5, 0.5, 0.25, 0.25, 1.0, 255.0]
    return imgs, tgts


def ranks_agree(mesh, t: torch.Tensor) -> bool:
    """Whether every rank holds ``t`` bit for bit (against rank 0's)."""
    ok = torch.tensor([float(torch.equal(host_to_global(replicate(mesh), t), t))],
                      device=mesh.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(ok.item())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m yolofastest_torch.parallel.worker")
    p.add_argument("port", type=int)
    p.add_argument("rank", type=int)
    p.add_argument("n", type=int)
    p.add_argument("ckpt_dir")
    p.add_argument("--device", default="cuda", help="every rank's device (cuda or cpu)")
    p.add_argument("--backend", default=None, help="gloo or nccl (default: nccl on a card)")
    args = p.parse_args(argv)

    torch.set_num_threads(1)
    init_distributed(f"localhost:{args.port}", args.n, args.rank, backend=args.backend)
    n_data, n_spatial = mesh_shape(args.n)
    mesh = make_mesh(n_data, n_spatial, devices=[args.device])
    if (mesh.size, mesh.rank) != (args.n, args.rank):
        raise SystemExit(f"rank {args.rank}: mesh of {mesh.size}, place {mesh.rank}")
    spatial = n_spatial > 1
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema_decay=0.9))
    trainer = Trainer(cfg, mesh=mesh, batch_per_epoch=10, seed=args.rank,
                      shard_spatial=spatial)
    batches = [local_batch(cfg, d) for d in range(n_data)]
    imgs = shard_batch(mesh, np.concatenate([b[0] for b in batches]), spatial=spatial)
    tgts = shard_batch(mesh, np.concatenate([b[1] for b in batches]))
    trainer.step(imgs, tgts)
    m = trainer.step(imgs, tgts)
    loss = float(m["total"])
    if not np.isfinite(loss) or trainer.state.step != 2:
        raise SystemExit(f"rank {args.rank}: loss {loss}, step {trainer.state.step}")
    for f in ("params", "batch_stats", "mu"):
        if not ranks_agree(mesh, getattr(trainer.state, f)):
            raise SystemExit(f"rank {args.rank}: the ranks' {f} differ")
    print(f"MP_OK rank={args.rank} backend={dist.get_backend()} device={mesh.device} "
          f"mesh={n_data}x{n_spatial} rows={tuple(imgs.shape[1:3])} loss={loss:.5f}",
          flush=True)

    path = trainer.save_checkpoint(args.ckpt_dir, epoch=0)
    fresh = Trainer(cfg, mesh=mesh, batch_per_epoch=10, seed=args.rank + 100,
                    shard_spatial=spatial)
    fresh.restore_checkpoint(path)
    if fresh.state.step != 2:
        raise SystemExit(f"rank {args.rank}: restored step {fresh.state.step}")
    for f in FIELDS:
        if not torch.equal(getattr(fresh.state, f), getattr(trainer.state, f)):
            raise SystemExit(f"rank {args.rank}: restored {f} differs from the saved")
    if not all(torch.equal(a, b) for a, b in zip(fresh.state.ema, trainer.state.ema)):
        raise SystemExit(f"rank {args.rank}: restored EMA differs from the saved")
    m = fresh.step(imgs, tgts)
    if not np.isfinite(float(m["total"])) or fresh.state.step != 3:
        raise SystemExit(f"rank {args.rank}: resumed step {m['total']}, {fresh.state.step}")
    print(f"MP_RESUME_OK rank={args.rank}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
