"""Multi-process data parallelism over a ``torch.distributed`` process group.

The port of ``yolofastest_tpu/parallel/distributed.py``.  JAX joins every
process to one coordinator and lets GSPMD reduce the gradients; here every
process is one rank of a process group, the ranks are the mesh's ``data``
axis (:mod:`yolofastest_torch.parallel.mesh`), each rank feeds its own shard
of the global batch, and the Trainer reduces what the global batch needs
(BatchNorm sums, loss denominators, the gradient) with ``all_reduce``.

* :func:`init_distributed` joins the group (a no-op for one process);
* :func:`host_to_global` puts a rank's host data on its device (a replicated
  array is rank 0's on every rank);
* :func:`global_batch_size` is the batch the ranks make together.

The multi-process dry run (:mod:`yolofastest_torch.parallel.dryrun`) tests
the wiring on the CPU (gloo) or on one card.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# torchrun's rendezvous variables, read by a bare init_distributed()
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def default_backend() -> str:
    """``nccl`` where the ranks run on a card (one is available), else
    ``gloo``.  Ranks that share one card need ``gloo``: NCCL refuses two
    ranks on one device."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the default process group.

    An explicitly single-process call (``num_processes == 1`` and no
    address) does nothing.  With ``coordinator_address`` (``host:port`` or
    ``tcp://host:port``), ``num_processes`` and ``process_id`` the group
    meets there.  A bare call reads torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; it is a single-process
    no-op only when none of them is set, and raises when some are: a
    swallowed error would train divergent copies, one per process.
    ``backend``: ``"nccl"``, ``"gloo"``, or None for :func:`default_backend`.
    """
    if num_processes == 1 and coordinator_address is None:
        return  # explicitly single process: nothing to join
    backend = backend or default_backend()
    explicit = (coordinator_address, num_processes, process_id)
    if all(v is None for v in explicit):
        missing = [v for v in ENV_VARS if v not in os.environ]
        if len(missing) == len(ENV_VARS):
            return  # no cluster environment: one process
        if missing:
            raise RuntimeError(f"init_distributed: a partial torchrun environment; "
                               f"{', '.join(missing)} not set")
        dist.init_process_group(backend, init_method="env://")
        return
    if any(v is None for v in explicit):
        raise ValueError("init_distributed: pass coordinator_address, num_processes and "
                         "process_id together (or none of them)")
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)


def host_to_global(sharding, arr) -> torch.Tensor:
    """This rank's portion of a global array, on the rank's device.

    For a batch sharding, ``arr`` is the rank's own shard (the global batch
    stays implicit: the ranks' shards in rank order).  For a replicated
    sharding every rank passes the whole array and gets rank 0's copy
    (broadcast), so the ranks hold one state.
    """
    mesh = sharding.mesh
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
    t = t.to(mesh.device)
    if not sharding.spec and mesh.size > 1:
        t = t.clone() if t is arr else t
        dist.broadcast(t, src=mesh.ranks[0], group=mesh.group)
    return t


def global_batch_size(per_host_batch: int) -> int:
    """The global batch of ``per_host_batch`` on every rank (what one step
    normalises and averages over)."""
    return per_host_batch * (dist.get_world_size() if dist.is_initialized() else 1)
