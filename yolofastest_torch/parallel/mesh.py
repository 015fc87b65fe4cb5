"""The mesh: the port's one place for the data-parallel layout.

The port of ``yolofastest_tpu/parallel/mesh.py``.  JAX's mesh is a grid of
devices whose ``data`` axis splits the batch (and an optional ``spatial``
axis splits image rows, GSPMD adding the convolutions' halo exchanges).
Here the ``data`` axis is the ranks of a ``torch.distributed`` process group,
one device each, and the collectives are written out where the step needs
them (:class:`~yolofastest_torch.train.Trainer`); they are ``all_reduce``
and ``broadcast`` only, the two that gloo implements for CUDA tensors too.

There is no ``spatial`` axis: the port has no halo exchange for split
image rows, so ``n_spatial > 1`` is refused.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from yolofastest_torch.utils.device import resolve_device

NO_SPATIAL = ("the 'spatial' axis splits image rows across devices, and its convolutions "
              "need GSPMD's halo exchange, which the port does not have; shard the batch "
              "only (n_spatial=1, shard_spatial=False)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis (``data``) mesh: the ranks of ``group`` in order, and this
    process's device.  ``group`` is None for one process outside a group."""

    group: Optional[dist.ProcessGroup]
    ranks: Tuple[int, ...]
    device: torch.device
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This process's place on ``data``."""
        return self.ranks.index(dist.get_rank()) if self.group is not None else 0

    @property
    def reduce_group(self) -> Optional[dist.ProcessGroup]:
        """The group to reduce over, or None where there is nothing to
        reduce (one rank): one rank launches no collective."""
        return self.group if self.size > 1 else None


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies on a mesh: ``spec`` ``()`` is replicated (every
    rank holds all of it), ``("data",)`` splits dimension 0 over the ranks."""

    mesh: Mesh
    spec: Tuple[str, ...]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the gradient of each rank's input is the
    sum of the ranks' output gradients (each rank's loss is its share of
    the global loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum of ``t`` over the ranks of ``group``."""
    return _AllReduceSum.apply(t, group)


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The ``data`` mesh of this process group (of this process alone
    outside one).

    ``n_data`` defaults to the group's size and must equal it.  ``devices``:
    one device for every rank, or one per rank in rank order; by default the
    card (``cuda:<LOCAL_RANK>``, else the rank, modulo the cards).
    """
    if n_spatial > 1:
        raise NotImplementedError(f"make_mesh(n_spatial={n_spatial}): {NO_SPATIAL}")
    grouped = dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if n_data is None:
        n_data = world
    if n_data != world:
        raise ValueError(f"make_mesh(n_data={n_data}): the data axis is the process "
                         f"group's {world} rank(s)")
    if devices is None:
        resolve_device(None)  # raises without a card: a CPU run names its devices
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    else:
        devices = list(devices)
        if len(devices) not in (1, world):
            raise ValueError(f"make_mesh: {len(devices)} devices for {world} rank(s)")
        device = torch.device(devices[rank if len(devices) > 1 else 0])
    group = dist.group.WORLD if grouped else None
    return Mesh(group=group, ranks=tuple(range(world)), device=device)


def replicate(mesh: Mesh) -> Sharding:
    """The sharding of replicated arrays (weights, optimizer state)."""
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, spatial: bool = False) -> Sharding:
    """The sharding of batches: dimension 0 over ``data``.  ``spatial``
    asks for image rows over ``spatial`` too, which, as in JAX, applies only
    where the mesh has that axis; the port's never does."""
    return Sharding(mesh, ("data",))


def shard_batch(mesh: Mesh, *arrays, spatial: bool = False):
    """This rank's equal slice of each global batch (dimension 0), on the
    rank's device.  A batch that the ranks do not divide is refused."""
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        n = t.shape[0]
        if n % mesh.size:
            raise ValueError(f"shard_batch: a batch of {n} does not divide over "
                             f"{mesh.size} ranks")
        per = n // mesh.size
        out.append(t[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]
