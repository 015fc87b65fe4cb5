"""The mesh: the port's one place for the parallel layout.

The port of ``yolofastest_tpu/parallel/mesh.py``.  JAX's mesh is a grid of
devices whose ``data`` axis splits the batch and whose optional ``spatial``
axis splits image rows, GSPMD adding the convolutions' halo exchanges.  Here
the mesh's places are the ranks of a ``torch.distributed`` process group, one
device each: rank ``r`` sits at ``(r // n_spatial, r % n_spatial)``, JAX's
``devices.reshape(n_data, n_spatial)`` order.  The collectives are written
out where they are needed: the Trainer's reductions
(:class:`~yolofastest_torch.train.Trainer`) and the row halos of
:mod:`yolofastest_torch.parallel.halo`.  They are ``all_reduce`` and
``broadcast`` only, the two that gloo implements for CUDA tensors too, so
that ranks sharing one card (gloo; NCCL refuses two ranks on one device) run
every path.

With a ``spatial`` axis each rank holds whole rows at every stride of the
network: an image height that ``32 * n_spatial`` does not divide is refused
(:func:`check_image_rows`), where GSPMD would pad the uneven shards.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from yolofastest_torch.parallel.halo import RowShard
from yolofastest_torch.utils.device import resolve_device

# The network's coarsest stride: every rank of the spatial axis must hold
# whole rows at it.
ROW_STRIDE = 32


def check_image_rows(height: int, n_spatial: int, what: str = "the image") -> None:
    """Refuse an image height that does not split into whole rows at every
    stride of the network over ``n_spatial`` ranks (``32 * n_spatial`` must
    divide it)."""
    if n_spatial > 1 and height % (ROW_STRIDE * n_spatial):
        raise ValueError(
            f"{what}: a height of {height} rows does not split over {n_spatial} spatial "
            f"ranks into whole rows at stride {ROW_STRIDE}: {ROW_STRIDE} x {n_spatial} = "
            f"{ROW_STRIDE * n_spatial} must divide it (the port refuses uneven row shards)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``("data",)`` or ``("data", "spatial")`` mesh: the ranks of
    ``group`` in order, ``n_spatial`` to a data place, and this process's
    device.  ``group`` is None for one process outside a group.
    ``data_group`` holds the ranks with this rank's spatial index (the data
    axis through it), ``spatial_group`` the ranks with its data index; both
    are None on a one-axis mesh."""

    group: Optional[dist.ProcessGroup]
    ranks: Tuple[int, ...]
    device: torch.device
    axis_names: Tuple[str, ...] = ("data",)
    n_spatial: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    spatial_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def n_data(self) -> int:
        return self.size // self.n_spatial

    @property
    def rank(self) -> int:
        """This process's place on the mesh, in rank order."""
        return self.ranks.index(dist.get_rank()) if self.group is not None else 0

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.n_spatial

    @property
    def reduce_group(self) -> Optional[dist.ProcessGroup]:
        """The group of all the mesh's ranks, or None where there is nothing
        to reduce (one rank): one rank launches no collective."""
        return self.group if self.size > 1 else None

    @property
    def data_reduce_group(self) -> Optional[dist.ProcessGroup]:
        """The ranks of the data axis through this rank, or None for one
        data place."""
        if self.n_data == 1:
            return None
        return self.data_group if self.n_spatial > 1 else self.group

    @property
    def rows(self) -> RowShard:
        """This rank's place on the spatial axis (one place without one)."""
        return RowShard(self.spatial_group, self.spatial_index, self.n_spatial)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies on a mesh: ``spec`` ``()`` is replicated (every
    rank holds all of it), ``("data",)`` splits dimension 0 over the data
    axis, ``("data", "spatial")`` dimension 1 too over the spatial axis."""

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
    """The mesh of this process group (of this process alone outside one):
    ``("data",)``, or ``("data", "spatial")`` when ``n_spatial > 1``.

    ``n_data`` defaults to the group's size over ``n_spatial``, and ``n_data *
    n_spatial`` must equal the group's size.  With a spatial axis every rank
    creates the sub-groups in one order: the data groups (one per spatial
    index), then the spatial groups (one per data index).  ``devices``: one
    device for every rank, or one per rank in rank order; by default the
    card (``cuda:<LOCAL_RANK>``, else the rank, modulo the cards).
    """
    grouped = dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if n_spatial < 1:
        raise ValueError(f"make_mesh(n_spatial={n_spatial}): at least one place")
    if n_data is None:
        n_data = world // n_spatial
    if n_data * n_spatial != world:
        raise ValueError(f"make_mesh(n_data={n_data}, n_spatial={n_spatial}): the mesh's "
                         f"places are the process group's {world} rank(s)")
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
    if n_spatial == 1:
        return Mesh(group=group, ranks=tuple(range(world)), device=device)
    data_group = spatial_group = None
    for s in range(n_spatial):
        g = dist.new_group([d * n_spatial + s for d in range(n_data)])
        if s == rank % n_spatial:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_spatial + s for s in range(n_spatial)])
        if d == rank // n_spatial:
            spatial_group = g
    return Mesh(group=group, ranks=tuple(range(world)), device=device,
                axis_names=("data", "spatial"), n_spatial=n_spatial,
                data_group=data_group, spatial_group=spatial_group)


def replicate(mesh: Mesh) -> Sharding:
    """The sharding of replicated arrays (weights, optimizer state)."""
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, spatial: bool = False) -> Sharding:
    """The sharding of NHWC batches: dimension 0 over ``data``, and with
    ``spatial`` the image rows over ``spatial`` where the mesh has that
    axis (as in JAX, the flag asks nothing of a one-axis mesh)."""
    if spatial and "spatial" in mesh.axis_names:
        return Sharding(mesh, ("data", "spatial"))
    return Sharding(mesh, ("data",))


def shard_batch(mesh: Mesh, *arrays, spatial: bool = False):
    """This rank's slice of each global array, on the rank's device:
    dimension 0 split over the data axis, and with ``spatial`` dimension 1
    (the image rows) of every array with ``ndim >= 3`` over the spatial axis
    too (JAX's rule).  A batch that the data axis does not divide is
    refused, and so are rows that break :func:`check_image_rows`."""
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        spec = batch_sharding(mesh, spatial and t.ndim >= 3).spec
        n = t.shape[0]
        if n % mesh.n_data:
            raise ValueError(f"shard_batch: a batch of {n} does not divide over "
                             f"{mesh.n_data} ranks")
        per = n // mesh.n_data
        t = t[mesh.data_index * per:(mesh.data_index + 1) * per]
        if "spatial" in spec:
            h = t.shape[1]
            check_image_rows(h, mesh.n_spatial, "shard_batch")
            rows = h // mesh.n_spatial
            t = t[:, mesh.spatial_index * rows:(mesh.spatial_index + 1) * rows]
        out.append(t.to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]
