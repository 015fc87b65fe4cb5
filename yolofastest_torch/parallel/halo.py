"""Row halos of the mesh's ``spatial`` axis.

JAX's spatial axis splits image rows over devices, and GSPMD writes the
exchanges that a convolution over a row shard needs.  The port writes them
here, once, for every consumer: the spatial executor of the folded graph
(:class:`yolofastest_torch.models.graph.SpatialExecutor`), the training
model's convolutions and the gather of the heads.

A rank holds rows ``[i*h, (i+1)*h)`` of an image of ``n*h`` rows (its
:class:`RowShard`).  :func:`halo_rows` returns them with ``before`` rows
above and ``after`` rows below, clipped at the image's edges, and how many
rows it added above.  The halo may be deeper than a neighbour's shard: the
rows then come from every rank that holds them.  The exchange is ONE
``all_reduce`` of a zero buffer with a slot of ``before + after`` rows for
every rank, into which each rank writes the rows of the others' windows
that it owns (gloo implements only ``all_reduce`` and ``broadcast`` for CUDA
tensors, and ranks that share one card cannot use NCCL).  A sum of zeros and
one value is exact, so the halo rows are the owner's bits.  The backward is
the same exchange the other way: each rank writes the gradients of its halo
rows into its own slot, and every owner adds the gradients of its rows.

:func:`row_window` is what a convolution of kernel k and stride s needs for
its own output rows: ``(k - 1) // 2`` rows above, ``k - s - (k - 1) // 2``
below, with zero rows where the window passes a true image edge, so that the
convolution runs with no row padding.  :func:`gather_rows` puts the rows of
the spatial ranks together (one ``all_reduce`` for any number of tensors);
its backward keeps the rank's own rows of the gradient, because every rank
of a spatial group computes the same function of the gathered tensors.

:data:`EXCHANGES` counts the collectives issued (``halo``,
``halo_backward``, ``gather``); a mesh without a spatial axis issues none.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

EXCHANGES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class RowShard:
    """A rank's place on the spatial axis: the group of the ranks that share
    its images (None for one rank), its index there and their number."""

    group: Optional[dist.ProcessGroup] = None
    index: int = 0
    count: int = 1


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    # gloo reduces float32 and float64 everywhere; bf16 rows travel as fp32,
    # which holds them exactly
    return torch.promote_types(dtype, torch.float32)


def _window_spans(h: int, n: int, j: int, before: int, after: int):
    """Rank ``j``'s halo rows, as (slot offset, global first row, global
    end row) for the rows above and the rows below its shard."""
    return ((0, j * h - before, j * h),
            (before, (j + 1) * h, min((j + 1) * h + after, n * h)))


def _owned(h: int, i: int, first: int, end: int):
    """The part of global rows ``[first, end)`` that rank ``i`` holds."""
    return max(first, i * h, 0), min(end, (i + 1) * h)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, before, after, rows):
        b, h, w, c = x.shape
        n, i = rows.count, rows.index
        above, below = min(before, i * h), min(after, (n - 1 - i) * h)
        ctx.geometry = (h, n, i, before, after, above, below)
        ctx.group = rows.group
        buf = x.new_zeros((n, b, before + after, w, c), dtype=_wire_dtype(x.dtype))
        for j in range(n):
            if j == i:
                continue
            for slot, first, end in _window_spans(h, n, j, before, after):
                lo, hi = _owned(h, i, first, end)
                if lo < hi:
                    base = first if slot == 0 else first - slot
                    buf[j, :, lo - base:hi - base] = x[:, lo - i * h:hi - i * h]
        dist.all_reduce(buf, group=rows.group)
        EXCHANGES["halo"] += 1
        mine = buf[i].to(x.dtype)
        return torch.cat([mine[:, before - above:before], x, mine[:, before:before + below]], 1)

    @staticmethod
    def backward(ctx, g):
        h, n, i, before, after, above, below = ctx.geometry
        b, _, w, c = g.shape
        buf = g.new_zeros((n, b, before + after, w, c), dtype=_wire_dtype(g.dtype))
        buf[i, :, before - above:before] = g[:, :above]
        buf[i, :, before:before + below] = g[:, above + h:]
        dist.all_reduce(buf, group=ctx.group)
        EXCHANGES["halo_backward"] += 1
        gx = g[:, above:above + h].to(buf.dtype, copy=True)
        for j in range(n):
            if j == i:
                continue
            for slot, first, end in _window_spans(h, n, j, before, after):
                lo, hi = _owned(h, i, first, end)
                if lo < hi:
                    base = first if slot == 0 else first - slot
                    gx[:, lo - i * h:hi - i * h] += buf[j, :, lo - base:hi - base]
        return gx.to(g.dtype), None, None, None


def halo_rows(x: torch.Tensor, before: int, after: int,
              rows: RowShard) -> Tuple[torch.Tensor, int]:
    """A rank's NHWC rows ``x`` (B, h, W, C) with up to ``before`` rows above
    and ``after`` below, clipped at the image's edges: ``(rows, added
    above)``.  Differentiable.  Every rank of the group calls it with the
    same arguments (one ``all_reduce``); one rank alone gets ``x`` back."""
    if rows.count == 1 or before + after == 0:
        return x, 0
    h = x.shape[1]
    return _Halo.apply(x, before, after, rows), min(before, rows.index * h)


def row_window(x: torch.Tensor, kernel: int, stride: int, rows: RowShard) -> torch.Tensor:
    """The input rows (NHWC) that a ``kernel`` x ``kernel`` convolution of
    ``stride`` with ``(kernel - 1) // 2`` padding needs for this rank's own
    output rows, zero rows at the image's true edges: convolved with no row
    padding (and the column padding), it gives exactly those rows.  The
    rows a rank holds must be a multiple of ``stride``."""
    pad = (kernel - 1) // 2
    before, after = pad, kernel - stride - pad
    ext, above = halo_rows(x, before, after, rows)
    below = ext.shape[1] - above - x.shape[1]
    return F.pad(ext, (0, 0, 0, 0, before - above, after - below))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, *ts):
        n, i = rows.count, rows.index
        ctx.spans = [(i * t.shape[1], (i + 1) * t.shape[1]) for t in ts]
        wire = _wire_dtype(ts[0].dtype)
        fulls = [t.new_zeros((t.shape[0], n * t.shape[1], *t.shape[2:]), dtype=wire) for t in ts]
        flat = torch.cat([f.reshape(-1) for f in fulls])
        off = 0
        for t, f in zip(ts, fulls):
            view = flat[off:off + f.numel()].view(f.shape)
            view[:, i * t.shape[1]:(i + 1) * t.shape[1]] = t
            off += f.numel()
        dist.all_reduce(flat, group=rows.group)
        EXCHANGES["gather"] += 1
        out, off = [], 0
        for t, f in zip(ts, fulls):
            out.append(flat[off:off + f.numel()].view(f.shape).to(t.dtype))
            off += f.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *(g[:, a:b] for g, (a, b) in zip(gs, ctx.spans)))


def gather_rows(tensors: Sequence[torch.Tensor], rows: RowShard) -> Tuple[torch.Tensor, ...]:
    """The whole images of the spatial ranks' rows (dimension 1) of each
    tensor, in one ``all_reduce``; differentiable (the gradient of a rank's
    rows is its rows of the gathered tensor's gradient).  One rank alone
    gets its tensors back."""
    tensors = tuple(tensors)
    if rows.count == 1:
        return tensors
    return _Gather.apply(rows, *tensors)
