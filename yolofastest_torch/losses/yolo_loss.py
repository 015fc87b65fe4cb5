"""YOLOv3 loss with vectorised target assignment, on tensors.

The port of ``yolofastest_tpu/losses/yolo_loss.py`` (the reference
``YOLOLossV3``), with its semantics kept:

* target assignment runs on the device, over the 64 padded GT slots at once;
  on a cell collision the LAST active box wins (each write that a later
  active box to the same cell supersedes is dropped, then one scatter with
  unique indices), as the reference's sequential loop does;
* ``tcls`` is sticky-OR across colliding boxes (a scatter-max over every
  active box), and ``noobj`` is a scatter-min over every (box, anchor) tap;
* the first slot with valid-flag < 1 ends an image's assignment (a
  cumulative-product prefix); degenerate boxes are skipped without ending it;
* means run over the full ``(B, A, H, W)`` tensor; ``loss_cls`` averages
  over positive cells only, and is 0 when there are none;
* BCE is taken from logits, clamped where torch's ``BCELoss`` clamps its log
  at -100, so the gradient stays finite at sigmoid saturation;
* over a process group (``group``, the Trainer's data parallelism) each
  rank's loss is its share of the global batch's: the numerators are the
  rank's own, the denominators (the ``(B, A, H, W)`` count and ``n_pos``)
  global, so the ranks' losses and gradients sum to the global ones.

Everything is a plain differentiable function of the heads; the targets
carry no gradient.  Heads are NHWC ``(B, H, W, A*(5+C))``, anchor-major in
the channel axis.  The loss is computed in float32, or in float64 for
float64 heads (a reference run on the CPU).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

_LOG_CLAMP = -100.0  # torch nn.BCELoss clamps log terms at -100


def _softplus_c(z):
    """softplus clamped at 100 (``-log sigmoid(z) = softplus(-z)``), the -100
    log clamp of ``BCELoss``."""
    # F.softplus returns z itself above 20, where log(1 + e^z) rounds to z in
    # float32 anyway
    return torch.clamp(F.softplus(z), max=-_LOG_CLAMP)


def _bce_logits(z, target):
    """BCE of ``sigmoid(z)`` against ``target``, from the logits."""
    return target * _softplus_c(-z) + (1.0 - target) * _softplus_c(z)


def _shape_iou(gw, gh, anchors_wh):
    """Shape-only IOU of GT (w, h) against each anchor, with the reference's
    +1-pixel convention: (..., A)."""
    aw = anchors_wh[:, 0]
    ah = anchors_wh[:, 1]
    inter = (torch.minimum(gw[..., None], aw) + 1.0) * (torch.minimum(gh[..., None], ah) + 1.0)
    area_g = (gw + 1.0) * (gh + 1.0)
    area_a = (aw + 1.0) * (ah + 1.0)
    return inter / (area_g[..., None] + area_a - inter + 1e-16)


def build_targets(targets: torch.Tensor, anchors_wh: torch.Tensor, grid_hw: Tuple[int, int],
                  ignore_thre: float, num_cls: int = 3) -> Dict[str, torch.Tensor]:
    """Target assignment (reference ``get_target``).

    Args:
      targets: (B, T, 6) padded GT ``(xc, yc, w, h, cls, valid255)``, coords
        normalised to [0, 1].
      anchors_wh: (A, 2) anchors in feature-map units.
      grid_hw: (H, W) of this head.
      ignore_thre: shape-IOU above which a non-best anchor is left out of the
        no-object loss.

    Returns ``mask``, ``noobj_mask``, ``tx ty tw th`` (B, A, H, W) and
    ``tcls`` (B, A, H, W, C).
    """
    b, t, _ = targets.shape
    h, w = grid_hw
    na = anchors_wh.shape[0]
    dev = targets.device
    dt = anchors_wh.dtype
    targets = targets.detach().to(dt)

    gx = targets[..., 0] * w
    gy = targets[..., 1] * h
    gw = targets[..., 2] * w
    gh = targets[..., 3] * h
    cls_id = targets[..., 4].to(torch.int64)

    flag = (targets[..., 5] >= 1.0).to(dt)
    processed = torch.cumprod(flag, dim=1) > 0
    active = processed & (gw > 0) & (gh > 0)  # (B, T)

    gi = torch.clamp(gx.to(torch.int64), 0, w - 1)
    gj = torch.clamp(gy.to(torch.int64), 0, h - 1)

    iou = _shape_iou(gw, gh, anchors_wh)  # (B, T, A)
    best_n = torch.argmax(iou, dim=-1)  # (B, T), first maximum
    ignore = iou > ignore_thre

    best_aw = anchors_wh[best_n, 0]
    best_ah = anchors_wh[best_n, 1]
    tx_val = gx - gi.to(dt)
    ty_val = gy - gj.to(dt)
    tw_val = torch.log(gw / best_aw + 1e-16)
    th_val = torch.log(gh / best_ah + 1e-16)

    size = na * h * w
    cell = (best_n * h + gj) * w + gi  # (B, T) flat (a, j, i)
    later = torch.triu(torch.ones((t, t), dtype=torch.bool, device=dev), 1)[None]
    same = cell[:, :, None] == cell[:, None, :]
    superseded = torch.any(same & later & active[:, None, :], dim=2)
    write = active & ~superseded  # unique cells within an image

    # writes that do not happen go to one dump slot past the end
    dump = b * (size + 1)
    batch_off = (torch.arange(b, device=dev) * (size + 1))[:, None]
    flat_idx = torch.where(write, cell + batch_off, torch.full_like(cell, dump)).reshape(-1)

    def scatter_set(vals):
        arr = torch.zeros(dump + 1, dtype=dt, device=dev)
        arr = arr.index_put((flat_idx,), vals.reshape(-1).to(dt))
        return arr[:dump].reshape(b, size + 1)[:, :size].reshape(b, na, h, w)

    mask = scatter_set(write)
    tx = scatter_set(tx_val)
    ty = scatter_set(ty_val)
    tw = scatter_set(tw_val)
    th = scatter_set(th_val)

    # tcls: a scatter-max over every active box, so colliding boxes of
    # different classes both set their bit
    # a class id outside [0, num_cls) sets no bit, as jax.nn.one_hot
    onehot = (cls_id[..., None] == torch.arange(num_cls, device=dev)).to(dt)
    idx_all = torch.where(active, cell + batch_off, torch.full_like(cell, dump)).reshape(-1)
    tcls_arr = torch.zeros((dump + 1, num_cls), dtype=dt, device=dev)
    tcls_arr = tcls_arr.scatter_reduce(0, idx_all[:, None].expand(-1, num_cls),
                                       onehot.reshape(-1, num_cls), "amax")
    tcls = tcls_arr[:dump].reshape(b, size + 1, num_cls)[:, :size].reshape(b, na, h, w, num_cls)

    # noobj: 0 wherever any active box's shape-IOU with an anchor is above
    # the threshold, at that anchor's (gj, gi)
    anchor_cell = (torch.arange(na, device=dev)[None, None] * h + gj[:, :, None]) * w + gi[:, :, None]
    tap = active[:, :, None] & ignore  # (B, T, A)
    noobj_idx = torch.where(tap, anchor_cell + batch_off[:, :, None],
                            torch.full_like(anchor_cell, dump)).reshape(-1)
    noobj_arr = torch.ones(dump + 1, dtype=dt, device=dev)
    noobj_arr = noobj_arr.scatter_reduce(0, noobj_idx, torch.zeros_like(noobj_idx, dtype=dt), "amin")
    noobj = noobj_arr[:dump].reshape(b, size + 1)[:, :size].reshape(b, na, h, w)

    return {"mask": mask, "noobj_mask": noobj, "tx": tx, "ty": ty, "tw": tw, "th": th,
            "tcls": tcls}


def _loss_dtype(head: torch.Tensor) -> torch.dtype:
    return torch.promote_types(head.dtype, torch.float32)


def _scaled_anchors(anchors, stride_hw, head: torch.Tensor) -> torch.Tensor:
    """(A, 2) anchors in feature-map units, on the head's device."""
    return _anchor_table(tuple((float(aw), float(ah)) for aw, ah in anchors),
                         (float(stride_hw[0]), float(stride_hw[1])), head.device,
                         _loss_dtype(head))


@functools.lru_cache(maxsize=None)
def _anchor_table(anchors, stride_hw, device, dtype) -> torch.Tensor:
    # made once per device: a fresh host -> device copy every step would wait
    # for the card
    sh, sw = stride_hw
    return torch.tensor([(aw / sw, ah / sh) for aw, ah in anchors], dtype=dtype, device=device)


def yolo_loss(head: torch.Tensor, targets: torch.Tensor,
              anchors: Sequence[Tuple[float, float]], input_hw: Tuple[int, int],
              ignore_thre: float = 0.5, num_cls: int = 3, group=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss of ONE scale: ``(total, {x, y, w, h, conf, cls})``.

    Args:
      head: (B, H, W, A*(5+C)) raw NHWC logits.
      targets: (B, T, 6) padded normalised GT.
      anchors: A x (w, h) in net-input pixels for this scale.
      input_hw: network input (H, W).
      group: a process group whose ranks hold the rest of the batch (their
        denominators are summed), or None.
    """
    b, h, w, _ = head.shape
    na = len(anchors)
    scaled = _scaled_anchors(anchors, (input_hw[0] / h, input_hw[1] / w), head)

    p = head.to(_loss_dtype(head)).reshape(b, h, w, na, 5 + num_cls).permute(0, 3, 1, 2, 4)
    zx, zy, tw_p, th_p, z_conf = (p[..., i] for i in range(5))
    z_cls = p[..., 5:]

    tgt = build_targets(targets, scaled, (h, w), ignore_thre, num_cls)
    mask = tgt["mask"]
    noobj = tgt["noobj_mask"]
    n_total = b * na * h * w
    n_pos = torch.sum(mask)
    if group is not None:
        counts = torch.stack([n_pos.new_tensor(float(n_total)), n_pos])
        dist.all_reduce(counts, group=group)
        n_total, n_pos = counts[0], counts[1]

    loss_x = torch.sum(mask * _bce_logits(zx, tgt["tx"])) / n_total
    loss_y = torch.sum(mask * _bce_logits(zy, tgt["ty"])) / n_total
    loss_w = torch.sum(mask * (tw_p - tgt["tw"]) ** 2) / n_total
    loss_h = torch.sum(mask * (th_p - tgt["th"]) ** 2) / n_total
    loss_conf = (torch.sum(mask * _softplus_c(-z_conf)) / n_total
                 + 0.5 * torch.sum(noobj * _softplus_c(z_conf)) / n_total)

    cls_sum = torch.sum(mask[..., None] * _bce_logits(z_cls, tgt["tcls"]))
    loss_cls = torch.where(n_pos > 0, cls_sum / (n_pos * num_cls + 1e-16),
                           torch.zeros_like(cls_sum))

    lambda_xy, lambda_wh = 2.5, 2.5
    total = lambda_xy * (loss_x + loss_y) + lambda_wh * (loss_w + loss_h) + loss_conf + loss_cls
    return total, dict(x=loss_x, y=loss_y, w=loss_w, h=loss_h, conf=loss_conf, cls=loss_cls)


def total_loss(heads: Sequence[torch.Tensor], targets: torch.Tensor,
               anchors: Sequence[Sequence[Tuple[float, float]]], input_hw: Tuple[int, int],
               ignore_thre: float = 0.5, num_cls: int = 3,
               branch_weight: Sequence[float] = (1.0, 1.0), group=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum of the per-scale losses, each weighted by ``branch_weight``
    (``group`` as :func:`yolo_loss` takes it)."""
    tot = 0.0
    comps: Dict[str, torch.Tensor] = {}
    for i, (head, anc) in enumerate(zip(heads, anchors)):
        li, ci = yolo_loss(head, targets, anc, input_hw, ignore_thre, num_cls, group)
        tot = tot + branch_weight[i] * li
        for k, v in ci.items():
            comps[k] = comps[k] + v if k in comps else v
    comps["total"] = tot
    return tot, comps


def decode_for_eval(head: torch.Tensor, anchors: Sequence[Tuple[float, float]],
                    input_hw: Tuple[int, int]) -> torch.Tensor:
    """Inference-mode decode of one scale to ``(B, A*H*W, 5+C)`` rows ``(xc,
    yc, w, h)`` in net-input pixels, objectness and per-class sigmoid scores,
    anchor-major, then row, then column (the mAP validator's decode)."""
    b, h, w, c_tot = head.shape
    na = len(anchors)
    num_cls = c_tot // na - 5
    stride_h = input_hw[0] / h
    stride_w = input_hw[1] / w
    anc = _scaled_anchors(anchors, (stride_h, stride_w), head)

    p = head.to(_loss_dtype(head)).reshape(b, h, w, na, 5 + num_cls).permute(0, 3, 1, 2, 4)
    grid_x = torch.arange(w, dtype=p.dtype, device=head.device)[None, :]
    grid_y = torch.arange(h, dtype=p.dtype, device=head.device)[:, None]

    xc = (torch.sigmoid(p[..., 0]) + grid_x) * stride_w
    yc = (torch.sigmoid(p[..., 1]) + grid_y) * stride_h
    bw = torch.exp(p[..., 2]) * anc[None, :, 0, None, None] * stride_w
    bh = torch.exp(p[..., 3]) * anc[None, :, 1, None, None] * stride_h
    conf = torch.sigmoid(p[..., 4])
    cls = torch.sigmoid(p[..., 5:])
    out = torch.cat([torch.stack([xc, yc, bw, bh, conf], dim=-1), cls], dim=-1)
    return out.reshape(b, na * h * w, 5 + num_cls)


__all__ = ["build_targets", "decode_for_eval", "total_loss", "yolo_loss"]
