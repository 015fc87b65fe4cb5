"""YOLO head decode on tensors.

The port of ``yolofastest_tpu/ops/decode.py``:

* ``conf = sigmoid(t_obj)``; a candidate survives iff ``conf > conf_thre``
* ``cls_idx = argmax(cls logits)`` (first maximum); ``cls_score =
  sigmoid(max logit)``
* ``x = (j + sigmoid(tx)) * stride_w`` etc., ``w = exp(tw) * anchor_w``
* box corners rounded half-to-even (``torch.round``, like ``jnp.round``)

The top ``max_decode`` candidates per image are taken by a STABLE descending
sort: ``lax.top_k`` keeps ties in index order, and the invalid rows (gated to
-1.0) are all ties that reach the packed output; ``torch.topk`` promises no
order for ties.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch


@functools.lru_cache(maxsize=None)
def _anchor_wh(anchors: Tuple[Tuple[float, float], ...], device: torch.device):
    """Anchor widths and heights on ``device``, made once: a fresh host ->
    device copy on every call would wait for the card."""
    return (torch.tensor([a[0] for a in anchors], dtype=torch.float32, device=device),
            torch.tensor([a[1] for a in anchors], dtype=torch.float32, device=device))


def _decode_one_scale(head, anchors, input_hw):
    """Decode one head (B, H, W, A*(5+C)) -> per-candidate tensors flattened
    over (H, W, A)."""
    b, h, w, _ = head.shape
    na = len(anchors)
    head = head.reshape(b, h, w, na, -1).to(torch.float32)
    dev = head.device

    stride_h = input_hw[0] / h
    stride_w = input_hw[1] / w

    tx, ty, tw, th, tobj = (head[..., i] for i in range(5))
    cls_logits = head[..., 5:]

    conf = torch.sigmoid(tobj)  # (B,H,W,A)
    cls_idx = torch.argmax(cls_logits, dim=-1).to(torch.int32)
    cls_score = torch.sigmoid(torch.amax(cls_logits, dim=-1))

    grid_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    anchor_w, anchor_h = _anchor_wh(tuple(tuple(map(float, a)) for a in anchors), dev)

    cx = (grid_x + torch.sigmoid(tx)) * stride_w
    cy = (grid_y + torch.sigmoid(ty)) * stride_h
    bw = torch.exp(tw) * anchor_w  # anchors are in net-input pixels
    bh = torch.exp(th) * anchor_h

    x1 = torch.round(cx - bw / 2)
    y1 = torch.round(cy - bh / 2)
    x2 = torch.round(cx + bw / 2)
    y2 = torch.round(cy + bh / 2)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)  # (B,H,W,A,4)

    n = h * w * na
    return boxes.reshape(b, n, 4), conf.reshape(b, n), cls_score.reshape(b, n), \
        cls_idx.reshape(b, n)


def decode_heads(
    heads: Sequence[torch.Tensor],
    anchors: Sequence[Sequence[Tuple[float, float]]],
    input_hw: Tuple[int, int],
    conf_thre: float,
    max_decode: int = 128,
):
    """Decode all scales and keep the top ``max_decode`` candidates per image.

    Returns boxes (B,K,4) float32 xyxy in net-input coords (rounded), conf
    (B,K), cls_score (B,K), cls_idx (B,K) int32 and valid (B,K) bool, sorted
    by gated conf descending, ties in index order.
    """
    if len(heads) != len(anchors):
        raise ValueError(
            f"{len(heads)} head(s) but {len(anchors)} anchor group(s) — "
            "arch/config mismatch"
        )
    parts = [_decode_one_scale(h, a, input_hw) for h, a in zip(heads, anchors)]
    boxes = torch.cat([p[0] for p in parts], dim=1)
    conf = torch.cat([p[1] for p in parts], dim=1)
    cls_score = torch.cat([p[2] for p in parts], dim=1)
    cls_idx = torch.cat([p[3] for p in parts], dim=1)

    k = min(max_decode, conf.shape[1])
    gated = torch.where(conf > conf_thre, conf, torch.full_like(conf, -1.0))
    top_conf, top_i = torch.sort(gated, dim=1, descending=True, stable=True)
    top_conf, top_i = top_conf[:, :k], top_i[:, :k]
    stacked = torch.cat(
        [boxes, conf[..., None], cls_score[..., None],
         cls_idx.to(torch.float32)[..., None]],
        dim=-1,
    )  # (B, N, 7)
    picked = torch.gather(stacked, 1, top_i[..., None].expand(-1, -1, stacked.shape[-1]))
    return (
        picked[..., 0:4],
        picked[..., 4],
        picked[..., 5],
        picked[..., 6].to(torch.int32),
        top_conf > conf_thre,
    )
