"""Class-aware greedy NMS and its kept-first compaction: the CUDA kernel and
its plain versions.

The JAX package computes ``batched_nms`` (``yolofastest_tpu/ops/nms.py``) as
a ``lax.fori_loop`` for the keep mask, then a stable argsort of ``~keep`` and
a gather of the packed rows; no Pallas kernel stands behind it.
:func:`nms_packed` computes the same packed rows and the keep mask in one
launch of ``csrc/nms.cu`` for tensors on the card (no host read, so a detect
call returns before the card is done), and :func:`nms_packed_plain` for
tensors on the CPU.  The plain version follows the kernel's formulation
(word-packed suppression bits, a scan over rows, ranks from cumulative
counts), so the CPU tests reach its index logic; :func:`nms_keep_plain`, the
greedy loop, stays as the independent oracle of the mask.

Both public functions call registered operators (``yolofastest::nms_packed``,
``yolofastest::nms_keep``) with fake versions, so ``torch.export`` records
the NMS as one node.  All give the same bits: the kernel computes the IOU of
``ops/boxes.py::iou_pairwise`` with the same float32 operations in the same
order and compares it against the float32 threshold, as torch compares a
float32 tensor against a Python float; the packed rows are copies.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from yolofastest_torch.kernels._build import LAUNCHES
from yolofastest_torch.ops.boxes import box_iou_matrix

# Candidates an image the kernel takes: the removed set is one 32-bit word
# per lane of the scan warp.
MAX_ROWS = 1024


def nms_keep_plain(boxes, cls_idx, valid, iou_thre: float, pixel_offset: float = 0.0):
    """Plain PyTorch version (any device): (B, K, 4), (B, K), (B, K) -> (B, K)
    bool.  Rows after the last valid candidate of every image can suppress
    nothing, so the loop stops there, after one host read of that row."""
    k = boxes.shape[1]
    iou = box_iou_matrix(boxes, boxes, pixel_offset=pixel_offset)  # (B, K, K)
    same_class = cls_idx[:, :, None] == cls_idx[:, None, :]
    upper = torch.triu(torch.ones((k, k), dtype=torch.bool, device=boxes.device), 1)
    suppress = (iou > iou_thre) & same_class & upper & valid[:, :, None]
    keep = valid.clone()
    rows = torch.nonzero(valid.any(dim=0)).flatten()
    n = int(rows[-1]) + 1 if rows.numel() else 0
    for i in range(n):
        # candidate i removes later ones only if it itself survived
        keep &= ~(suppress[:, i] & keep[:, i:i + 1])
    return keep


def _pack_bits(bits):
    """(..., N) bool -> (..., ceil(N / 32)) int64 words: bit l of word w is
    element 32 w + l, as the kernel's ballots lay them out."""
    n = bits.shape[-1]
    n_words = -(-n // 32)
    bits = torch.nn.functional.pad(bits.to(torch.int64), (0, 32 * n_words - n))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits.reshape(*bits.shape[:-1], n_words, 32) << shifts).sum(-1)


def _unpack_bits(words, n: int):
    """Inverse of :func:`_pack_bits`: (..., W) words -> (..., n) bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n].bool()


def nms_packed_plain(boxes, conf, cls_score, cls_idx, valid, iou_thre: float,
                     max_det: int, pixel_offset: float = 0.0):
    """Plain PyTorch version of the kernel (any device), in its formulation.

    Row i's suppression bits (valid[i], j > i, same class, ``iou > thre``)
    are packed into 32-bit words; a scan over the rows ORs the words of each
    row still kept into the removed set; keep = valid and not removed.  Each
    row's place comes from cumulative counts: the r-th kept row goes to r,
    a row not kept to ``nkept + j - r``.  Returns the packed (B, min(K,
    max_det), 8) rows and the (B, K) keep mask, as :func:`nms_packed`."""
    b, k = valid.shape
    iou = box_iou_matrix(boxes, boxes, pixel_offset=pixel_offset)  # (B, K, K)
    same_class = cls_idx[:, :, None] == cls_idx[:, None, :]
    later = torch.triu(torch.ones((k, k), dtype=torch.bool, device=boxes.device), 1)
    words = _pack_bits((iou > iou_thre) & same_class & later & valid[:, :, None])  # (B, K, W)
    valid_words = _pack_bits(valid)  # (B, W)
    removed = torch.zeros_like(valid_words)
    rows = torch.nonzero(valid.any(dim=0)).flatten()
    for i in range(int(rows[-1]) + 1 if rows.numel() else 0):
        w, bit = divmod(i, 32)
        alive = ((valid_words[:, w] & ~removed[:, w]) >> bit) & 1  # (B,) 0 or 1
        removed[:, w:] |= words[:, i, w:] * alive[:, None]
    keep = _unpack_bits(valid_words & ~removed, k)

    kept = keep.to(torch.int64)
    rank = torch.cumsum(kept, dim=1) - kept  # kept rows before j
    n_kept = kept.sum(dim=1, keepdim=True)
    j = torch.arange(k, device=boxes.device)
    place = torch.where(keep, rank, n_kept + j - rank)
    stacked = torch.cat([boxes, conf[..., None], cls_score[..., None],
                         cls_idx.to(torch.float32)[..., None],
                         keep.to(torch.float32)[..., None]], dim=-1)  # (B, K, 8)
    packed = torch.empty_like(stacked).scatter_(1, place[..., None].expand(-1, -1, 8), stacked)
    return packed[:, :min(k, max_det)].contiguous(), keep


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures."""
    from yolofastest_torch.kernels import _build

    lib = _build.load("nms")
    vp, ci, cf, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.yf_nms_packed.argtypes = [vp, ll, ll] * 5 + [vp, vp, ci, ci, ci, cf, cf, vp]
    lib.yf_nms_packed.restype = ci
    lib.yf_nms_max_rows.argtypes = []
    lib.yf_nms_max_rows.restype = ci
    lib.yf_nms_error_string.argtypes = [ci]
    lib.yf_nms_error_string.restype = ctypes.c_char_p
    if lib.yf_nms_max_rows() != MAX_ROWS:
        raise RuntimeError("nms.cu and nms.py disagree on the candidates an image")
    return lib


@functools.lru_cache(maxsize=64)
def _float32(x: float) -> float:
    """The float32 value torch compares a float32 tensor against."""
    return float(np.float32(x))


_DTYPES = {"boxes": torch.float32, "conf": torch.float32, "cls_score": torch.float32,
           "cls_idx": torch.int32, "valid": torch.bool}


def _check(boxes, cls_idx, valid, conf=None, cls_score=None):
    """Shapes, dtypes and the device the kernel and its plain versions take."""
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2] or any(
            t is not None and t.shape != valid.shape for t in (cls_idx, conf, cls_score)):
        shapes = [tuple(t.shape) for t in (boxes, conf, cls_score, cls_idx, valid) if t is not None]
        raise ValueError(f"want boxes (B, K, 4) and the others (B, K); got {shapes}")
    k = valid.shape[1]
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"the NMS kernel takes 1 to at most {MAX_ROWS} candidates an image, "
                         f"not {k}")
    named = {"boxes": boxes, "conf": conf, "cls_score": cls_score, "cls_idx": cls_idx,
             "valid": valid}
    for name, t in named.items():
        if t is not None and t.dtype != _DTYPES[name]:
            raise TypeError(f"{name} must be {_DTYPES[name]}, not {t.dtype}")
        if t is not None and t.device != valid.device:
            raise ValueError(f"{name} is on {t.device}, valid on {valid.device}")
    if valid.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"NMS runs on cuda (kernel) or cpu (plain version), not {valid.device}")


def _launch(boxes, conf, cls_score, cls_idx, valid, iou_thre: float, max_det: int,
            pixel_offset: float):
    """One launch: the packed rows and keep."""
    if boxes.stride(-1) != 1:
        raise ValueError("the NMS kernel reads a box's four corners as neighbours: "
                         f"boxes' last stride must be 1, not {boxes.stride(-1)}")
    b, k = valid.shape
    dev = valid.device
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    m = min(k, max_det)
    packed = torch.empty((b, m, 8), dtype=torch.float32, device=dev)
    if b == 0:
        return packed, keep
    lib = _lib()
    rc = lib.yf_nms_packed(
        boxes.data_ptr(), boxes.stride(0), boxes.stride(1), conf.data_ptr(), *conf.stride(),
        cls_score.data_ptr(), *cls_score.stride(), cls_idx.data_ptr(), *cls_idx.stride(),
        valid.data_ptr(), *valid.stride(), packed.data_ptr(), keep.data_ptr(), b, k, m,
        _float32(iou_thre), float(pixel_offset), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms kernel launch failed: "
                           f"{lib.yf_nms_error_string(rc).decode()} (code {rc})")
    LAUNCHES["nms"] += 1
    return packed, keep


def _keep_launch(boxes, cls_idx, valid, iou_thre: float, pixel_offset: float):
    """The keep mask from one launch with one packed place an image, which is
    thrown away, so a view of the boxes stands in for conf and cls_score."""
    x1 = boxes[..., 0]
    return _launch(boxes, x1, x1, cls_idx, valid, iou_thre, 1, pixel_offset)[1]


# --------------------------------------------------------- registered operators
# ``yolofastest::nms_packed`` and ``yolofastest::nms_keep``: the kernel on the
# card, the plain versions on the CPU, and fake (shape-only) versions, so that
# torch.export records the NMS as one node and a saved program launches the
# kernel.  No autograd formula: nothing differentiates through the NMS.
_OPS = torch.library.Library("yolofastest", "FRAGMENT")
_OPS.define("nms_packed(Tensor boxes, Tensor conf, Tensor cls_score, Tensor cls_idx, "
            "Tensor valid, float iou_thre, int max_det, float pixel_offset) -> (Tensor, Tensor)")
_OPS.define("nms_keep(Tensor boxes, Tensor cls_idx, Tensor valid, float iou_thre, "
            "float pixel_offset) -> Tensor")
_OPS.impl("nms_packed", _launch, "CUDA")
_OPS.impl("nms_packed", nms_packed_plain, "CPU")
_OPS.impl("nms_keep", _keep_launch, "CUDA")
_OPS.impl("nms_keep", nms_keep_plain, "CPU")


@torch.library.register_fake("yolofastest::nms_packed", lib=_OPS)
def _nms_packed_fake(boxes, conf, cls_score, cls_idx, valid, iou_thre, max_det, pixel_offset):
    b, k = valid.shape
    return (boxes.new_empty((b, min(k, max_det), 8), dtype=torch.float32),
            valid.new_empty((b, k), dtype=torch.bool))


@torch.library.register_fake("yolofastest::nms_keep", lib=_OPS)
def _nms_keep_fake(boxes, cls_idx, valid, iou_thre, pixel_offset):
    return valid.new_empty(valid.shape, dtype=torch.bool)


NMS_PACKED_OP = torch.ops.yolofastest.nms_packed.default
NMS_KEEP_OP = torch.ops.yolofastest.nms_keep.default


def nms_packed(boxes, conf, cls_score, cls_idx, valid, iou_thre: float, max_det: int,
               pixel_offset: float = 0.0):
    """Batched class-aware greedy NMS, compacted kept-first.

    Args:
      boxes: (B, K, 4) float32 xyxy, conf-descending per image; the last
        stride 1, the others any (decode's views go in as they are).
      conf, cls_score: (B, K) float32; cls_idx: (B, K) int32; valid: (B, K)
        bool candidate mask.
      iou_thre: a later box of the same class is dropped where ``iou >
        iou_thre`` (compared in float32).
      max_det: places per image; the output has ``min(K, max_det)``.
      pixel_offset: IOU convention (0 = detect NMS, 1 = training utils).

    Returns ``(packed, keep)``: (B, min(K, max_det), 8) float32 rows
    ``(x1, y1, x2, y2, conf, cls_score, cls_idx, keep)``, the kept rows
    first and then the others, each group in index order, and the (B, K)
    bool keep mask.  The operator ``yolofastest::nms_packed``: one launch of
    the CUDA kernel for tensors on the card; :func:`nms_packed_plain` only
    for tensors on the CPU.  K is at most :data:`MAX_ROWS`.
    """
    _check(boxes, cls_idx, valid, conf, cls_score)
    if max_det < 1:
        raise ValueError(f"max_det must be at least 1, not {max_det}")
    return NMS_PACKED_OP(boxes, conf, cls_score, cls_idx, valid, float(iou_thre), int(max_det),
                         float(pixel_offset))


def nms_keep(boxes, cls_idx, valid, iou_thre: float, pixel_offset: float = 0.0):
    """Greedy class-aware keep mask for a batch: (B, K, 4), (B, K), (B, K) ->
    (B, K) bool, as :func:`nms_packed` takes them.  The operator
    ``yolofastest::nms_keep``: for tensors on the card, one launch of the
    NMS kernel with one packed place an image; :func:`nms_keep_plain` only
    for tensors on the CPU."""
    _check(boxes, cls_idx, valid)
    return NMS_KEEP_OP(boxes, cls_idx, valid, float(iou_thre), float(pixel_offset))
