"""mAP validation: decode and NMS on the device, vectorised host matching.

The port of ``yolofastest_tpu/eval/map_eval.py`` (the reference
``Validation``, ``src/model_training/validate.py:8-139``): per-epoch mAP at
IOU 0.5 with greedy pred/GT matching and all-point interpolated AP, the COCO
grid mode (mAP@[.50:.95], size ranges, AR budgets) and strict pycocotools
mode, with the JAX package's matching and AP code unchanged (numpy).

On the device: the eval forward, :func:`decode_for_eval`, the top-k and
:func:`yolofastest_torch.ops.batched_nms` with ``pixel_offset=1`` (on the
card, the NMS kernel: one launch a batch).  One packed ``(B, max_det, 8)``
result a batch is moved to the host.  Short final batches
(``drop_last=False`` loaders) are padded to the loader's batch shape and
masked, so every validation image counts.

Divergences from the reference, as in the JAX package: a prediction is
matched to the **best**-IOU unmatched GT, and NMS suppresses at ``iou >
thre``.  IOU uses the reference's +1-pixel convention in NMS and matching;
strict-COCO mode (``iou_convention="coco"``, ``ap_interpolation="coco101"``)
uses the standard IOU, ``>=`` at the threshold, the last equal-IOU GT on a
tie, and 101-point AP.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolofastest_torch.configs import Config
from yolofastest_torch.losses import decode_for_eval
from yolofastest_torch.ops import batched_nms, unpack_detections
from yolofastest_torch.utils.device import exact_fp32


# COCO-style IOU grid for mAP@[.50:.95] (10 thresholds, step 0.05) —
# pass as MAPEvaluator(iou_thresholds=COCO_IOU_GRID) / CLI `eval --coco-map`.
# Beyond-reference: validate.py scores a single threshold only.
COCO_IOU_GRID = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))

# COCO object-size ranges in net-input pixels² (box w*h — boxes, not
# segmentation masks, so "area" is the box area as in cocoeval's bbox mode).
COCO_SIZE_RANGES = (
    ("small", 0.0, 32.0 ** 2),
    ("medium", 32.0 ** 2, 96.0 ** 2),
    ("large", 96.0 ** 2, float("inf")),
)


def _argmax_last(a: np.ndarray) -> np.ndarray:
    """Row-wise argmax that returns the LAST maximal column (pycocotools'
    evaluateImg keeps updating ``m`` on equal IOU, so the last equal-IOU GT
    wins; plain ``argmax`` keeps the first)."""
    return a.shape[1] - 1 - a[:, ::-1].argmax(axis=1)


def _match_with_ignores(iou_mat: np.ndarray, ts: np.ndarray,
                        gt_ig: np.ndarray, det_out: np.ndarray,
                        strict: bool = False):
    """Greedy matching with cocoeval's ignore semantics, vectorised across
    IOU thresholds (`cocoeval.py evaluateImg`): each detection (conf order)
    takes the best-IOU unmatched GT above threshold, preferring non-ignored
    GT; a det that only reaches an ignored GT — or stays unmatched with its
    own box outside the size range (``det_out``) — is *ignored*, not a FP.
    ``iou_mat`` is the (D, G) class-masked matrix.  ``strict`` applies
    pycocotools' exact boundary semantics (IOU == threshold matches; ties
    keep the LAST equal-IOU GT); default keeps this evaluator's historical
    strict-> and first-max conventions.  Returns ``(tp, ig)`` both (D, T)
    bool."""
    n_det, n_gt = iou_mat.shape
    n_t = len(ts)
    tp = np.zeros((n_det, n_t), bool)
    ig = np.zeros((n_det, n_t), bool)
    used = np.zeros((n_t, n_gt), bool)
    t_idx = np.arange(n_t)
    amax = _argmax_last if strict else (lambda a: a.argmax(axis=1))
    above = (lambda v: v >= ts) if strict else (lambda v: v > ts)
    for i in range(n_det):
        rows = np.where(used, -1.0, iou_mat[i][None, :])  # (T, G)
        reg = np.where(gt_ig[None, :], -1.0, rows)
        j_reg = amax(reg) if n_gt else np.zeros(n_t, int)
        hit_reg = above(reg[t_idx, j_reg]) if n_gt else np.zeros(n_t, bool)
        ign = np.where(gt_ig[None, :], rows, -1.0)
        j_ig = amax(ign) if n_gt else np.zeros(n_t, int)
        hit_ig = above(ign[t_idx, j_ig]) if n_gt else np.zeros(n_t, bool)
        j = np.where(hit_reg, j_reg, j_ig)
        matched = hit_reg | hit_ig
        used[matched, j[matched]] = True
        tp[i] = hit_reg
        ig[i] = (hit_ig & ~hit_reg) | (~matched & det_out[i])
    return tp, ig


def make_eval_fn(model: torch.nn.Module, config: Config):
    """``(variables, images) -> packed detections`` over the training model.

    ``variables`` (the flax-layout numpy tree, or None to score the model as
    it is) is loaded into ``model`` when it is not the tree loaded last.  The
    images (B, H, W, 1) go through the eval forward (BatchNorm on its running
    statistics; fp32 with TF32 off), the validation decode (float boxes,
    ``YOLOLossV3`` inference mode), the top ``max_decode`` by gated conf
    (ties in index order) and the class-aware NMS with the +1-pixel IOU.
    Returns the (B, max_det, 8) packed tensor on the model's device.
    """
    from yolofastest_torch.models.convert import module_state_from_variables

    io = config.io
    loaded = [None]

    def eval_fn(variables, imgs):
        dev = next(model.parameters()).device
        if variables is not None and variables is not loaded[0]:
            model.load_state_dict(module_state_from_variables(variables))
            loaded[0] = variables
        model.eval()
        with torch.inference_mode(), exact_fp32():
            x = torch.as_tensor(imgs, dtype=torch.float32).to(dev, non_blocking=True)
            heads = model(x)
            if not isinstance(heads, (tuple, list)):  # lite: single head
                heads = (heads,)
            dec = torch.cat([decode_for_eval(h, a, io.input_hw)
                             for h, a in zip(heads, io.anchors)], dim=1)
            xc, yc, bw, bh, conf = (dec[..., i] for i in range(5))
            boxes = torch.stack([xc - bw / 2, yc - bh / 2, xc + bw / 2, yc + bh / 2], dim=-1)
            cls_score, cls_idx = torch.max(dec[..., 5:], dim=-1)
            k = min(io.max_decode, conf.shape[1])
            gated = torch.where(conf >= io.conf_thre, conf, torch.full_like(conf, -1.0))
            top_conf, top_i = torch.sort(gated, dim=1, descending=True, stable=True)
            top_conf, top_i = top_conf[:, :k], top_i[:, :k]
            stacked = torch.cat([boxes, conf[..., None], cls_score[..., None],
                                 cls_idx.to(torch.float32)[..., None]], dim=-1)
            picked = torch.gather(stacked, 1, top_i[..., None].expand(-1, -1, 7))
            return batched_nms(
                picked[..., 0:4], picked[..., 4], picked[..., 5],
                picked[..., 6].to(torch.int32), top_conf >= io.conf_thre,
                iou_thre=io.nms_thre, max_det=io.max_det,
                pixel_offset=1.0,  # training-utils IOU convention
                packed=True)

    return eval_fn


def make_backend_eval_fn(engine, max_det: int = 64):
    """Adapt a deployment engine into the ``(variables, imgs) -> detections``
    signature :class:`MAPEvaluator` consumes, so the same matching and AP
    code measures mAP through the deployed pipeline: the port's
    :class:`~yolofastest_torch.inference.Detector` (BN-folded graph,
    detect-path rounding and NMS), one packed result a batch.  ``variables``
    is ignored: the engine owns its weights.  The C++ engine's branch raises
    until ``native/`` is ported.
    """
    if hasattr(engine, "run_packed"):
        def eval_fn(_variables, imgs):
            return engine.run_packed(imgs)

        return eval_fn
    if hasattr(engine, "detect"):
        raise TypeError("the native C++ engine is not ported yet (ROADMAP: "
                        "'Native engine'); score through the Detector")
    raise TypeError(f"cannot adapt {type(engine).__name__} to an eval_fn")


def _host_detections(det):
    """An eval_fn's result as the numpy detection dict: a packed (B, M, 8)
    tensor or array is moved to the host in one copy and unpacked; a dict
    passes with numpy leaves."""
    if isinstance(det, dict):
        return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in det.items()}
    return unpack_detections(det)


def _iou_matrix_p1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """+1-pixel IOU matrix of (D, 4) vs (G, 4) boxes (utils/general.py:29-52)."""
    a = a.astype(np.float64)  # degenerate early-training boxes overflow f32
    b = b.astype(np.float64)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    aa = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    ab = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (aa[:, None] + ab[None, :] - inter + 1e-16)


def _iou_matrix_std(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Standard (pycocotools bbox) IOU matrix of (D, 4) vs (G, 4) boxes."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (aa[:, None] + ab[None, :] - inter + 1e-16)


_IOU_MATRICES = {"plus1": _iou_matrix_p1, "coco": _iou_matrix_std}


def average_precision(confs: np.ndarray, is_tp: np.ndarray, n_gt: int) -> float:
    """All-point interpolated AP (reference ``__calculate_AP``,
    ``validate.py:91-122``): sort by conf desc, sweep PR points, area =
    sum (r_i - r_{i-1}) * max(precision[i:])."""
    if n_gt <= 0 or confs.size == 0:
        return 0.0
    order = np.argsort(-confs, kind="stable")
    tp = np.cumsum(is_tp[order])
    fp = np.cumsum(~is_tp[order])
    recall = tp / n_gt
    precision = tp / (tp + fp)
    # max precision over [i:] == reverse running max
    max_future = np.maximum.accumulate(precision[::-1])[::-1]
    prev_r = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - prev_r) * max_future))


# pycocotools' fixed recall sampling grid (Params.recThrs)
COCO_REC_THRS = np.linspace(0.0, 1.0, 101)


def average_precision_coco101(confs: np.ndarray, is_tp: np.ndarray,
                              n_gt: int) -> float:
    """pycocotools ``accumulate`` AP: precision envelope sampled at the 101
    fixed recall thresholds (q[r] = envelope precision at the first PR
    point with recall >= r; 0 past the curve's end)."""
    if n_gt <= 0:
        return 0.0
    if confs.size == 0:
        return 0.0
    order = np.argsort(-confs, kind="stable")
    tp = np.cumsum(is_tp[order])
    fp = np.cumsum(~is_tp[order])
    recall = tp / n_gt
    precision = tp / (tp + fp)
    envelope = np.maximum.accumulate(precision[::-1])[::-1]
    idx = np.searchsorted(recall, COCO_REC_THRS, side="left")
    q = np.where(idx < len(envelope), envelope[np.minimum(idx, len(envelope) - 1)], 0.0)
    return float(q.mean())


_AP_FNS = {"allpoint": average_precision, "coco101": average_precision_coco101}


class MAPEvaluator:
    """Run the val set, match detections to GT, report per-class AP + mAP.

    Call as ``evaluator(variables, epoch)`` (the validator hook
    :meth:`Trainer.fit` expects), ``variables`` being the flax-layout numpy
    tree; logs the reference's exact line format (``validate.py:80-87``).
    Without ``model`` or ``eval_fn``, the training model is built at the
    first call from the scored variables (a pruned tree builds its narrower
    blocks) on ``device`` ("cuda" by default; "cpu" on request).
    """

    def __init__(self, config: Config, loader, model: Optional[torch.nn.Module] = None,
                 logger=None, arch: str = "fastest", eval_fn=None,
                 iou_thresholds: Optional[Sequence[float]] = None,
                 iou_convention: str = "plus1",
                 ap_interpolation: str = "allpoint", device=None):
        self.config = config
        self.loader = loader
        self.logger = logger
        # Matching-IOU convention and AP interpolation (module docstring):
        # defaults reproduce the reference; ("coco", "coco101") is strict
        # pycocotools semantics (tools/cocoeval_ref.py cross-validation).
        if iou_convention not in _IOU_MATRICES:
            raise ValueError(f"unknown iou_convention {iou_convention!r}")
        if ap_interpolation not in _AP_FNS:
            raise ValueError(f"unknown ap_interpolation {ap_interpolation!r}")
        self._iou_matrix = _IOU_MATRICES[iou_convention]
        self._ap = _AP_FNS[ap_interpolation]
        # strict pycocotools matching boundaries (>= threshold, last-max
        # tie-break) ride with the standard-IOU convention
        self._strict = iou_convention == "coco"
        # Matching thresholds.  Default: the reference's single
        # ``iou_val_thre`` (mAP@0.5, validate.py:62).  Pass the COCO grid
        # (``COCO_IOU_GRID``) for mAP@[.50:.95] — threshold [0] stays the
        # headline metric (per-class lines, detection rate, return value);
        # the grid mean is logged/stored additionally.
        self.iou_thresholds = (
            tuple(iou_thresholds) if iou_thresholds
            else (config.train.iou_val_thre,))
        if eval_fn is not None:
            # Deployment-backend mode (make_backend_eval_fn): the engine owns
            # its weights, no model is built, __call__ takes variables=None.
            self.model = model
            self.eval_fn = eval_fn
            return
        # model=None: defer construction to the first __call__, so the model
        # is built against the variables actually being scored (a pruned
        # checkpoint carries narrower res blocks — models/prune.py).
        self._arch = arch
        self._device = device
        self.model = model
        self.eval_fn = make_eval_fn(model, config) if model is not None else None

    def _ensure_eval_fn(self, variables) -> None:
        if self.eval_fn is None:
            from yolofastest_torch.models.yolo_fastest import build_model
            from yolofastest_torch.utils.device import resolve_device

            io = self.config.io
            self.model = build_model(io.num_cls, io.num_anchors, arch=self._arch,
                                     variables=variables).to(resolve_device(self._device))
            self.eval_fn = make_eval_fn(self.model, self.config)

    def __call__(self, variables, epoch: int = 0) -> float:
        self._ensure_eval_fn(variables)
        io = self.config.io
        ts = np.asarray(self.iou_thresholds, np.float64)  # (T,) thresholds
        strict = self._strict
        n_t = len(ts)
        num_cls = io.num_cls
        h, w = io.input_hw
        target_num = np.zeros(num_cls, np.int64)
        # per class: [(conf, tp-vector over thresholds), ...]
        matches: List[List[Tuple[float, np.ndarray]]] = [[] for _ in range(num_cls)]
        gt_matched = 0  # at ts[0], across classes, for detection rate

        pad_to = getattr(self.loader, "batch_size", None)

        # COCO-grid mode extras (cocoeval analogues): size-range AP with
        # ignore semantics + AR at detection budgets.  Off in
        # single-threshold (reference-parity) mode — zero overhead there.
        coco = n_t > 1
        if coco:
            range_matches = {r: [[] for _ in range(num_cls)]
                             for r, _, _ in COCO_SIZE_RANGES}
            range_gt = {r: np.zeros(num_cls, np.int64)
                        for r, _, _ in COCO_SIZE_RANGES}
            ar_ks = None   # resolved from the detection pad width (max_det)
            ar_tp = None   # (C, T, K) matched-GT counts at top-k dets

        for imgs, targets in self.loader:
            # Pad a short final batch (drop_last=False loaders) to the
            # compiled batch shape with zero images; only the first n_valid
            # results are matched — no recompile, no image dropped.
            n_valid = imgs.shape[0]
            if pad_to and n_valid < pad_to:
                imgs = np.concatenate(
                    [imgs, np.zeros((pad_to - n_valid, *imgs.shape[1:]),
                                    imgs.dtype)]
                )
            det = _host_detections(self.eval_fn(variables, imgs))

            for b in range(n_valid):
                gt = targets[b]
                gt = gt[gt[:, 5] > 1]  # valid rows (validate.py:48)
                gt_xyxy = np.stack(
                    [
                        (gt[:, 0] - gt[:, 2] / 2) * w,
                        (gt[:, 1] - gt[:, 3] / 2) * h,
                        (gt[:, 0] + gt[:, 2] / 2) * w,
                        (gt[:, 1] + gt[:, 3] / 2) * h,
                    ],
                    axis=1,
                ) if len(gt) else np.zeros((0, 4), np.float32)
                gt_cls = gt[:, 4].astype(np.int32)
                for c in gt_cls:
                    target_num[c] += 1
                if coco:
                    gt_area = ((gt_xyxy[:, 2] - gt_xyxy[:, 0])
                               * (gt_xyxy[:, 3] - gt_xyxy[:, 1]))
                    for r, amin, amax in COCO_SIZE_RANGES:
                        in_r = (gt_area >= amin) & (gt_area < amax)
                        np.add.at(range_gt[r], gt_cls[in_r], 1)

                n_det = int(det["count"][b])
                if coco and ar_tp is None:
                    # Resolve the AR budgets from the detection pad width
                    # (max_det) of the FIRST batch — padded arrays carry the
                    # width even when this image has zero detections, so the
                    # reported budget keys never depend on whether anything
                    # was detected.
                    ar_ks = tuple(sorted({1, 10, det["boxes"].shape[1]}))
                    ar_tp = np.zeros((num_cls, n_t, len(ar_ks)), np.int64)
                if n_det == 0:
                    continue
                conf_det = det["conf"][b, :n_det].astype(np.float64)
                cls_det = det["cls_idx"][b, :n_det].astype(np.int32)
                if coco:
                    det_boxes = det["boxes"][b, :n_det].astype(np.float64)
                    det_area = ((det_boxes[:, 2] - det_boxes[:, 0])
                                * (det_boxes[:, 3] - det_boxes[:, 1]))
                if len(gt_cls) == 0:
                    fp = np.zeros(n_t, bool)
                    for i in range(n_det):
                        matches[cls_det[i]].append((float(conf_det[i]), fp))
                        if coco:
                            for r, amin, amax in COCO_SIZE_RANGES:
                                out_r = not (amin <= det_area[i] < amax)
                                range_matches[r][cls_det[i]].append(
                                    (float(conf_det[i]), fp,
                                     np.full(n_t, out_r)))
                    continue
                # One vectorised IOU matrix per image, then a greedy pass in
                # detection (conf-descending NMS) order over a used-GT mask —
                # vectorised across all T thresholds at once (each threshold
                # keeps its own mask: a det that misses at 0.75 may still
                # claim the GT a later det would have taken at 0.5).
                iou_mat = self._iou_matrix(det["boxes"][b, :n_det], gt_xyxy)
                iou_mat = np.where(cls_det[:, None] == gt_cls[None, :],
                                   iou_mat, -1.0)
                used = np.zeros((n_t, len(gt_cls)), bool)
                t_idx = np.arange(n_t)
                rank = np.zeros(num_cls, np.int64) if coco else None
                for i in range(n_det):
                    rows = np.where(used, -1.0, iou_mat[i][None, :])  # (T, G)
                    if strict:
                        # pycocotools boundary semantics: IOU == threshold
                        # matches; exact ties keep the LAST equal-IOU GT
                        j = _argmax_last(rows)
                        hit = rows[t_idx, j] >= ts
                    else:
                        j = rows.argmax(axis=1)  # best unmatched GT (divergence, see module doc)
                        hit = rows[t_idx, j] > ts
                    used[hit, j[hit]] = True
                    matches[cls_det[i]].append((float(conf_det[i]), hit))
                    if coco:
                        # greedy-prefix property: matching of det i never
                        # depends on later dets, so TP among a class's
                        # top-k dets == matched GT when only they are kept
                        c = cls_det[i]
                        for ki, k in enumerate(ar_ks):
                            if rank[c] < k:
                                ar_tp[c, :, ki] += hit
                        rank[c] += 1
                gt_matched += int(used[0].sum())
                if coco:
                    for r, amin, amax in COCO_SIZE_RANGES:
                        gt_ig = ~((gt_area >= amin) & (gt_area < amax))
                        det_out = ~((det_area >= amin) & (det_area < amax))
                        tp_r, ig_r = _match_with_ignores(
                            iou_mat, ts, gt_ig, det_out, strict=strict)
                        for i in range(n_det):
                            range_matches[r][cls_det[i]].append(
                                (float(conf_det[i]), tp_r[i], ig_r[i]))

        log = self.logger.info if self.logger else print
        log("—————— epoch: %d validation results —————" % epoch)
        # ap_grid[c][t] = AP of class c at threshold ts[t]; column 0 is the
        # headline (reference-format per-class lines + returned mAP).
        ap_grid = np.zeros((num_cls, n_t))
        for c in range(num_cls):
            m = matches[c]
            confs = np.array([x[0] for x in m], np.float64)
            tps = np.array([x[1] for x in m], bool).reshape(-1, n_t)
            for t in range(n_t):
                ap_grid[c, t] = self._ap(
                    confs, tps[:, t], int(target_num[c]))
            log("class: %s, target_num = %d, AP = %.3f"
                % (io.class_names[c], target_num[c], ap_grid[c, 0]))
        per_class_ap = ap_grid[:, 0].tolist()
        mAP = float(ap_grid[:, 0].mean())
        n_gt = int(target_num.sum())
        # Detection rate = matched GT / total GT — the reference README's
        # second headline metric (README.md:14-21, 检出率), which its code
        # never computes; here it is first-class.
        detection_rate = gt_matched / n_gt if n_gt else 0.0
        self.last_metrics = {
            "mAP": mAP,
            "per_class_ap": per_class_ap,
            "target_num": target_num.tolist(),
            "detection_rate": detection_rate,
        }
        log("mean AP: %.3f" % mAP)
        if n_t > 1:
            map_grid = float(ap_grid.mean())
            self.last_metrics["mAP_per_iou"] = {
                float(t): float(a) for t, a in zip(ts, ap_grid.mean(axis=0))}
            self.last_metrics["mAP_grid"] = map_grid
            log("mean AP@[%.2f:%.2f]: %.3f (%d IOU thresholds)"
                % (ts[0], ts[-1], map_grid, n_t))

            # ------- cocoeval's remaining summary rows (bbox mode) -------
            # AP/AR by object size (range means exclude classes with no GT
            # in the range; -1 when the whole range is empty, like
            # pycocotools' summarize()).
            for r, _, _ in COCO_SIZE_RANGES:
                aps = np.full((num_cls, n_t), np.nan)
                recs = np.full((num_cls, n_t), np.nan)
                for c in range(num_cls):
                    if range_gt[r][c] == 0:
                        continue
                    m = range_matches[r][c]
                    confs = np.array([x[0] for x in m], np.float64)
                    tps = np.array([x[1] for x in m], bool).reshape(-1, n_t)
                    igs = np.array([x[2] for x in m], bool).reshape(-1, n_t)
                    for t in range(n_t):
                        keep = ~igs[:, t]
                        aps[c, t] = self._ap(
                            confs[keep], tps[keep, t], int(range_gt[r][c]))
                    recs[c] = tps.sum(axis=0) / float(range_gt[r][c])
                has = np.isfinite(aps).any()
                self.last_metrics[f"AP_{r}"] = (
                    float(np.nanmean(aps)) if has else -1.0)
                self.last_metrics[f"AR_{r}"] = (
                    float(np.nanmean(recs)) if has else -1.0)
            if ar_tp is None:   # empty loader: no batches were seen at all
                ar_ks = tuple(sorted({1, 10, self.config.io.max_det}))
                ar_tp = np.zeros((num_cls, n_t, len(ar_ks)), np.int64)
            have_gt = target_num > 0
            ar_by_k = {}
            for ki, k in enumerate(ar_ks):
                if have_gt.any():
                    rec = ar_tp[have_gt, :, ki] / target_num[have_gt, None]
                    ar_by_k[int(k)] = float(rec.mean())
                else:
                    ar_by_k[int(k)] = -1.0
            self.last_metrics["AR_maxdets"] = ar_by_k
            log("AP@[%.2f:%.2f] small/medium/large: %.3f / %.3f / %.3f"
                % (ts[0], ts[-1], self.last_metrics["AP_small"],
                   self.last_metrics["AP_medium"],
                   self.last_metrics["AP_large"]))
            log("AR@[%.2f:%.2f] maxdets %s: %s; small/medium/large: "
                "%.3f / %.3f / %.3f"
                % (ts[0], ts[-1], "/".join(str(k) for k in ar_ks),
                   " / ".join("%.3f" % ar_by_k[int(k)] for k in ar_ks),
                   self.last_metrics["AR_small"],
                   self.last_metrics["AR_medium"],
                   self.last_metrics["AR_large"]))
        log("detection rate: %.3f (%d/%d targets)"
            % (detection_rate, gt_matched, n_gt))
        log("——————————————————————————")
        return mAP
