"""End-to-end detection pipeline on the card: preprocess -> folded graph ->
decode -> NMS.

The port of ``yolofastest_tpu/inference/detector.py``: the fp backend in
the deployed mode (``fold_bn=True``, the BN-folded graph over the chain
kernels) and as the training model's eval forward (``fold_bn=False``), the
int8 and int8-fused backends (:mod:`yolofastest_torch.quant`: calibrated,
from a cache, or from a shipped int8 artifact, optionally with keep-fp
layers), both architectures and flip TTA.  Everything after image load runs on the
detector's device; the only host work is cv2 file IO.  On the card no step of the detect path reads
back to the host, so :meth:`Detector.run_packed` returns before the card is
done.

* :meth:`Detector.run` / :meth:`Detector.run_packed`: normalised net-input
  batch -> detections.
* :meth:`Detector.run_raw`: raw uint8 BGR frames -> detections, the
  preprocess on the device too.
* :meth:`Detector.batch_detect`: directory in, annotated images out, with
  the reference's per-image timing-log format.

With a ``mesh`` (:func:`yolofastest_torch.parallel.make_mesh`) the Detector
is one rank of the sharded pipeline of JAX's ``tests/test_sharded_inference.py``:
each rank passes its shard of the global batch (``shard_batch(mesh, x,
spatial=True)``: its data slice and, on a ``("data", "spatial")`` mesh, its
rows of the images), runs the folded graph on its rows over the spatial
executor (:func:`yolofastest_torch.models.spatial_apply`, the chain kernel
on each rank's rows plus their halos), gathers the heads' rows over
``spatial`` (a few KB an image), and decodes and runs the NMS kernel on its
data slice's images: every rank of a data place returns that slice's
detections.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolofastest_torch.configs import Config
from yolofastest_torch.models import (fold_batchnorm, folded_apply, folded_apply_lite,
                                      spatial_apply, torch_params_from_folded)
from yolofastest_torch.models.yolo_fastest import build_model
from yolofastest_torch.ops import (batched_nms, decode_heads, preprocess_device,
                                   unpack_detections)
from yolofastest_torch.quant import (QuantParams, calibrate, load_int8_zoo, ptq,
                                     quantize_weights, sensitivity)
from yolofastest_torch.utils.device import exact_fp32, resolve_device
from yolofastest_torch.utils.visualize import CLASS_COLORS, plot_one_box


class Detector:
    """YOLO-Fastest detector on one device.

    Args:
      config: framework config (anchors, thresholds, shapes).
      variables: the numpy ``{'params', 'batch_stats'}`` tree, as
        :func:`yolofastest_torch.models.load_variables` returns it (the JAX
        ``Detector`` takes the same tree).
      compute_dtype: torch.float32 for parity, torch.bfloat16 for speed.
      logger: where :meth:`batch_detect` logs (default: print).
      fold_bn: True (the default) runs the BN-folded deployment graph, whose
        six res chains are the chain kernel; False runs the trainable model
        (:mod:`yolofastest_torch.models.yolo_fastest`) in eval mode, BatchNorm
        on its running statistics, with plain convolutions.
      device: "cuda" (the default, which needs a card) or "cpu".
      arch: ``"fastest"`` (two heads) or ``"lite"`` (one head; use a
        ``lite-*`` config, whose one anchor group matches it).
      tta: horizontal-flip test-time augmentation.  The batch and its mirror
        run through the graph as ONE doubled batch (the six chain kernels
        launch once each, on 2B images), the mirrored candidates are
        un-mirrored, and both sets merge conf-sorted into one NMS.
      mesh: a mesh of the process group this rank belongs to (module
        docstring); the rank's device is the mesh's.  The fp backend with
        ``fold_bn=True`` only.
    """

    def __init__(
        self,
        config: Config,
        variables: Dict[str, Any],
        compute_dtype: torch.dtype = torch.float32,
        logger=None,
        fold_bn: bool = True,
        device=None,
        backend: str = "fp",
        arch: str = "fastest",
        tta: bool = False,
        calibration=None,
        calibration_cache: Optional[str] = None,
        calib_method: str = "amax",
        calib_percentile: float = 99.99,
        keep_fp: Sequence[str] = (),
        int8_artifact: Optional[str] = None,
        mesh=None,
    ):
        int8 = backend in ("int8", "int8-fused")
        if mesh is not None:
            if backend != "fp" or not fold_bn:
                raise ValueError("Detector(mesh=...) runs the fp backend's folded graph "
                                 "(backend='fp', fold_bn=True)")
            if device is not None:
                raise ValueError("Detector: pass a mesh or a device, not both (the mesh "
                                 "names the rank's device)")
            device = mesh.device
        if int8_artifact is not None:
            if not int8:
                raise ValueError("int8_artifact needs an int8 backend")
            if keep_fp:
                raise ValueError("int8_artifact and keep_fp are exclusive "
                                 "(the artifact IS the deployment config)")
            zoo8 = load_int8_zoo(int8_artifact)
            if zoo8 is None:
                raise ValueError(f"int8 artifact not found: {int8_artifact}")
        if backend not in ("fp", "int8", "int8-fused"):
            raise ValueError(f"unknown backend {backend!r}")
        if keep_fp and not int8:
            raise ValueError("keep_fp (mixed precision) applies to the int8 backends "
                             "(int8 / int8-fused) only")
        if arch not in ("fastest", "lite"):
            raise ValueError(f"unknown arch {arch!r}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        self.config = config
        self.backend = backend
        self.tta = tta
        self.mesh = mesh
        self.rows = mesh.rows if mesh is not None else None
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.logger = logger
        self.model = None
        if int8:
            self.params = None
            if int8_artifact is not None:
                folded, scales, keep_fp = zoo8  # the artifact's own keep-fp set
            else:
                folded = fold_batchnorm(variables)
                scales = self._load_or_calibrate(
                    folded, calibration, calibration_cache,
                    functools.partial(calibrate, arch=arch, method=calib_method,
                                      percentile=calib_percentile, device=self.device))
            self.act_scales = scales
            self.keep_fp = tuple(keep_fp)
            self._apply = _int8_apply(folded, scales, self.keep_fp, backend == "int8-fused",
                                      arch, self.device)
        elif fold_bn:
            self.params = torch_params_from_folded(fold_batchnorm(variables), self.device,
                                                   compute_dtype)
            self._apply = folded_apply if arch == "fastest" else folded_apply_lite
            if self.rows is not None and self.rows.count > 1:
                rows = self.rows
                self._apply = lambda params, x, dtype: spatial_apply(params, x, rows, dtype,
                                                                     arch)
        else:
            io = config.io
            self.model = build_model(io.num_cls, io.num_anchors, compute_dtype, arch,
                                     variables).to(self.device).eval()
            self.params = None
            self._apply = self._model_apply
        self._warm: set = set()

    @staticmethod
    def _load_or_calibrate(folded, calibration, cache_path, calibrate_fn):
        """The int8 scales: from ``cache_path`` when it exists, else
        calibrated on ``calibration`` and written there (JAX's JSON)."""
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                return {k: float(v) for k, v in json.load(f).items()}
        if calibration is None:
            raise ValueError("int8 backends need calibration= batches (or an existing "
                             "calibration_cache file)")
        batches = calibration if isinstance(calibration, (list, tuple)) else [calibration]
        scales = calibrate_fn(folded, batches)
        if cache_path:
            with open(cache_path, "w") as f:
                json.dump(scales, f, indent=1)
        return scales

    # ------------------------------------------------------------------ core
    def _model_apply(self, _params, x, _dtype):
        """The trainable model's eval forward (it casts under autocast for
        bf16 itself); fp32 convolutions with TF32 off."""
        with exact_fp32():
            return self.model(x)

    def _as_input(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def forward_heads(self, images) -> Tuple[torch.Tensor, ...]:
        """Net-input batch (B, H, W, 1) -> the heads, NHWC: (head_large,
        head_small), or (head_small,) for the lite graph.  With TTA the batch
        and its mirror go through as one (2B, H, W, 1) batch."""
        with torch.inference_mode():
            x = self._as_input(images)
            if self.tta:
                x = torch.cat([x, x.flip(2)], 0)
            return _as_heads(self._apply(self.params, x, self.compute_dtype))

    def postprocess(self, heads, packed: bool = False):
        """Heads -> decode (-> TTA merge) -> NMS (dict, or the packed
        (B, max_det, 8) tensor)."""
        io = self.config.io
        with torch.inference_mode():
            cand = decode_heads(heads, io.anchors, io.input_hw, io.conf_thre, io.max_decode)
            if self.tta:
                cand = _merge_tta(*cand, float(io.input_hw[1]))
            return batched_nms(*cand, iou_thre=io.nms_thre, max_det=io.max_det,
                               packed=packed)

    def preprocess(self, bgr_batch) -> torch.Tensor:
        """(B, H0, W0, 3) uint8 BGR -> (B, H, W, 1) net input on the device.
        On a spatial mesh ``bgr_batch`` is the rank's data slice of whole
        frames (the resize reads across rows), and the rank's rows of the
        net input come back."""
        with torch.inference_mode():
            x = preprocess_device(self._as_input(bgr_batch, torch.uint8),
                                  self.config.io.input_hw, self.compute_dtype)
            if self.rows is not None and self.rows.count > 1:
                h = x.shape[1] // self.rows.count
                x = x[:, self.rows.index * h:(self.rows.index + 1) * h]
            return x

    def warmup(self, batch_size: int = 1) -> None:
        """Run the pipeline once at this batch size (builds the kernels on
        first use), so that timed runs measure steady-state latency."""
        if batch_size in self._warm:
            return
        io = self.config.io
        h, w = io.input_hw
        if self.rows is not None:
            h //= self.rows.count
        dummy = torch.zeros((batch_size, h, w, io.input_channels),
                            dtype=torch.float32, device=self.device)
        self.run_packed(dummy).cpu()
        self._warm.add(batch_size)

    def run(self, images) -> Dict[str, torch.Tensor]:
        """Detect on a normalised net-input batch (B, H, W, 1) float."""
        return self.postprocess(self.forward_heads(images))

    def run_packed(self, images) -> torch.Tensor:
        """Like :meth:`run` but returns ONE (B, max_det, 8) tensor; decode on
        the host with :func:`yolofastest_torch.ops.unpack_detections`."""
        return self.postprocess(self.forward_heads(images), packed=True)

    def run_raw(self, bgr_batch) -> Dict[str, torch.Tensor]:
        """Detect on raw (B, H0, W0, 3) uint8 BGR frames, preprocessing
        (gray, resize, normalise) on the device."""
        return self.run(self.preprocess(bgr_batch))

    # ------------------------------------------------------------- host utils
    def preprocess_host(self, img_path: str):
        """Reference-exact host preprocessing via cv2 (detect.py:107-129)."""
        return load_net_input(img_path, self.config.io)

    def adjust_coords(self, boxes: np.ndarray) -> np.ndarray:
        """Net-input coords -> original-image coords (detect.py:131-139)."""
        io = self.config.io
        scale_h = io.origin_img_shape[0] / io.input_shape[0]
        scale_w = io.origin_img_shape[1] / io.input_shape[1]
        out = boxes.astype(np.float64).copy()
        out[..., [0, 2]] = np.round(out[..., [0, 2]] * scale_w)
        out[..., [1, 3]] = np.round(out[..., [1, 3]] * scale_h)
        return out

    def batch_detect(self, data_path: str, result_path: str,
                     batch_size: int = 1, overlap: bool = True) -> float:
        """Directory in, annotated results out, with reference-format timing
        logs (detect.py:141-192).  Returns the average total time in ms.

        The pipeline is warmed up before the timed loop, so every logged
        number is steady-state: host array -> device -> detect -> detections
        fetched back.  With ``batch_size > 1`` images run in chunks of that
        size (a short tail is padded) and the per-image time is the amortised
        chunk time.  ``overlap`` finalises chunk k (fetch, draw, save) after
        chunk k+1 was dispatched.  Preprocessing is outside the timed region.
        """
        import cv2

        if self.mesh is not None:
            raise ValueError("batch_detect reads a directory in one process; over a mesh "
                             "each rank calls run() on its shard")
        os.makedirs(result_path, exist_ok=True)
        io = self.config.io
        names = sorted(f for f in os.listdir(data_path)
                       if f.lower().endswith((".jpg", ".png", ".bmp")))
        log = self.logger.info if self.logger else print
        self.warmup(batch_size)
        totals = [0.0]

        def finalize(pending) -> None:
            chunk_names, chunk, out, dispatch_ms = pending
            n_valid = len(chunk)
            start = time.time()
            packed = out.cpu().numpy()  # ONE device->host copy (residual wait)
            infer_mark = time.time()
            det = unpack_detections(packed)
            infer_time = (dispatch_ms + (infer_mark - start) * 1e3) / n_valid

            all_rows = detections_to_lists(det)[:n_valid]
            post_time = (time.time() - infer_mark) * 1e3 / n_valid

            for k, rows in enumerate(all_rows):
                filename = chunk_names[k]
                ori = chunk[k][1]
                total = infer_time + post_time
                totals[0] += total

                if not rows:
                    cv2.imwrite(os.path.join(result_path, "result_" + filename), ori)
                    log("image_name:%s -> no targets, infer time:%.2fms, post_process time:%.2fms, total time:%.2fms"
                        % (filename, infer_time, post_time, total))
                    continue

                if io.input_shape[:2] != io.origin_img_shape[:2]:
                    for r in rows:
                        r[:4] = self.adjust_coords(np.asarray(r[:4], np.float64))
                for x1, y1, x2, y2, conf, cls_score, cls_idx in rows:
                    label = "%s %.2f" % (io.class_names[int(cls_idx)], conf * cls_score)
                    plot_one_box([x1, y1, x2, y2], ori,
                                 color=CLASS_COLORS[int(cls_idx) % len(CLASS_COLORS)],
                                 label=label, line_thickness=3)
                cv2.imwrite(os.path.join(result_path, "result_" + filename), ori)
                log("image_name:%s -> detect finished, infer time:%.2fms, post_process time:%.2fms, total time:%.2fms"
                    % (filename, infer_time, post_time, total))

        pending = None
        for c0 in range(0, len(names), batch_size):
            chunk = [self.preprocess_host(os.path.join(data_path, f))
                     for f in names[c0: c0 + batch_size]]
            n_valid = len(chunk)
            net_in = np.concatenate([p[0] for p in chunk])
            if n_valid < batch_size:  # pad the tail to the warmed batch size
                net_in = np.concatenate(
                    [net_in, np.zeros((batch_size - n_valid, *net_in.shape[1:]),
                                      net_in.dtype)])

            t0 = time.time()
            out = self.run_packed(torch.from_numpy(net_in))
            dispatch_ms = (time.time() - t0) * 1e3
            if pending is not None:
                finalize(pending)
            pending = (names[c0: c0 + batch_size], chunk, out, dispatch_ms)
            if not overlap:
                finalize(pending)
                pending = None
        if pending is not None:
            finalize(pending)

        avg = totals[0] / max(len(names), 1)
        log("detect avg_time: %.2fms" % avg)
        return avg


def _int8_apply(folded, scales, keep_fp, fused: bool, arch: str, device):
    """The int8 graph as the Detector's ``_apply(params, x, dtype)``: the
    int8 layers on ``device`` once, ``keep_fp`` layers (if any) as fp."""
    qp = QuantParams(quantize_weights(folded), device)
    if keep_fp:
        unknown = set(keep_fp) - set(qp)
        if unknown:
            raise ValueError(f"unknown keep_fp layer(s): {sorted(unknown)}")
        fp = sensitivity.fp_params(folded, keep_fp, device)
        mixed = (sensitivity.quantized_apply_fused_mixed if fused
                 else sensitivity.quantized_apply_mixed)
        return lambda _params, x, _dtype: mixed(qp, fp, scales, x, fp_layers=keep_fp,
                                                arch=arch)
    apply_q = ptq.quantized_apply_fused if fused else ptq.quantized_apply
    return lambda _params, x, _dtype: apply_q(qp, scales, x, arch=arch)


def _merge_tta(boxes, conf, cls_score, cls_idx, valid, w: float):
    """Merge a (2B, K, ...) candidate set from a [batch; mirrored batch]
    forward into (B, 2K, ...): un-mirror the flipped half's x coordinates and
    re-sort by confidence (the greedy NMS wants conf-descending input, and two
    sorted halves side by side are not sorted).  The sort is stable, so tied
    confidences keep index order, as ``lax.top_k`` keeps them."""
    b = boxes.shape[0] // 2
    bf = boxes[b:]
    bf = torch.stack([w - bf[..., 2], bf[..., 1], w - bf[..., 0], bf[..., 3]], dim=-1)
    boxes = torch.cat([boxes[:b], bf], dim=1)
    conf = torch.cat([conf[:b], conf[b:]], dim=1)
    cls_score = torch.cat([cls_score[:b], cls_score[b:]], dim=1)
    cls_idx = torch.cat([cls_idx[:b], cls_idx[b:]], dim=1)
    valid = torch.cat([valid[:b], valid[b:]], dim=1)
    gated = torch.where(valid, conf, torch.full_like(conf, -1.0))
    order = torch.sort(gated, dim=1, descending=True, stable=True).indices

    def take(t):
        idx = order[..., None].expand(-1, -1, t.shape[-1]) if t.ndim == 3 else order
        return torch.gather(t, 1, idx)

    return take(boxes), take(conf), take(cls_score), take(cls_idx), take(valid)


def _as_heads(out):
    """Normalise a graph output to a tuple of heads (lite returns one)."""
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def image_to_net_input(ori: np.ndarray, io) -> np.ndarray:
    """Decoded image array -> ``(H, W, C)`` float32 net input, the
    reference-exact host preprocess (detect.py:107-129): grayscale iff the
    config wants one channel, resize to the net shape, ``(x - 128) / 255``."""
    import cv2

    img = cv2.cvtColor(ori, cv2.COLOR_BGR2GRAY) if io.input_channels == 1 else ori
    if img.shape[:2] != io.input_hw:
        img = cv2.resize(img, (io.input_hw[1], io.input_hw[0]))
    net_in = (img.astype(np.float32) - 128.0) / 255.0
    return net_in[:, :, None] if net_in.ndim == 2 else net_in


def load_net_input(img_path: str, io) -> Tuple[np.ndarray, np.ndarray]:
    """Read and preprocess one image: ``((1, H, W, 1) float32 net input,
    original BGR image)``."""
    import cv2

    ori = cv2.imread(img_path)
    if ori is None:
        raise FileNotFoundError(
            f"cannot decode image {img_path!r} (cv2.imread returned None)")
    return image_to_net_input(ori, io)[None], ori


def detections_to_lists(det: Dict[str, Any]) -> List[List[List[float]]]:
    """Fixed-size detection tensors (torch or numpy) -> per-image python
    lists ``[x1, y1, x2, y2, conf, cls_score, cls_idx]`` (valid rows only)."""
    det = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
           for k, v in det.items()}
    out: List[List[List[float]]] = []
    for b in range(det["boxes"].shape[0]):
        rows = []
        for i in range(det["boxes"].shape[1]):
            if not det["valid"][b, i]:
                continue
            x1, y1, x2, y2 = det["boxes"][b, i]
            rows.append([
                float(x1), float(y1), float(x2), float(y2),
                float(det["conf"][b, i]), float(det["cls_score"][b, i]),
                int(det["cls_idx"][b, i]),
            ])
        out.append(rows)
    return out
