"""End-to-end detection pipeline on the card: preprocess -> folded graph ->
decode -> NMS.

The port of ``yolofastest_tpu/inference/detector.py`` for the deployed mode,
``Detector(..., fold_bn=True)`` with the fp backend.  Everything after image
load runs on the detector's device; the only host work is cv2 file IO.

* :meth:`Detector.run` / :meth:`Detector.run_packed`: normalised net-input
  batch -> detections.
* :meth:`Detector.run_raw`: raw uint8 BGR frames -> detections, the
  preprocess on the device too.
* :meth:`Detector.batch_detect`: directory in, annotated images out, with
  the reference's per-image timing-log format.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from yolofastest_torch.configs import Config
from yolofastest_torch.models import fold_batchnorm, folded_apply, torch_params_from_folded
from yolofastest_torch.ops import (batched_nms, decode_heads, preprocess_device,
                                   unpack_detections)
from yolofastest_torch.utils.device import resolve_device
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
      fold_bn: must be True: the port runs the BN-folded graph.
      device: "cuda" (the default, which needs a card) or "cpu".

    Not ported yet (ROADMAP, "Modules": to port): ``fold_bn=False`` (the
    training model), the int8 backends, ``arch="lite"`` and ``tta=True``.
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
    ):
        if not fold_bn:
            raise NotImplementedError(
                "fold_bn=False runs the training model, which the port does not "
                "have yet (ROADMAP: 'Training model and loss')")
        if backend != "fp":
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet (ROADMAP: 'Quantisation')")
        if arch != "fastest":
            raise NotImplementedError(
                f"arch {arch!r} is not ported yet (ROADMAP: 'Lite and pruned')")
        if tta:
            raise NotImplementedError(
                "tta is not ported yet (ROADMAP: 'TTA and sliced')")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        self.config = config
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.logger = logger
        self.params = torch_params_from_folded(fold_batchnorm(variables), self.device,
                                               compute_dtype)
        self._warm: set = set()

    # ------------------------------------------------------------------ core
    def _as_input(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def forward_heads(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """Net-input batch (B, H, W, 1) -> (head_large, head_small), NHWC."""
        with torch.inference_mode():
            return folded_apply(self.params, self._as_input(images), self.compute_dtype)

    def postprocess(self, heads, packed: bool = False):
        """Heads -> decode -> NMS (dict, or the packed (B, max_det, 8) tensor)."""
        io = self.config.io
        with torch.inference_mode():
            boxes, conf, cls_score, cls_idx, valid = decode_heads(
                heads, io.anchors, io.input_hw, io.conf_thre, io.max_decode)
            return batched_nms(boxes, conf, cls_score, cls_idx, valid,
                               iou_thre=io.nms_thre, max_det=io.max_det, packed=packed)

    def preprocess(self, bgr_batch) -> torch.Tensor:
        """(B, H0, W0, 3) uint8 BGR -> (B, H, W, 1) net input on the device."""
        with torch.inference_mode():
            return preprocess_device(self._as_input(bgr_batch, torch.uint8),
                                     self.config.io.input_hw, self.compute_dtype)

    def warmup(self, batch_size: int = 1) -> None:
        """Run the pipeline once at this batch size (builds the kernels on
        first use), so that timed runs measure steady-state latency."""
        if batch_size in self._warm:
            return
        io = self.config.io
        dummy = torch.zeros((batch_size, *io.input_hw, io.input_channels),
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
