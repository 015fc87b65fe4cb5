"""Host-side data pipeline: load, augment, batch, prefetch.

The port's own copy of ``yolofastest_tpu/data/pipeline.py`` (numpy and cv2
only; batches equal under one seed, ``tests/test_torch_train.py``).  The
loader yields numpy; the trainer uploads each batch through pinned memory.

Capability-equivalent of ``DetectDataset`` + ``collate_fn``
(``src/model_training/dataloader/detect_dataset.py:42-162``), redesigned for
an accelerator input pipeline:

* output batches are **NHWC float32** already normalised ``(x - 128) / 255``
  (the reference splits this across ``__getitem__`` and ``collate_fn``;
  identical arithmetic, one place),
* labels are padded ``(max_boxes, 6)`` rows ``(xc, yc, w, h, cls, 255)`` with
  coords normalised to [0, 1] — the exact target format the loss consumes,
* a background-thread prefetcher keeps the accelerator fed (double
  buffering); the reference uses a synchronous ``DataLoader(num_workers=0)``.

Augmentation (reference ``:131-143``): Gaussian blur with probability
``gaussian_filter`` and horizontal flip with probability ``fliplr``.  The
reference's kernel-size branch is buggy (``elif _ret < 0.2`` is unreachable
after ``if _ret < 0.4``, so kernel 5 never fires); we draw uniformly from
{7, 5, 3} — documented divergence, matches the evident intent.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from yolofastest_torch.configs import Config


def _imread_gray_resized(img_path: str, input_hw: Tuple[int, int],
                         origin_hw: Tuple[int, int]) -> np.ndarray:
    import cv2

    img = cv2.imread(img_path)
    if img is None:
        raise FileNotFoundError(img_path)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if gray.shape[:2] != tuple(input_hw):
        gray = cv2.resize(gray, (input_hw[1], input_hw[0]))
    return gray


def multiscale_buckets(config: Config) -> Tuple[Tuple[int, int], ...]:
    """Static (H, W) buckets for multi-scale training: ``io.input_hw + k*32``
    for k in [-steps, +steps], both dims shifted together, floored at 64.

    Beyond-reference (the reference trains at one fixed resolution);
    darknet-style random-resolution jitter as a small FIXED set of shapes.
    """
    h, w = config.io.input_hw
    k = config.train.multiscale_steps
    out = []
    for d in range(-k, k + 1):
        hh, ww = h + 32 * d, w + 32 * d
        if hh >= 64 and ww >= 64:
            out.append((hh, ww))
    return tuple(out)


def load_example(
    img_path: str,
    labels: np.ndarray,
    config: Config,
    rng: Optional[np.random.Generator] = None,
    augment: bool = True,
    gray: Optional[np.ndarray] = None,
    out_hw: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (image, padded-targets) pair.

    Args:
      labels: (N, 5) rows ``(cls, x1, y1, x2, y2)`` in original-image pixels.
      rng: numpy Generator; augmentation is skipped when None or
        ``augment=False``.
      gray: optionally a pre-decoded ``(H, W) uint8`` net-input image (the
        loader's image cache); skips the jpeg decode + resize.
      out_hw: multi-scale bucket (H, W); the augmented net-input image is
        resized to it as the LAST pixel op (targets are normalised, so the
        label math is resolution-independent).  None = config resolution.

    Returns:
      img: (H, W, 1) float32, ``(x - 128) / 255`` normalised.
      targets: (max_boxes, 6) float32 ``(xc, yc, w, h, cls, 255)`` normalised.
    """
    io = config.io
    h0, w0 = io.origin_img_shape[0], io.origin_img_shape[1]
    if gray is None:
        gray = _imread_gray_resized(img_path, io.input_hw, (h0, w0))

    boxes = labels.reshape(-1, 5).astype(np.float32).copy()
    out = np.zeros((config.train.max_boxes, 6), np.float32)
    n = min(len(boxes), config.train.max_boxes)
    if n:
        cls = boxes[:n, 0]
        x1, y1, x2, y2 = boxes[:n, 1], boxes[:n, 2], boxes[:n, 3], boxes[:n, 4]
        xc = (x1 + x2) / 2.0 / w0
        yc = (y1 + y2) / 2.0 / h0
        bw = (x2 - x1) / w0
        bh = (y2 - y1) / h0
        out[:n] = np.stack([xc, yc, bw, bh, cls, np.full(n, 255.0)], axis=1)

    if augment and rng is not None:
        import cv2

        if rng.random() < config.augment.gaussian_filter:
            k = int(rng.choice([7, 5, 3]))
            gray = cv2.GaussianBlur(gray, (k, k), 0)
        if rng.random() < config.augment.fliplr:
            gray = np.fliplr(gray)
            out[:n, 0] = 1.0 - out[:n, 0]

    if out_hw is not None and gray.shape[:2] != tuple(out_hw):
        import cv2

        gray = cv2.resize(np.ascontiguousarray(gray), (out_hw[1], out_hw[0]))

    img = (gray.astype(np.float32) - 128.0) / 255.0
    return img[:, :, None], out


def mosaic_example(grays, labels_list, config: Config,
                   rng: np.random.Generator):
    """Compose four decoded net-input images into one mosaic canvas.

    Beyond-reference augmentation (the reference has blur + fliplr only,
    ``detect_dataset.py:131-143``): a random center point splits the canvas
    into four quadrants; image *i* fills quadrant *i* with the corner crop
    that fits, so the canvas has no padding seams.  Box labels follow their
    pixels and are clipped to the visible crop; slivers (< 2 px a side after
    clipping) are dropped.

    Args:
      grays: four ``(H, W) uint8`` net-input images (quadrant order TL, TR,
        BL, BR).
      labels_list: four ``(N, 5)`` arrays, rows ``(cls, x1, y1, x2, y2)`` in
        ORIGIN-image pixels (the dataset-index contract).

    Returns:
      ``(canvas (H, W) uint8, labels (M, 5) float32)`` with labels again in
      origin-image pixels — the same contract as a dataset item, so
      :func:`load_example` consumes the result unchanged (normalisation,
      padding, blur/flip).
    """
    h, w = config.io.input_hw
    h0, w0 = config.io.origin_img_shape[0], config.io.origin_img_shape[1]
    kx, ky = w / float(w0), h / float(h0)  # origin -> net-input scale
    cx = int(rng.uniform(0.3, 0.7) * w)
    cy = int(rng.uniform(0.3, 0.7) * h)
    canvas = np.empty((h, w), np.uint8)
    # ((canvas rows), (canvas cols), (source rows), (source cols)) per
    # quadrant: each source contributes the corner crop adjacent to the
    # mosaic center, so box shifts are pure translations.
    regions = (
        ((0, cy), (0, cx), (h - cy, h), (w - cx, w)),  # TL <- bottom-right
        ((0, cy), (cx, w), (h - cy, h), (0, w - cx)),  # TR <- bottom-left
        ((cy, h), (0, cx), (0, h - cy), (w - cx, w)),  # BL <- top-right
        ((cy, h), (cx, w), (0, h - cy), (0, w - cx)),  # BR <- top-left
    )
    out = []
    for g, lab, ((ry0, ry1), (rx0, rx1), (gy0, gy1), (gx0, gx1)) in zip(
            grays, labels_list, regions):
        canvas[ry0:ry1, rx0:rx1] = g[gy0:gy1, gx0:gx1]
        if len(lab) == 0:
            continue
        b = np.asarray(lab, np.float32).reshape(-1, 5).copy()
        b[:, (1, 3)] = b[:, (1, 3)] * kx + (rx0 - gx0)
        b[:, (2, 4)] = b[:, (2, 4)] * ky + (ry0 - gy0)
        b[:, (1, 3)] = b[:, (1, 3)].clip(rx0, rx1)
        b[:, (2, 4)] = b[:, (2, 4)].clip(ry0, ry1)
        keep = ((b[:, 3] - b[:, 1] >= 2.0) & (b[:, 4] - b[:, 2] >= 2.0))
        if keep.any():
            out.append(b[keep])
    if out:
        labels = np.concatenate(out)
        labels[:, (1, 3)] /= kx  # back to origin pixels (load_example scales)
        labels[:, (2, 4)] /= ky
    else:
        labels = np.zeros((0, 5), np.float32)
    return canvas, labels


class DetectionLoader:
    """Shuffling, drop-last batch loader with background prefetch.

    Yields ``(images (B,H,W,1) float32, targets (B,max_boxes,6) float32)``
    numpy batches per epoch.  ``prefetch`` batches are prepared ahead by a
    worker thread so host decode overlaps device compute.
    """

    def __init__(
        self,
        index,  # VOCIndex or any Sequence[(img_path, labels)]
        config: Config,
        batch_size: Optional[int] = None,
        augment: bool = True,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 4,
        num_workers: int = 0,
        drop_last: bool = True,
        cache: bool = False,
    ):
        self.index = index
        self.config = config
        self.batch_size = batch_size or config.train.batch_size
        self.augment = augment
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        # >0: decode images of a batch in a thread pool (cv2 releases the
        # GIL); the reference's DataLoader ran with num_workers=0.
        self.num_workers = num_workers
        # drop_last=True matches the reference train loader (train.py:72);
        # validation must use False so no image is silently excluded from mAP
        # (the reference validates every image).
        self.drop_last = drop_last
        # cache=True keeps every DECODED net-input image (uint8 gray) in
        # RAM after its first use, so epochs >= 2 skip the jpeg decode +
        # resize that otherwise bottlenecks the input pipeline
        # (augmentation and normalisation still run per epoch; batches are
        # bit-identical to the uncached path).  Memory: N * H * W bytes,
        # e.g. 8000 images at 256x320 = 655 MB.  Concurrent fills of the
        # same slot are idempotent (same decoded bytes).
        self._cache: Optional[np.ndarray] = None
        self._cache_filled: Optional[np.ndarray] = None
        if cache:
            self._cache = np.zeros((len(index), *config.io.input_hw), np.uint8)
            self._cache_filled = np.zeros(len(index), bool)

    def __len__(self) -> int:  # batches per epoch
        n, bs = len(self.index), self.batch_size
        return n // bs if self.drop_last else -(-n // bs)

    def _get_gray(self, i: int) -> np.ndarray:
        """Decoded net-input image for dataset item *i*, cache-aware."""
        io = self.config.io
        path, _ = self.index[i]
        if self._cache is None:
            return _imread_gray_resized(path, io.input_hw,
                                        io.origin_img_shape[:2])
        if not self._cache_filled[i]:
            self._cache[i] = _imread_gray_resized(path, io.input_hw,
                                                  io.origin_img_shape[:2])
            self._cache_filled[i] = True
        # read-only view: an accidental in-place edit downstream (e.g. a
        # future cv2 call with dst=) must raise instead of silently
        # corrupting the cache for all later epochs
        gray = self._cache[i].view()
        gray.flags.writeable = False
        return gray

    def _make_batch(self, idxs, rng,
                    out_hw: Optional[Tuple[int, int]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        io = self.config.io
        b = len(idxs)
        imgs = np.empty((b, *(out_hw or io.input_hw), io.input_channels),
                        np.float32)
        tgts = np.empty((b, self.config.train.max_boxes, 6), np.float32)
        p_mosaic = self.config.augment.mosaic if self.augment else 0.0

        def load_one(k, i, item_rng):
            path, labels = self.index[i]
            gray = self._get_gray(i) if self._cache is not None else None
            if p_mosaic > 0 and item_rng.random() < p_mosaic:
                extra = item_rng.integers(len(self.index), size=3)
                members = [i, *extra]
                gray, labels = mosaic_example(
                    [self._get_gray(j) for j in members],
                    [self.index[j][1] for j in members],
                    self.config, item_rng)
            imgs[k], tgts[k] = load_example(path, labels, self.config,
                                            item_rng, self.augment, gray=gray,
                                            out_hw=out_hw)

        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            # per-item child rngs keep augmentation deterministic regardless
            # of worker scheduling
            child = rng.spawn(b)
            with ThreadPoolExecutor(self.num_workers) as pool:
                list(pool.map(lambda t: load_one(*t), zip(range(b), idxs, child)))
        else:
            for k, i in enumerate(idxs):
                load_one(k, i, rng)
        return imgs, tgts

    def _draw_epoch(self):
        """An epoch's draws from the loader's stream: its order and (None for
        an empty epoch) its child rng, so epochs differ but runs are
        reproducible."""
        order = np.arange(len(self.index))
        if self.shuffle:
            self.rng.shuffle(order)
        if len(self) == 0:
            return order, None
        return order, np.random.default_rng(self.rng.integers(2**63))

    def skip_epochs(self, n: int) -> None:
        """Draw ``n`` epochs from the stream without loading them: a run
        resumed at epoch ``n`` then sees the batches an uninterrupted run
        sees there (its order, augmentation and multi-scale buckets)."""
        for _ in range(n):
            self._draw_epoch()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order, epoch_rng = self._draw_epoch()
        nb = len(self)
        if nb == 0:
            return

        # Multi-scale: one (H, W) bucket per group of ``multiscale_every``
        # batches, drawn up front so the augmentation rng stream is
        # untouched when the feature is off (the default path stays
        # bit-identical).  Augmenting loaders only — validation is base-res.
        scales = None
        if self.augment and self.config.train.multiscale_steps > 0:
            buckets = multiscale_buckets(self.config)
            every = max(1, self.config.train.multiscale_every)
            picks = epoch_rng.integers(len(buckets), size=-(-nb // every))
            scales = [buckets[picks[bi // every]] for bi in range(nb)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for bi in range(nb):
                    if stop.is_set():
                        return
                    idxs = order[bi * self.batch_size : (bi + 1) * self.batch_size]
                    q.put(self._make_batch(
                        idxs, epoch_rng,
                        out_hw=scales[bi] if scales else None))
                q.put(None)
            except BaseException as e:  # surface loader errors to the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
