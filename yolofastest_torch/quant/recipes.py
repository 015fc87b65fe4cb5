"""The int8 artifact recipes: how a deployment that keeps full golden recall
on every int8 backend at once is found and written.

The port of ``tools/make_int8_zoo.py``, ``tools/search_int8_recipe2.py``
and ``tools/search_pruned_int8.py`` (the scripts ``tools/torch_*.py`` are
argparse shells around this module):

* :func:`make_scales`: the ``(amax|mse|pct)(<K>|F)`` scale sets both
  searches name, a calibration over the first K golden frames (F: all);
* :func:`search_recall_qat`: QAT with snapshots, every candidate
  (``best-loss``, then the snapshots in step order) scored on the three
  int8 backends; the first whose smallest recall reaches the target ships;
* :func:`search_hybrid_keep_fp`: for each scale set, layers ranked by
  ``layer_sensitivity`` and greedily kept in fp by the joint recall of the
  two flagged applies, native scored only where both are full; the set
  with the fewest kept layers over all scale sets ships;
* :func:`build_shipped` and :func:`build_custom`: the recipes behind the
  committed artifacts, and the loss-selected exploration flow.

Nothing here writes where the caller did not say: every artifact goes to
the ``out`` path given.  The log lines are JAX's.
"""

from __future__ import annotations

import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolofastest_torch.configs import Config
from yolofastest_torch.eval.golden import (fetch, golden_inputs, matched_rows, native_int8_recall,
                                           post, score_int8)
from yolofastest_torch.quant.ptq import QuantParams, calibrate, quantize_weights
from yolofastest_torch.quant.qat import qat_finetune
from yolofastest_torch.quant.sensitivity import (fp_params, layer_sensitivity,
                                                 quantized_apply_flagged,
                                                 quantized_apply_fused_flagged)
from yolofastest_torch.quant.zoo import save_int8_zoo
from yolofastest_torch.utils.device import resolve_device

SCALE_SET = re.compile(r"(amax|mse|pct)(\d+|F)")
_METHODS = {"amax": "amax", "mse": "mse", "pct": "percentile"}
# tools/search_pruned_int8.py's default scale sets, in its order
PRUNED_SCALE_SETS = "mse12,amax8,amax12,amax16,amaxF,mse8,mse16,mseF,pct12,pctF"
Log = Callable[[str], None]


def _print(line: str) -> None:
    print(line, flush=True)


def parse_scale_set(spec: str) -> Tuple[str, Optional[int]]:
    """``spec`` -> ``(calibration method, frame count)``; the count is None
    for ``F`` (all frames).  Raises ``ValueError`` for another name."""
    m = SCALE_SET.fullmatch(spec)
    if not m:
        raise ValueError(f"unknown scale set {spec}")
    return _METHODS[m.group(1)], None if m.group(2) == "F" else int(m.group(2))


def make_scales(folded, imgs: np.ndarray, spec: str, device=None) -> Dict[str, float]:
    """The activation scales of the scale set ``spec``, calibrated on
    ``device`` (the card unless the caller asks for the CPU)."""
    method, count = parse_scale_set(spec)
    return calibrate(folded, [imgs if count is None else imgs[:count]], method=method,
                     device=device)


def _batches(imgs: np.ndarray) -> List[np.ndarray]:
    return [imgs[i:i + 4] for i in range(0, len(imgs), 4)]


# -------------------------------------------------- recall-selected QAT
def search_recall_qat(folded, cfg: Config, scales: Dict[str, float], *, spec: str,
                      imgs: np.ndarray, golden: np.ndarray, steps: int = 800, snap: int = 40,
                      lr: float = 5e-5, conf_weight: float = 4.0, target: int = 0,
                      out: Optional[str] = None, device=None, log: Log = _print,
                      score: Optional[Callable] = None,
                      record: Optional[Dict[str, Any]] = None):
    """QAT from ``folded`` at the frozen ``scales`` (named ``spec`` in the
    log), distilled with ``conf_weight`` over the frames in batches of 4, a
    snapshot every ``snap`` steps; the plain PTQ weights, then ``best-loss``,
    then every snapshot in step order are scored on the three int8 backends
    (``score(tree) -> (per-layer, fused, native)``, by default
    :func:`score_int8` on ``device``).  The first candidate whose smallest
    recall reaches ``target`` (0: every golden row) is returned as ``(tag,
    tree)`` and, with ``out``, written there by :func:`save_int8_zoo`; None
    when no candidate reaches it.  ``record``, where given, receives the
    scores (``[(label, recalls)]``), the loss history and the fine-tune's
    seconds."""
    dev = resolve_device(device)
    res = f"{cfg.io.input_hw[0]}x{cfg.io.input_hw[1]}"
    n = len(golden)
    target = target or n
    if score is None:
        def score(tree):
            return score_int8(tree, scales, (), cfg, dev, imgs, golden)
    record = {} if record is None else record
    record["scores"] = []

    def scored(tree, label):
        r1, r2, r3 = score(tree)
        record["scores"].append((label, (r1, r2, r3)))
        log(f"[{res}] {label}: jax {r1}/{n} fused {r2}/{n} native {r3}/{n}")
        return min(r1, r2, r3)

    scored(folded, f"ptq-{spec}")
    t0 = time.perf_counter()
    best_pt, hist, snaps = qat_finetune(folded, scales, _batches(imgs), arch="fastest",
                                        steps=steps, lr=lr, conf_weight=conf_weight,
                                        snapshot_every=snap, device=dev)
    record["qat_seconds"], record["history"] = time.perf_counter() - t0, hist
    log(f"[{res}] QAT loss {hist[0]:.3e} -> min {min(hist):.3e}")
    candidates = [("best-loss", best_pt)] + [(f"step{(i + 1) * snap}", s)
                                             for i, s in enumerate(snaps)]
    for tag, tree in candidates:
        if scored(tree, f"qat-{spec}-cw{conf_weight}-{tag}") >= target:
            log(f"[{res}] TARGET RECALL ({target}/{n}) at {tag}")
            if out:
                save_int8_zoo(tree, scales, out)
                log(f"shipped {out}")
            return tag, tree
    log(f"[{res}] no snapshot reached {target}/{n}")
    return None


# ------------------------------------------------ hybrid keep-fp search
class FlaggedScorer:
    """One scale set's scoring of keep-fp sets (``search_pruned_int8.py``'s
    closures): the layers ranked by ``layer_sensitivity``; the joint recall
    of the per-layer and fused flagged applies (int8/fp chosen per layer by
    flags on the device, one graph each) on all frames or a subset; the
    golden rows either misses; the native hybrid's recall.  A keep set's
    detections on a set of frames are computed once."""

    def __init__(self, folded, scales: Dict[str, float], cfg: Config, imgs: np.ndarray,
                 golden: np.ndarray, device=None):
        self.dev = resolve_device(device)
        self.folded, self.scales, self.cfg = folded, scales, cfg
        self.imgs, self.golden = imgs, golden
        self.qp = QuantParams(quantize_weights(folded), self.dev)
        self.fp = fp_params(folded, tuple(folded), self.dev)
        self.names = sorted(self.qp)
        self.x = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.dev)
        self._hits: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}

    def rank(self) -> List[str]:
        return [r["layer"] for r in layer_sensitivity(self.folded, [self.imgs],
                                                      act_scales=self.scales, device=self.dev)]

    def _matched(self, keep: Sequence[str], images: Optional[Sequence[int]]):
        """Per golden row of ``images``: found by the per-layer and by the
        fused apply, and those rows."""
        images = tuple(range(len(self.imgs))) if images is None else tuple(images)
        golden = self.golden[np.isin(self.golden[:, 0], images)]
        key = (tuple(keep), images)
        if key not in self._hits:
            remap = {b: i for i, b in enumerate(images)}
            local = golden.copy()
            local[:, 0] = [remap[int(b)] for b in golden[:, 0]]
            x = self.x if len(images) == len(self.imgs) else self.x[list(images)]
            flags = {n: n not in keep for n in self.names}
            with torch.inference_mode():
                dets = [fetch(post(fn(self.qp, self.fp, self.scales, x, flags), self.cfg.io))
                        for fn in (quantized_apply_flagged, quantized_apply_fused_flagged)]
            self._hits[key] = tuple(matched_rows(d, local) for d in dets)
        return self._hits[key], golden

    def recalls(self, keep: Sequence[str], images: Optional[Sequence[int]] = None
                ) -> Tuple[int, int]:
        """``(per-layer, fused)`` golden rows found on ``images`` (all)."""
        (pl, fu), _ = self._matched(keep, images)
        return int(pl.sum()), int(fu.sum())

    def missed(self, keep: Sequence[str]) -> List[np.ndarray]:
        """The golden rows missed by the per-layer apply, then those missed
        by the fused apply (a keep-fp addition can fix one and break the
        other: both drive the scan)."""
        (pl, fu), golden = self._matched(keep, None)
        return [row for hit in (pl, fu) for row, ok in zip(golden, hit) if not ok]

    def native(self, keep: Sequence[str]) -> int:
        return native_int8_recall(self.folded, self.scales, keep, self.cfg, self.imgs,
                                  self.golden)[0]


def search_hybrid_keep_fp(folded, cfg: Config, imgs: np.ndarray, golden: np.ndarray,
                          scale_sets: Sequence[str], *, max_keep: int = 8, scan_width: int = 20,
                          device=None, log: Log = _print,
                          scorer: Optional[Callable[[str], Any]] = None):
    """The hybrid keep-fp search of ``search_pruned_int8.py``: for each
    scale set, keep the layers in fp greedily, one a step, until the
    per-layer, fused and native recalls are all full or ``max_keep`` layers
    are kept.  A step scores the first ``scan_width`` layers of the
    sensitivity ranking not yet kept on the frames that hold missed golden
    rows (by the sum of both flagged recalls, a stable sort), checks the
    best five on all frames, and keeps the first that raises the joint
    recall (the one that makes both full, or the last that raised it).
    The native engine is scored only where both flagged applies are full.

    ``scorer(spec)`` gives a scale set's :class:`FlaggedScorer` (by
    default, over :func:`make_scales` on ``device``).  Returns ``(n_keep,
    spec, keep, recalls, scales)`` of the full-recall set with the fewest
    kept layers (the first found on a tie), or None."""
    dev = resolve_device(device)
    n_gold = len(golden)
    if scorer is None:
        def scorer(spec):
            return FlaggedScorer(folded, make_scales(folded, imgs, spec, dev), cfg, imgs,
                                 golden, dev)
    best = None
    for spec in scale_sets:
        sc = scorer(spec)
        rank = sc.rank()
        keep: List[str] = []
        for step in range(max_keep + 1):
            r_pl, r_fu = sc.recalls(keep)
            full = r_pl == n_gold and r_fu == n_gold
            r_na = sc.native(keep) if full else -1
            log(f"[{spec}] keep={len(keep)} {keep}: pl {r_pl}/{n_gold} fused {r_fu}/{n_gold} "
                f"native {r_na if r_na >= 0 else 'skipped'}/{n_gold}")
            if full and r_na == n_gold:
                if best is None or len(keep) < best[0]:
                    best = (len(keep), spec, tuple(keep), (r_pl, r_fu, r_na), sc.scales)
                break
            if step == max_keep:
                break
            sub_imgs = sorted({int(r[0]) for r in sc.missed(keep)})
            if not sub_imgs:  # both full, native short: scan on every frame
                sub_imgs = list(range(len(imgs)))
            n_sub = int(np.isin(golden[:, 0], sub_imgs).sum())
            cands = [c for c in rank if c not in keep][:scan_width]
            scored = [(sum(sc.recalls(keep + [c], sub_imgs)), c) for c in cands]
            scored.sort(key=lambda t: -t[0])
            log(f"[{spec}]   scan (imgs {sub_imgs}): "
                + ", ".join(f"{c}={r}/{2 * n_sub}" for r, c in scored[:6]))
            prev, chosen = r_pl + r_fu, None
            for _, c in scored[:5]:
                s_pl, s_fu = sc.recalls(keep + [c])
                if s_pl + s_fu > prev:
                    chosen, prev = c, s_pl + s_fu
                    if s_pl == n_gold and s_fu == n_gold:
                        break
            if chosen is None:
                log(f"[{spec}] no scanned addition improves joint recall; stopping")
                break
            keep.append(chosen)
        if best is not None and best[0] <= 1:
            break  # JAX's stop: a set of at most one layer ends the search
    return best


# ------------------------------------------------------ the shipped recipes
def build_shipped(res: str, out: str, device=None, log: Log = _print,
                  record: Optional[Dict[str, Any]] = None) -> str:
    """The recipe behind the committed ``weights/yolofastest_int8_<res>.npz``,
    written to ``out``: 512x640 is plain PTQ at amax scales over the first
    16 golden frames; 256x320 is :func:`search_recall_qat` at amax-8 scales,
    ``conf_weight`` 4, a snapshot every 20 of 800 steps (``SystemExit``
    where no candidate reaches full recall).  ``record`` as
    :func:`search_recall_qat`'s (512x640: the scales)."""
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.models import fold_batchnorm, load_variables, zoo_path

    record = {} if record is None else record
    if res not in ("512x640", "256x320"):
        raise SystemExit(f"no shipped recipe for {res}; use --custom")
    cfg = get_config(res)
    imgs, golden = golden_inputs(res)
    folded = fold_batchnorm(load_variables(zoo_path(res)))
    if res == "512x640":
        scales = record["scales"] = make_scales(folded, imgs, "amax16", device)
        save_int8_zoo(folded, scales, out)
        log(f"wrote {out} (plain PTQ, amax-16)")
        return out
    scales = make_scales(folded, imgs, "amax8", device)
    found = search_recall_qat(folded, cfg, scales, spec="amax8", imgs=imgs, golden=golden,
                              steps=800, snap=20, conf_weight=4.0, out=out, device=device,
                              log=log, record=record)
    if found is None:
        raise SystemExit(f"recipe2 search failed for {res}")
    return out


def build_custom(res: str, out: str, steps: int = 200, lr: float = 5e-5, method: str = "amax",
                 calib_k: int = 0, device=None, log: Log = _print) -> str:
    """The loss-selected exploration flow (not a shipped recipe): scales by
    ``method`` over the first ``calib_k`` golden frames (0: all), then
    ``steps`` of QAT (0: the plain PTQ weights), the lowest-loss weights
    written to ``out``."""
    from yolofastest_torch.models import fold_batchnorm, load_variables, zoo_path

    imgs, _ = golden_inputs(res)
    folded = fold_batchnorm(load_variables(zoo_path(res)))
    scales = calibrate(folded, [imgs[:calib_k] if calib_k else imgs], method=method,
                       device=device)
    tuned = folded
    if steps > 0:
        tuned, hist = qat_finetune(folded, scales, _batches(imgs), arch="fastest", steps=steps,
                                   lr=lr, device=device)
        log(f"[{res}] QAT: loss {hist[0]:.4e} -> best {min(hist):.4e} ({len(hist)} steps)")
    save_int8_zoo(tuned, scales, out)
    log(f"wrote {out}")
    return out
