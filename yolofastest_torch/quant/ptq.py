"""Post-training int8 quantisation of the folded graph.

The port of ``yolofastest_tpu/quant/ptq.py``: symmetric per-output-channel
int8 weights (:func:`quantize_weights`), per-tensor activation scales from a
calibration pass over the fp folded graph (:func:`calibrate`, with the amax,
mse, percentile and entropy rules), and the two int8 executors over the
shared topology walk: :class:`Int8Executor` (each layer quantises its float
input) and :class:`Int8FusedExecutor` (every inter-layer tensor stays int8,
requantised at the calibrated ``out/<name>`` scale).

**Integer products on the card.**  CUDA PyTorch has no int8 convolution.
Every quantised value is an integer in [-127, 127], so it is exact in
float32, and the executors hold the int8 values in float32 tensors and run
the layer's convolution in float32 with TF32 off (:func:`exact_fp32`).  A
partial sum of n such products is an integer of magnitude at most
``n * 127**2``; while that is at most 2**24 every partial sum is exact in
float32, in any order of summation, so the float accumulator is the int32
accumulator of the JAX package's ``preferred_element_type=int32`` product.
The largest contraction of the shipped graphs is 232 (``conv4_1_1``);
:class:`QuantParams` checks every layer against :data:`MAX_CONTRACTION` when
it is built and raises for a wider one.  Nothing moves to the host for the
products, on the card or anywhere else.

**The float epilogue** follows what XLA compiles for the JAX ``Detector``
(the executors jitted with the scales as constants), measured on the CPU:
XLA rewrites a division by a constant scale into a multiplication by its
float32 reciprocal, and fuses ``acc * m + bias`` into one fused
multiply-add.  The port computes the same values: ``round(x * f32(1 / s))``
half to even, and the epilogue with one rounding (float64 products of a
float32 accumulator and multiplier are exact, so the float64 sum rounded to
float32 is the fused multiply-add but in rare double-rounding cases).  Both
are correctly rounded elementwise operations, so the card and the CPU give
the same bits.

The recording executors, and every executor of this package, run the res
chains layer by layer (the base :class:`Executor`'s ``res_chain``): the
calibration needs each layer's amax, and the int8 products are not the fp
chain kernel's.  JAX's ``out_dtype`` argument is not ported: the Detector
always uses float32 heads.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolofastest_torch.models.convert import torch_params_from_folded
from yolofastest_torch.models.graph import (Executor, FoldedExecutor, _nchw, _nhwc,
                                            walk_topology, walk_topology_lite)
from yolofastest_torch.utils.device import exact_fp32, resolve_device

_WALKS = {"fastest": walk_topology, "lite": walk_topology_lite}

Q_MAX = 127
# The longest contraction whose partial sums stay exact in float32: every
# integer of magnitude at most 2**24 is a float32.
MAX_CONTRACTION = 2 ** 24 // (Q_MAX * Q_MAX)


# ------------------------------------------------------------------ weights
def quantize_weights(folded: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, Dict[str, np.ndarray]]:
    """Folded fp params -> int8 params.

    Per layer: ``kernel_q`` int8 (same layout as fp), ``w_scale`` (O,)
    float32, ``bias`` float32 passthrough.
    """
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, p in folded.items():
        k = np.asarray(p["kernel"], np.float32)
        reduce_axes = tuple(range(k.ndim - 1))  # all but out-channel (last)
        amax = np.max(np.abs(k), axis=reduce_axes)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        kq = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
        out[name] = {"kernel_q": kq, "w_scale": scale, "bias": p["bias"].astype(np.float32)}
    return out


# -------------------------------------------------------------- calibration
class _RecordingExecutor(FoldedExecutor):
    """fp folded executor that records per-op input AND output amax.

    Output amaxes (keyed ``out/<name>``, with ``add``/``concat`` pseudo-ops
    numbered in walk order) drive the fused int8 path.  The chains run
    layer by layer, so every ``res*/conv*`` records and the adds are
    numbered as in the JAX walk."""

    res_chain = Executor.res_chain

    def __init__(self, params):
        super().__init__(params, torch.float32)
        self.amax: Dict[str, torch.Tensor] = {}
        self._counters = {"add": 0, "concat": 0}

    def _rec(self, key, x):
        self.amax[key] = x.float().abs().amax()

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        self._rec(name, x)
        y = super().conv(x, name, kernel, stride, depthwise, act)
        self._rec(f"out/{name}", y)
        return y

    def deconv2x(self, x, name):
        self._rec(name, x)
        y = super().deconv2x(x, name)
        self._rec(f"out/{name}", y)
        return y

    def head(self, x, name):
        self._rec(name, x)
        # FoldedExecutor.head is self.conv, which would record out/head_*
        return FoldedExecutor.conv(self, x, name, 1, act=False)

    def _pseudo(self, kind):
        n = self._counters[kind]
        self._counters[kind] += 1
        return f"out/{kind}_{n}"

    def add(self, x, y):
        z = x + y
        self._rec(self._pseudo("add"), z)
        return z

    def concat(self, x, y):
        z = torch.cat([x, y], dim=-1)
        self._rec(self._pseudo("concat"), z)
        return z


class _HistRecordingExecutor(_RecordingExecutor):
    """Second calibration pass: per-op |x| histograms over [0, amax].

    ``inv_ranges`` holds, per key, the float32 reciprocal of the first
    pass's global amax (at least 1e-30), as XLA computes the JAX package's
    ``a / r * bins`` with ``r`` a constant: ``a * f32(1 / r) * bins``,
    truncated and clipped to ``[0, bins - 1]``."""

    def __init__(self, params, inv_ranges: Dict[str, torch.Tensor], bins: int):
        super().__init__(params)
        self.inv_ranges = inv_ranges
        self.bins = bins
        self.hist: Dict[str, torch.Tensor] = {}

    def _rec(self, key, x):
        a = x.float().abs().flatten()
        idx = (a * self.inv_ranges[key] * self.bins).to(torch.int64).clamp_(0, self.bins - 1)
        self.hist[key] = torch.bincount(idx, minlength=self.bins)


def _percentile_threshold(hist: np.ndarray, percentile: float) -> int:
    """Smallest bin count t (1-based) whose cdf covers ``percentile`` % of
    the recorded values."""
    total = int(hist.sum())
    if total == 0:
        return len(hist)
    cdf = np.cumsum(hist.astype(np.float64))
    target = total * (percentile / 100.0)
    return int(np.searchsorted(cdf, target, side="left")) + 1


def _smooth(p: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Move ``eps`` of probability mass onto zero entries so KL stays
    finite (the TensorRT/MXNet smoothing)."""
    p = p.astype(np.float64)
    s = p.sum()
    if s <= 0:
        return np.full_like(p, 1.0 / len(p))
    p = p / s
    is_zero = p == 0.0
    n_zero = int(is_zero.sum())
    if n_zero == 0 or n_zero == len(p):
        return p
    shift = eps * n_zero / (len(p) - n_zero)
    # clip guards sparse histograms where a tiny nonzero bin < shift
    return np.clip(np.where(is_zero, eps, p - shift), 1e-12, None)


def _kl_threshold(hist: np.ndarray, target: int = 128, stride: int = 8) -> int:
    """TensorRT-style entropy calibration: the clip bin count i (1-based,
    scanned at ``stride`` granularity) minimising KL(P_i || Q_i) where P_i is
    the distribution clipped at bin i (outliers merged into the edge bin) and
    Q_i is P_i's support re-quantised into ``target`` levels."""
    bins = len(hist)
    hist = hist.astype(np.float64)
    if hist.sum() == 0:
        return bins
    best_i, best_kl = bins, np.inf
    cands = list(range(target, bins + 1, stride))
    if cands[-1] != bins:
        cands.append(bins)  # the unclipped range is always a candidate
    for i in cands:
        ref = hist[:i]
        p = ref.copy()
        p[i - 1] += hist[i:].sum()
        nonzero = p != 0
        # merge i bins into `target` chunks; spread each chunk's mass evenly
        # over that chunk's nonzero positions
        edges = (np.arange(target + 1, dtype=np.int64) * i) // target
        chunk_sums = np.add.reduceat(ref, edges[:-1])
        chunk_nnz = np.add.reduceat(nonzero.astype(np.float64), edges[:-1])
        widths = np.diff(edges)
        avg = np.where(chunk_nnz > 0, chunk_sums / np.maximum(chunk_nnz, 1), 0.0)
        q = np.where(nonzero, np.repeat(avg, widths), 0.0)
        ps, qs = _smooth(p), _smooth(q)
        kl = float(np.sum(ps * np.log(ps / qs)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i


def _mse_threshold(hist: np.ndarray, bins: int, n_cand: int = 128) -> int:
    """Clip bin count (1-based) minimising the expected squared
    quantisation error computed from the |x| histogram: for each candidate
    threshold t the per-bin error uses the bin center, values beyond t
    saturate at t."""
    total = hist.sum()
    if total == 0:
        return bins
    centers = (np.arange(bins, dtype=np.float64) + 0.5) / bins  # units of amax
    step = max(bins // n_cand, 1)
    cand_bins = np.arange(step, bins + 1, step, dtype=np.int64)
    if cand_bins[-1] != bins:
        cand_bins = np.append(cand_bins, bins)
    t = cand_bins[:, None].astype(np.float64) / bins
    s = t / 127.0
    q = np.minimum(np.round(centers[None, :] / s), 127.0) * s
    err = ((centers[None, :] - q) ** 2 * hist[None, :].astype(np.float64)).sum(axis=1)
    return int(cand_bins[np.argmin(err)])


def calibrate(
    folded: Dict[str, Dict[str, np.ndarray]],
    batches: Sequence[Any],
    arch: str = "fastest",
    method: str = "amax",
    percentile: float = 99.99,
    bins: int = 2048,
    device=None,
) -> Dict[str, float]:
    """Run sample batches ((N, H, W, 1) float net inputs) through the fp
    folded graph on ``device`` (the card unless the caller asks for the
    CPU) and return the per-layer activation scales, keyed as the JAX
    package keys them and in its order (sorted: its jitted recorder returns
    the amax dict with sorted keys).

    * ``method="amax"`` (default): scale = global ``amax / 127``.
    * ``method="mse"``: per-tensor threshold minimising the expected
      squared quantisation error over a ``bins``-bin histogram of |x|.
    * ``method="percentile"``: clip at the ``percentile``-th percentile.
    * ``method="entropy"``: TensorRT-style KL-divergence threshold search
      over the same histograms.

    Values beyond a clipped range saturate at +-127 in every executor.
    """
    if method not in ("amax", "mse", "percentile", "entropy"):
        raise ValueError(f"unknown calibration method {method!r}")
    walk = _WALKS[arch]
    dev = resolve_device(device)
    params = torch_params_from_folded(folded, dev, chains=False)

    acc: Dict[str, float] = {}
    with torch.inference_mode(), exact_fp32():
        for b in batches:
            ex = _RecordingExecutor(params)
            walk(torch.as_tensor(b, dtype=torch.float32, device=dev), ex)
            keys = sorted(ex.amax)
            vals = torch.stack([ex.amax[k] for k in keys]).cpu().tolist()  # one host read
            for k, v in zip(keys, vals):
                acc[k] = max(acc.get(k, 0.0), v)
    if method == "amax":
        return {k: (v / 127.0 if v > 0 else 1.0) for k, v in acc.items()}

    # second pass: |x| histograms over [0, amax] per recorded tensor
    inv = {k: torch.tensor(np.float32(1) / np.maximum(np.float32(v), np.float32(1e-30)),
                           device=dev) for k, v in acc.items()}
    totals: Dict[str, torch.Tensor] = {}
    with torch.inference_mode(), exact_fp32():
        for b in batches:
            ex = _HistRecordingExecutor(params, inv, bins)
            walk(torch.as_tensor(b, dtype=torch.float32, device=dev), ex)
            for k, h in ex.hist.items():
                totals[k] = totals[k] + h if k in totals else h
        keys = list(totals)
        hists = dict(zip(keys, torch.stack([totals[k] for k in keys]).cpu().numpy()))

    scales: Dict[str, float] = {}
    for k, amax in acc.items():
        if amax <= 0:
            scales[k] = 1.0
            continue
        if method == "percentile":
            t = _percentile_threshold(hists[k], percentile)
        elif method == "mse":
            t = _mse_threshold(hists[k], bins)
        else:
            t = _kl_threshold(hists[k])
        scales[k] = (t / bins) * amax / 127.0
    return scales


# --------------------------------------------------------- int8 parameters
class QuantParams:
    """:func:`quantize_weights`' layers on a device, for the int8 executors.

    Per layer: ``weight``, the int8 kernel as integer-valued float32 in the
    convolution's layout (OIHW in channels_last memory; the deconv's
    ``(Cin, Cout, 2, 2)``), ``bias`` float32 and ``w_scale`` (numpy), with
    the layer's contraction checked against :data:`MAX_CONTRACTION`.  The
    float32 constants of the epilogues (a scale's reciprocal, a layer's
    multiplier ``f32(s) * w_scale``) are made on the device once each, at
    their first use.
    """

    def __init__(self, qparams: Dict[str, Dict[str, np.ndarray]], device=None):
        self.device = resolve_device(device)
        self.layers: Dict[str, Dict[str, Any]] = {}
        for name, p in qparams.items():
            k = np.asarray(p["kernel_q"], np.float32)
            if name.startswith("deconv"):  # (2, 2, Cin, Cout): one tap per output
                weight, contraction = k.transpose(2, 3, 0, 1), k.shape[2]
            else:  # HWIO, I = 1 for a depthwise kernel
                weight, contraction = k.transpose(3, 2, 0, 1), int(np.prod(k.shape[:3]))
            if contraction > MAX_CONTRACTION:
                raise ValueError(
                    f"layer {name!r} sums {contraction} int8 products per output; the "
                    f"float32 accumulator is exact for at most {MAX_CONTRACTION} "
                    f"({Q_MAX}^2 x n <= 2^24)")
            t = torch.from_numpy(np.ascontiguousarray(weight)).to(self.device)
            if not name.startswith("deconv"):
                t = t.contiguous(memory_format=torch.channels_last)
            self.layers[name] = {
                "weight": t, "contraction": contraction,
                "w_scale": np.asarray(p["w_scale"], np.float32),
                "bias": torch.from_numpy(np.asarray(p["bias"], np.float32)).to(self.device)}
        self._consts: Dict[Any, torch.Tensor] = {}

    def __iter__(self):
        return iter(self.layers)

    def _const(self, key, make):
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.from_numpy(make()).to(self.device)
        return t

    def scale(self, s: float) -> torch.Tensor:
        """``f32(s)``, a 0-dim tensor (dequantisation)."""
        return self._const(("scale", s), lambda: np.asarray(np.float32(s)))

    def inverse(self, s: float) -> torch.Tensor:
        """``f32(1 / f32(s))``, a 0-dim tensor (quantisation)."""
        return self._const(("inverse", s), lambda: np.asarray(np.float32(1) / np.float32(s)))

    def multiplier(self, name: str, s: float) -> torch.Tensor:
        """``f32(s) * w_scale``: the accumulator's per-channel factor."""
        return self._const(("multiplier", name, s),
                           lambda: np.float32(s) * self.layers[name]["w_scale"])


def as_quant_params(qparams, device) -> QuantParams:
    """``qparams`` as :class:`QuantParams` on ``device`` (a numpy tree from
    :func:`quantize_weights` is moved there)."""
    return qparams if isinstance(qparams, QuantParams) else QuantParams(qparams, device)


def _requant(y: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """round(y / s) half to even, clipped to +-127: the int8 values, held in
    float32 (``inv`` is ``f32(1 / s)``)."""
    return torch.round(y.float() * inv).clamp_(-Q_MAX, Q_MAX)


def _int_products(p: Dict[str, Any], xq: torch.Tensor, stride: int, groups: int,
                  pad: int) -> torch.Tensor:
    """The layer's int32 accumulators, exact in float32 (NHWC)."""
    return _nhwc(F.conv2d(_nchw(xq), p["weight"], None, stride, pad, 1, groups))


def _deconv_products(p: Dict[str, Any], xq: torch.Tensor) -> torch.Tensor:
    """The kernel-2 stride-2 deconv's accumulators: each output takes one
    tap, a sum over Cin (JAX's dot over the reshaped kernel)."""
    return _nhwc(F.conv_transpose2d(_nchw(xq), p["weight"], None, 2))


def _epilogue(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``acc * mult + bias`` rounded once to float32 (XLA's fused
    multiply-add): the float64 product of two float32 values is exact."""
    return (acc.double() * mult.double() + bias.double()).float()


class Int8Executor(Executor):
    """int8 x int8 -> int32 conv executor over the shared topology: each
    layer quantises its float input at its calibrated scale."""

    def __init__(self, qparams: QuantParams, act_scales: Dict[str, float]):
        self.p = qparams
        self.s = act_scales

    def _quant_in(self, x, name):
        sx = self.s[name]
        return _requant(x, self.p.inverse(sx)), sx

    def _out(self, acc, name, sx):
        return _epilogue(acc, self.p.multiplier(name, sx), self.p.layers[name]["bias"])

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        xq, sx = self._quant_in(x, name)
        groups = x.shape[-1] if depthwise else 1
        y = self._out(_int_products(self.p.layers[name], xq, stride, groups, (kernel - 1) // 2),
                      name, sx)
        return torch.relu(y) if act else y

    def deconv2x(self, x, name):
        xq, sx = self._quant_in(x, name)
        return torch.relu(self._out(_deconv_products(self.p.layers[name], xq), name, sx))

    def head(self, x, name):
        xq, sx = self._quant_in(x, name)
        return self._out(_int_products(self.p.layers[name], xq, 1, 1, 0), name, sx)


def quantized_apply(qparams, act_scales: Dict[str, float], x, arch: str = "fastest"):
    """Run the int8 deployment graph: (B,H,W,1) float -> (head_large,
    head_small), or head_small alone for ``arch='lite'``.  ``qparams`` is
    :class:`QuantParams` or :func:`quantize_weights`' tree (put on
    ``x``'s device)."""
    with exact_fp32():
        return _WALKS[arch](x, Int8Executor(as_quant_params(qparams, x.device), act_scales))


# ----------------------------------------------------- fused int8 activations
class _Q:
    """Carrier: int8 values (held in float32) plus their dequantisation
    scale."""

    __slots__ = ("q", "s")

    def __init__(self, q, s):
        self.q = q
        self.s = s


class Int8FusedExecutor(Executor):
    """End-to-end int8 activations: every inter-layer tensor is int8 values,
    requantised at the op's calibrated ``out/<name>`` scale; the heads stay
    float for the decode."""

    def __init__(self, qparams: QuantParams, act_scales: Dict[str, float]):
        self.p = qparams
        self.s = act_scales
        self._counters = {"add": 0, "concat": 0}

    def deq(self, x: _Q) -> torch.Tensor:
        return x.q * self.p.scale(x.s)

    def requant(self, y, s_out) -> _Q:
        return _Q(_requant(y, self.p.inverse(s_out)), s_out)

    def quantize_input(self, x_f32) -> _Q:
        return self.requant(x_f32, self.s["conv0"])

    def _conv_acc(self, x: _Q, name, stride, depthwise, kernel):
        p = self.p.layers[name]
        groups = x.q.shape[-1] if depthwise else 1
        acc = _int_products(p, x.q, stride, groups, (kernel - 1) // 2)
        return _epilogue(acc, self.p.multiplier(name, x.s), p["bias"])

    def conv(self, x: _Q, name, kernel, stride=1, depthwise=False, act=True):
        y = self._conv_acc(x, name, stride, depthwise, kernel)
        if act:
            y = torch.relu(y)
        return self.requant(y, self.s[f"out/{name}"])

    def deconv2x(self, x: _Q, name):
        p = self.p.layers[name]
        y = _epilogue(_deconv_products(p, x.q), self.p.multiplier(name, x.s), p["bias"])
        return self.requant(torch.relu(y), self.s[f"out/{name}"])

    def head(self, x: _Q, name):
        return self._conv_acc(x, name, 1, False, 1)  # heads stay float for the decode

    def _pseudo(self, kind):
        n = self._counters[kind]
        self._counters[kind] += 1
        return f"out/{kind}_{n}"

    def add(self, x: _Q, y: _Q):
        s_out = self.s[self._pseudo("add")]
        return self.requant(self.deq(x) + self.deq(y), s_out)

    def concat(self, x: _Q, y: _Q):
        s_out = self.s[self._pseudo("concat")]
        # requantise both halves to the shared output scale, concat the int8 values
        zx = self.requant(self.deq(x), s_out).q
        zy = self.requant(self.deq(y), s_out).q
        return _Q(torch.cat([zx, zy], dim=-1), s_out)


def quantized_apply_fused(qparams, act_scales: Dict[str, float], x, arch: str = "fastest"):
    """End-to-end int8 inference: (B,H,W,1) float input -> float head
    logits, every intermediate activation int8 values.  Requires
    ``act_scales`` from :func:`calibrate` (which records the ``out/...``
    scales)."""
    ex = Int8FusedExecutor(as_quant_params(qparams, x.device), act_scales)
    with exact_fp32():
        return _WALKS[arch](ex.quantize_input(x), ex)
