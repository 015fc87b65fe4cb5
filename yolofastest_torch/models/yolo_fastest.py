"""YOLO-Fastest as trainable ``nn.Module``s: the training model.

The port of ``yolofastest_tpu/models/yolo_fastest.py``.  The module names are
the JAX package's (``conv0``, ``res3_4``, ``head_5``, ``deconv5_1``, ...), so
a ``state_dict`` key is the flax path with dots (``res3_4.conv2.bn.weight``)
and :mod:`yolofastest_torch.models.convert` maps one onto the other.  Inputs
and heads are NHWC, as in the JAX package; the convolutions see them as NCHW
tensors in channels_last memory, which is the same memory.

BatchNorm follows flax, not ``nn.BatchNorm2d``:

* the running statistics move by ``new = 0.9 * old + 0.1 * batch`` (flax
  ``momentum=0.9`` is torch ``momentum=0.1``);
* the running variance takes the **biased** batch variance, where
  ``F.batch_norm`` would fold in the unbiased one, so :class:`BatchNorm`
  moves the statistics itself and normalises with ``F.batch_norm`` on the
  batch alone (``tests/test_torch_train.py`` holds the statistics against
  flax's);
* scale ~ N(1, 0.02), bias 0; no ``num_batches_tracked``.

Convolutions start Kaiming-normal with fan_in (``std = sqrt(2 / fan_in)``),
the heads' biases at 0.  ``compute_dtype=torch.bfloat16`` is
:func:`torch.autocast` over the forward, the weights staying fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention for flax's momentum=0.9


def _kaiming_(w: torch.Tensor, fan_in: int, gen: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW channels."""

    def __init__(self, features: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.zeros(features))
        with torch.no_grad():
            self.weight.normal_(1.0, 0.02, generator=gen)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, BN_EPS)
        with torch.no_grad():
            # the biased batch variance, reduced in fp32 (or wider) as flax reduces it
            xs = x.detach().to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(xs, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPS)


class ConvNormAct(nn.Module):
    """conv (no bias) -> BatchNorm -> optional ReLU; ``depthwise`` makes the
    conv grouped by channel (JAX ``ConvNormAct``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 depthwise: bool = False, act: bool = True,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        groups = cin if depthwise else 1
        self.conv = nn.Conv2d(cin, features, kernel, stride, (kernel - 1) // 2,
                              groups=groups, bias=False)
        _kaiming_(self.conv.weight, kernel * kernel * (cin // groups), gen)
        self.bn = BatchNorm(features, gen)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.act else x


class Deconv2x(nn.Module):
    """``ConvTranspose2d(k=2, s=2, p=0)`` (no bias) -> BatchNorm -> ReLU (JAX
    ``Deconv2x``, whose ``(2, 2, Cin, Cout)`` kernel is this ``weight``
    transposed to ``(Cin, Cout, 2, 2)``)."""

    def __init__(self, cin: int, features: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, features, 2, 2))
        _kaiming_(self.weight, 4 * cin, gen)  # flax's fan_in of a (2, 2, Cin, Cout) kernel
        self.bn = BatchNorm(features, gen)

    def forward(self, x):
        return torch.relu(self.bn(F.conv_transpose2d(x, self.weight, None, 2)))


class BasicResBlock(nn.Module):
    """1x1 expand -> 3x3 depthwise -> 1x1 project, plus the input."""

    def __init__(self, io: int, inner: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = ConvNormAct(io, inner, 1, gen=gen)
        self.conv2 = ConvNormAct(inner, inner, 3, depthwise=True, gen=gen)
        self.conv3 = ConvNormAct(inner, io, 1, act=False, gen=gen)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x))) + x


def _head(cin: int, num_out: int, gen: Optional[torch.Generator]) -> nn.Conv2d:
    head = nn.Conv2d(cin, num_out, 1)
    _kaiming_(head.weight, cin, gen)
    with torch.no_grad():
        head.bias.zero_()
    return head


# (name, kind, arguments) of the backbone both architectures share, up to
# conv5_6; "res" entries are (io, inner), the others (features, kernel,
# stride, depthwise, act).  JAX yolo_fastest.py:171-224.
_BACKBONE = (
    ("conv0", 8, 3, 2, False, True), ("conv1_2", 8, 1, 1, False, True),
    ("conv1_3", 8, 3, 1, True, True), ("conv1_4", 4, 1, 1, False, False),
    ("res1_1", 4, 8),
    ("conv1_8", 24, 1, 1, False, True), ("conv1_9", 24, 3, 2, False, True),
    ("conv2_1", 8, 1, 1, False, False),
    ("res2_1", 8, 32), ("res2_2", 8, 32),
    ("conv2_2", 32, 1, 1, False, True), ("conv2_3", 32, 3, 2, True, True),
    ("conv3_1", 8, 1, 1, False, False),
    ("res3_1", 8, 48), ("res3_2", 8, 48),
    ("conv3_2", 48, 1, 1, False, True), ("conv3_3", 48, 3, 1, True, True),
    ("conv3_4", 16, 1, 1, False, False),
    ("res3_3", 16, 96), ("res3_4", 16, 96), ("res3_5", 16, 96), ("res3_6", 16, 96),
    ("conv3_5", 96, 1, 1, False, True), ("conv3_6", 96, 3, 2, True, True),
    ("conv4_1", 24, 1, 1, False, False),
    ("res4_1", 24, 136), ("res4_2", 24, 136), ("res4_3", 24, 136), ("res4_4", 24, 136),
    ("conv4_2", 136, 1, 1, False, True), ("conv4_3", 136, 3, 2, True, True),
    ("conv5_1", 48, 1, 1, False, True),
    ("res5_1", 48, 224), ("res5_2", 48, 224), ("res5_3", 48, 224), ("res5_4", 48, 224),
    ("res5_5", 48, 224),
    ("conv5_2", 96, 1, 1, False, True), ("conv5_3", 96, 5, 1, True, True),
    ("conv5_4", 128, 1, 1, False, False), ("conv5_5", 128, 5, 1, True, True),
    ("conv5_6", 128, 1, 1, False, False),
)

# the large head's neck, after concat(conv4_2, deconv5_1): 136 + 96 channels
_NECK = (
    ("conv4_1_1", 96, 1, 1, False, True), ("conv4_1_2", 96, 5, 1, True, True),
    ("conv4_1_3", 96, 1, 1, False, False), ("conv4_1_4", 96, 5, 1, True, True),
    ("conv4_1_5", 96, 1, 1, False, False),
)


class _Net(nn.Module):
    """Shared construction: the backbone modules in walk order."""

    def __init__(self, num_cls: int, num_anchors: int, compute_dtype: torch.dtype,
                 inner_widths: Optional[Tuple[Tuple[str, int], ...]],
                 gen: Optional[torch.Generator]):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        self.num_cls = num_cls
        self.num_anchors = num_anchors
        self.compute_dtype = compute_dtype
        self.inner_widths = tuple(inner_widths or ())
        iw = dict(self.inner_widths)
        self._order = []
        cin = 1
        for spec in _BACKBONE:
            cin = self._add(spec, cin, iw, gen)
        self.head_5 = _head(128, self.num_out, gen)

    @property
    def num_out(self) -> int:
        return self.num_anchors * (5 + self.num_cls)

    def _add(self, spec, cin, iw, gen) -> int:
        name = spec[0]
        if len(spec) == 3:
            io, inner = spec[1], iw.get(name, spec[2])
            self.add_module(name, BasicResBlock(io, inner, gen))
            cout = io
        else:
            _, feat, k, s, dw, act = spec
            self.add_module(name, ConvNormAct(cin, feat, k, s, dw, act, gen))
            cout = feat
        self._order.append(name)
        return cout

    def _autocast(self, x):
        if self.compute_dtype == torch.float32:
            return torch.autocast(x.device.type, enabled=False)
        return torch.autocast(x.device.type, dtype=self.compute_dtype)

    def _backbone(self, x):
        """(B, H, W, 1) -> conv4_2's and conv5_2's outputs and conv5_6's,
        NCHW views of channels_last memory."""
        x = x.permute(0, 3, 1, 2)
        c42 = c52 = None
        for name in self._order:
            x = getattr(self, name)(x)
            if name == "conv4_2":
                c42 = x
            elif name == "conv5_2":
                c52 = x
        return c42, c52, x


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class YoloFastest(_Net):
    """Two-head YOLO-Fastest (JAX ``YoloFastest``): ``forward`` returns
    ``(head_large, head_small)``, NHWC raw logits with ``num_anchors * (5 +
    num_cls)`` channels at strides 16 and 32."""

    def __init__(self, num_cls: int = 3, num_anchors: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 inner_widths: Optional[Tuple[Tuple[str, int], ...]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_cls, num_anchors, compute_dtype, inner_widths, generator)
        self.deconv5_1 = Deconv2x(96, 96, generator)
        cin = 136 + 96
        for spec in _NECK:
            self.add_module(spec[0], ConvNormAct(cin, *spec[1:], gen=generator))
            cin = spec[1]
        self.head_4 = _head(96, self.num_out, generator)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        with self._autocast(x):
            c42, c52, x = self._backbone(x)
            head_small = self.head_5(x)
            x = torch.cat([c42, self.deconv5_1(c52)], dim=1)
            for spec in _NECK:
                x = getattr(self, spec[0])(x)
            head_large = self.head_4(x)
        return _nhwc(head_large), _nhwc(head_small)


class YoloFastestLite(_Net):
    """Single-head variant (JAX ``YoloFastestLite``): the backbone and the
    stride-32 head; ``forward`` returns head_small, NHWC."""

    def __init__(self, num_cls: int = 3, num_anchors: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 inner_widths: Optional[Tuple[Tuple[str, int], ...]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_cls, num_anchors, compute_dtype, inner_widths, generator)

    def forward(self, x) -> torch.Tensor:
        with self._autocast(x):
            x = self._backbone(x)[2]
            return _nhwc(self.head_5(x))


def build_model(num_cls: int, num_anchors: int, compute_dtype: torch.dtype = torch.float32,
                arch: str = "fastest", variables=None, seed: Optional[int] = None):
    """The module for ``arch``, with the res-block inner widths read off
    ``variables`` when given (a pruned checkpoint builds its smaller blocks)
    and its weights loaded from them; else a fresh init (from ``seed``, when
    given).  On the CPU; move it with ``.to(device)``."""
    if arch not in ("fastest", "lite"):
        raise ValueError(f"unknown arch {arch!r}")
    inner_widths = None
    if variables is not None:
        from yolofastest_torch.models.prune import infer_inner_widths

        inner_widths = infer_inner_widths(variables)
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    cls = YoloFastestLite if arch == "lite" else YoloFastest
    model = cls(num_cls, num_anchors, compute_dtype, inner_widths, gen)
    if variables is not None:
        from yolofastest_torch.models.convert import module_state_from_variables

        model.load_state_dict(module_state_from_variables(variables))
    return model


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
