"""Typed, frozen configuration for the whole framework.

The port's own copy of ``yolofastest_tpu.configs.config`` (same fields, same
presets, same JSON round trip), kept here so that the port imports nothing of
the JAX package.  ``tests/test_torch_config.py`` holds every preset field
equal to the JAX package's.

Anchors are per-resolution presets.  The reference keeps three anchor groups and
documents (``_config.py:9``) that 256x320 uses groups 0-1 and 512x640 uses groups
1-2; the presets below bake that in so nothing has to be edited in place.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

Anchors = Tuple[Tuple[Tuple[float, float], ...], ...]  # (scale, anchor, (w, h))

# The three anchor groups from the reference `_config.py:5-9` (w, h) in
# network-input pixels.  Group 0 is the finest.
_ANCHOR_GROUPS: Anchors = (
    ((10.0, 13.0), (16.0, 30.0), (33.0, 23.0)),
    ((150.0, 75.0), (100.0, 100.0), (75.0, 150.0)),
    ((300.0, 150.0), (200.0, 200.0), (150.0, 300.0)),
)


@dataclasses.dataclass(frozen=True)
class IOConfig:
    """Model/detection I/O parameters (reference `_config.py` ``io_params``)."""

    input_shape: Tuple[int, int, int] = (256, 320, 1)  # (H, W, C) of the net input
    origin_img_shape: Tuple[int, int, int] = (512, 640, 3)  # raw dataset images
    num_cls: int = 3
    num_anchors: int = 3  # anchors per scale
    anchors: Anchors = _ANCHOR_GROUPS[0:2]  # one group per output scale
    strides: Tuple[int, ...] = (16, 32)  # head_large, head_small
    conf_thre: float = 0.5
    nms_thre: float = 0.2
    class_names: Tuple[str, ...] = ("carrier", "defender", "destroyer")
    # Static upper bounds that keep the whole detect path jittable:
    max_decode: int = 128  # top-K candidates kept after the confidence gate
    max_det: int = 64  # detections kept after NMS

    @property
    def input_hw(self) -> Tuple[int, int]:
        return self.input_shape[0], self.input_shape[1]

    @property
    def input_channels(self) -> int:
        return self.input_shape[2]

    @property
    def bbox_attrs(self) -> int:
        return 5 + self.num_cls

    @property
    def num_out(self) -> int:
        """Channels per detection head = A * (5 + C) (reference yolo_fastest.py:76)."""
        return self.num_anchors * self.bbox_attrs

    @property
    def head_hw(self) -> Tuple[Tuple[int, int], ...]:
        """(H, W) of each head's feature map, finest first."""
        h, w = self.input_hw
        return tuple((h // s, w // s) for s in self.strides)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Data augmentation (reference `_config.py` ``augment_params``)."""

    train_dataset_dir: str = ""
    val_dataset_dir: str = ""
    fliplr: float = 0.5
    gaussian_filter: float = 0.3
    # Mosaic (4-image collage) probability — beyond-reference augmentation,
    # default OFF so the reference pipeline stays bit-identical.  When it
    # fires, blur/fliplr still apply to the composed canvas.
    mosaic: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation hyper-parameters (reference `_config.py` ``train_params``)."""

    total_epochs: int = 30
    batch_size: int = 16
    lr0: float = 1e-3
    momentum: float = 0.937  # Adam beta1 in the reference is 0.9; kept for parity docs
    weight_decay: float = 5e-4
    branch_weight: Tuple[float, ...] = (1.0, 1.0)
    iou_loss_thre: float = 0.5  # shape-IOU ignore threshold in target assignment
    iou_val_thre: float = 0.5  # pred/GT match threshold for mAP
    max_boxes: int = 64  # per-image GT padding
    warmup_min_iters: int = 1000  # warmup = max(3 * steps_per_epoch, this)
    # Optional global-norm gradient clip; 0 disables.  Disabled by default:
    # measured on the synthetic-overfit benchmark, clipping at norm 10
    # interacts badly with Adam's second-moment adaptation on this loss and
    # diverges where unclipped training is stable (docs/DESIGN.md).
    grad_clip_norm: float = 0.0
    checkpoint_dir: str = "checkpoints"
    # Failure detection: abort training (clean RuntimeError) once this many
    # CONSECUTIVE steps had non-finite grads.  Updates are skipped while the
    # streak lasts, so params are never poisoned (optax.apply_if_finite alone
    # "gives up and accepts" the bad update after its error budget — measured
    # destroying a fine-tune in round 2).
    abort_nonfinite_streak: int = 25
    # Keep only the newest N epoch checkpoints (0 = keep all).  The reference
    # keeps all 30 (train.py:160); rotation is the sane production default.
    max_to_keep: int = 5
    # Exponential moving average of the model (params + BN stats); 0 disables.
    # Beyond-reference: the reference validates/ships the raw last-step
    # weights (train.py:160).  The effective decay ramps in as
    # ``ema_decay * (1 - exp(-step/ema_ramp))`` so early steps don't anchor
    # the average to the random init.  When enabled, validation and the
    # checkpointed deployment weights use the EMA model.
    ema_decay: float = 0.0
    ema_ramp: int = 2000
    # Bucketed multi-scale training (darknet-style random input resolution,
    # done the XLA way): every ``multiscale_every`` batches the train loader
    # draws an (H, W) bucket from ``io.input_hw + k*32`` for k in
    # [-steps, +steps] (both dims shifted together, floor 64).  Targets are
    # resolution-independent (normalised coords) and the loss derives stride
    # from the actual batch shape, so each bucket is exactly ONE extra cached
    # jit compile of the train step — static shapes, no dynamic-shape
    # recompiles in steady state.  0 disables; validation stays at base res.
    multiscale_steps: int = 0
    multiscale_every: int = 10
    log_every: int = 10
    val_after_epoch: int = 4  # run mAP validation once epoch > this
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    io: IOConfig = dataclasses.field(default_factory=IOConfig)
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        raw = json.loads(s)

        def _tupled(x):
            if isinstance(x, list):
                return tuple(_tupled(v) for v in x)
            return x

        io = {k: _tupled(v) for k, v in raw["io"].items()}
        aug = raw["augment"]
        tr = {k: _tupled(v) for k, v in raw["train"].items()}
        return Config(io=IOConfig(**io), augment=AugmentConfig(**aug), train=TrainConfig(**tr))


def config_256x320(**overrides) -> Config:
    """The 320x256 deployment preset (anchor groups 0-1)."""
    io = IOConfig(
        input_shape=(256, 320, 1),
        anchors=_ANCHOR_GROUPS[0:2],
        **{k: v for k, v in overrides.items() if k in IOConfig.__dataclass_fields__},
    )
    return Config(io=io)


def config_512x640(**overrides) -> Config:
    """The 640x512 deployment preset (anchor groups 1-2)."""
    io = IOConfig(
        input_shape=(512, 640, 1),
        anchors=_ANCHOR_GROUPS[1:3],
        **{k: v for k, v in overrides.items() if k in IOConfig.__dataclass_fields__},
    )
    return Config(io=io)


def config_lite_256x320(**overrides) -> Config:
    """The single-head YoloFastest-lite preset: stride-32 deep head only
    (reference ``YoloFastest_lite``, ``yolo_fastest.py:234-372``), so one
    anchor group (the coarse one)."""
    io = IOConfig(
        input_shape=(256, 320, 1),
        anchors=_ANCHOR_GROUPS[1:2],
        strides=(32,),
        **{k: v for k, v in overrides.items() if k in IOConfig.__dataclass_fields__},
    )
    return Config(io=io)


def config_lite_512x640(**overrides) -> Config:
    """Single-head lite at the high resolution (anchor group 2, the one the
    two-head 512x640 preset pairs with its stride-32 head)."""
    io = IOConfig(
        input_shape=(512, 640, 1),
        anchors=_ANCHOR_GROUPS[2:3],
        strides=(32,),
        **{k: v for k, v in overrides.items() if k in IOConfig.__dataclass_fields__},
    )
    return Config(io=io)


_PRESETS = {
    "256x320": config_256x320,
    "512x640": config_512x640,
    "lite-256x320": config_lite_256x320,
    "lite-512x640": config_lite_512x640,
}


def get_config(name: str = "256x320", **overrides) -> Config:
    if name not in _PRESETS:
        raise KeyError(f"unknown config preset {name!r}; have {sorted(_PRESETS)}")
    return _PRESETS[name](**overrides)
