"""int8 quantisation: weights, calibration, the int8 and int8-fused
executors, mixed precision and its per-layer sensitivity sweep,
quantisation-aware fine-tuning and the shipped artifacts."""

from yolofastest_torch.quant.ptq import (Int8Executor, QuantParams, calibrate, quantize_weights,
                                         quantized_apply, quantized_apply_fused)
from yolofastest_torch.quant.qat import (FakeQuantExecutor, fake_quant_act, fake_quant_weight,
                                         qat_apply, qat_finetune)
from yolofastest_torch.quant.sensitivity import (layer_sensitivity, quantized_apply_flagged,
                                                 quantized_apply_fused_flagged,
                                                 quantized_apply_fused_mixed,
                                                 quantized_apply_mixed)
from yolofastest_torch.quant.zoo import (int8_zoo_path, load_int8_zoo, mixed_native_tree,
                                         save_int8_zoo)

__all__ = [
    "FakeQuantExecutor",
    "Int8Executor",
    "QuantParams",
    "calibrate",
    "fake_quant_act",
    "fake_quant_weight",
    "layer_sensitivity",
    "qat_apply",
    "qat_finetune",
    "quantize_weights",
    "quantized_apply",
    "quantized_apply_flagged",
    "quantized_apply_fused",
    "quantized_apply_fused_flagged",
    "quantized_apply_mixed",
    "quantized_apply_fused_mixed",
    "int8_zoo_path",
    "load_int8_zoo",
    "mixed_native_tree",
    "save_int8_zoo",
]
