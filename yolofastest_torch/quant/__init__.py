"""int8 quantisation: weights, calibration, the int8 and int8-fused
executors, mixed precision and the shipped artifacts.  The sensitivity
sweep and QAT are ROADMAP items ('Quantisation, part 2')."""

from yolofastest_torch.quant.ptq import (Int8Executor, QuantParams, calibrate, quantize_weights,
                                         quantized_apply, quantized_apply_fused)
from yolofastest_torch.quant.sensitivity import (quantized_apply_fused_mixed,
                                                 quantized_apply_mixed)
from yolofastest_torch.quant.zoo import (int8_zoo_path, load_int8_zoo, mixed_native_tree,
                                         save_int8_zoo)

__all__ = [
    "Int8Executor",
    "QuantParams",
    "calibrate",
    "quantize_weights",
    "quantized_apply",
    "quantized_apply_fused",
    "quantized_apply_mixed",
    "quantized_apply_fused_mixed",
    "int8_zoo_path",
    "load_int8_zoo",
    "mixed_native_tree",
    "save_int8_zoo",
]
