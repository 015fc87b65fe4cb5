"""int8 quantisation: the weight quantiser (``quantize_weights``).  The
rest of the JAX package's ``quant/`` is ROADMAP item 'Quantisation'."""

from yolofastest_torch.quant.ptq import quantize_weights

__all__ = ["quantize_weights"]
