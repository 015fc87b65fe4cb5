"""Export and import of the folded deployment graph: native ``.yfb``,
ONNX (head logits and the full detect pipeline), ncnn, Caffe and
TorchScript, and the readers for ONNX and ncnn.

The port of ``yolofastest_tpu/export``, with the int8 QDQ ONNX and the
ncnn int8 calibration table.  Its ``stablehlo.py`` and ``generic_onnx.py``
lower JAX programs and have no counterpart here.
"""

from yolofastest_torch.export.caffe import export_caffe
from yolofastest_torch.export.native import (load_native_weights, read_native_meta,
                                             save_native_weights)
from yolofastest_torch.export.ncnn import export_ncnn, export_ncnn_table, import_ncnn
from yolofastest_torch.export.onnx import (export_onnx, export_onnx_detect, export_onnx_qdq,
                                           import_onnx)
from yolofastest_torch.export.torchscript import build_torch_module, export_torchscript

__all__ = [
    "build_torch_module",
    "export_caffe",
    "export_ncnn",
    "export_ncnn_table",
    "export_onnx",
    "export_onnx_detect",
    "export_onnx_qdq",
    "export_torchscript",
    "import_ncnn",
    "import_onnx",
    "load_native_weights",
    "read_native_meta",
    "save_native_weights",
]
