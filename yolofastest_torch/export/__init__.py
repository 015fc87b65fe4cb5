"""Export and import of the folded deployment graph: native ``.yfb``,
ONNX (head logits and the full detect pipeline), ncnn, Caffe and
TorchScript, and the readers for ONNX and ncnn; the serialised programs
(``.pt2``: the folded forward, the detect pipeline and the int8 forward,
whose kernels are registered operators) and the generic ONNX exporter of any
traceable function.

The port of ``yolofastest_tpu/export``, with the int8 QDQ ONNX and the
ncnn int8 calibration table.  Its ``stablehlo.py`` is ``pt2.py`` here, with
``save_exported_mlir`` (the StableHLO text that ``cpp/runner/shlo_runner.cpp``
runs) in ``mlir.py``, and its ``export_jax_onnx`` is :func:`export_torch_onnx`.
"""

from yolofastest_torch.export.caffe import export_caffe
from yolofastest_torch.export.generic_onnx import export_torch_onnx
from yolofastest_torch.export.mlir import save_exported_mlir
from yolofastest_torch.export.native import (load_native_weights, read_native_meta,
                                             save_native_weights)
from yolofastest_torch.export.ncnn import export_ncnn, export_ncnn_table, import_ncnn
from yolofastest_torch.export.onnx import (export_onnx, export_onnx_detect, export_onnx_qdq,
                                           import_onnx)
from yolofastest_torch.export.pt2 import (Program, export_detect_pipeline, export_folded_forward,
                                          export_int8_forward, load_exported, save_exported)
from yolofastest_torch.export.torchscript import build_torch_module, export_torchscript

__all__ = [
    "Program",
    "build_torch_module",
    "export_caffe",
    "export_detect_pipeline",
    "export_folded_forward",
    "export_int8_forward",
    "export_ncnn",
    "export_ncnn_table",
    "export_onnx",
    "export_onnx_detect",
    "export_onnx_qdq",
    "export_torch_onnx",
    "export_torchscript",
    "import_ncnn",
    "import_onnx",
    "load_exported",
    "load_native_weights",
    "read_native_meta",
    "save_exported",
    "save_exported_mlir",
    "save_native_weights",
]
