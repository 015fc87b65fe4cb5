from yolofastest_torch.models.convert import (module_state_from_variables,
                                              torch_params_from_folded, variables_from_module)
from yolofastest_torch.models.graph import (
    RES_CHAINS,
    Executor,
    FoldedExecutor,
    SpatialExecutor,
    fold_batchnorm,
    folded_apply,
    folded_apply_lite,
    spatial_apply,
    unfold_to_variables,
    walk_topology,
    walk_topology_lite,
)
from yolofastest_torch.models.torch_io import load_torch_checkpoint
from yolofastest_torch.models.yolo_fastest import (BasicResBlock, ConvNormAct, Deconv2x,
                                                   YoloFastest, YoloFastestLite, build_model,
                                                   count_params)
from yolofastest_torch.models.zoo import load_variables, save_variables, zoo_path

__all__ = [
    "BasicResBlock",
    "ConvNormAct",
    "Deconv2x",
    "RES_CHAINS",
    "YoloFastest",
    "YoloFastestLite",
    "build_model",
    "count_params",
    "module_state_from_variables",
    "variables_from_module",
    "Executor",
    "FoldedExecutor",
    "SpatialExecutor",
    "fold_batchnorm",
    "folded_apply",
    "folded_apply_lite",
    "load_torch_checkpoint",
    "load_variables",
    "save_variables",
    "spatial_apply",
    "torch_params_from_folded",
    "unfold_to_variables",
    "walk_topology",
    "walk_topology_lite",
    "zoo_path",
]
