from yolofastest_torch.models.convert import torch_params_from_folded
from yolofastest_torch.models.graph import (
    RES_CHAINS,
    Executor,
    FoldedExecutor,
    fold_batchnorm,
    folded_apply,
    walk_topology,
)
from yolofastest_torch.models.zoo import load_variables, save_variables, zoo_path

__all__ = [
    "RES_CHAINS",
    "Executor",
    "FoldedExecutor",
    "fold_batchnorm",
    "folded_apply",
    "load_variables",
    "save_variables",
    "torch_params_from_folded",
    "walk_topology",
    "zoo_path",
]
