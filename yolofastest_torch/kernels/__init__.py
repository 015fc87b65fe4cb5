from yolofastest_torch.kernels._build import LAUNCHES, reset_launch_counts
from yolofastest_torch.kernels.nms import nms_keep, nms_keep_plain, nms_packed, nms_packed_plain
from yolofastest_torch.kernels.res_block import (
    chain_weights_from_folded,
    fused_res_block,
    fused_res_chain,
    fused_res_chain_cf,
    fused_res_chain_nhwc,
    fused_res_chain_rows,
    res_chain_cf_plain,
    res_chain_rows_plain,
)

__all__ = [
    "LAUNCHES",
    "chain_weights_from_folded",
    "fused_res_block",
    "fused_res_chain",
    "fused_res_chain_cf",
    "fused_res_chain_nhwc",
    "fused_res_chain_rows",
    "nms_keep",
    "nms_keep_plain",
    "nms_packed",
    "nms_packed_plain",
    "res_chain_cf_plain",
    "res_chain_rows_plain",
    "reset_launch_counts",
]
