from yolofastest_torch.kernels.res_block import (
    LAUNCHES,
    chain_weights_from_folded,
    fused_res_block,
    fused_res_chain,
    fused_res_chain_cf,
    fused_res_chain_nhwc,
    fused_res_chain_rows,
    res_chain_cf_plain,
    res_chain_rows_plain,
    reset_launch_counts,
)

__all__ = [
    "LAUNCHES",
    "chain_weights_from_folded",
    "fused_res_block",
    "fused_res_chain",
    "fused_res_chain_cf",
    "fused_res_chain_nhwc",
    "fused_res_chain_rows",
    "res_chain_cf_plain",
    "res_chain_rows_plain",
    "reset_launch_counts",
]
