from yolofastest_torch.ops.boxes import (
    box_iou_matrix,
    iou_pairwise,
    xywh2xyxy,
    xyxy2xywh,
)
from yolofastest_torch.ops.decode import decode_heads
from yolofastest_torch.ops.nms import batched_nms, nms_keep_mask, unpack_detections
from yolofastest_torch.ops.preprocess import (
    bgr_to_gray,
    downsample2x,
    normalize,
    preprocess_device,
    resize_bilinear,
)

__all__ = [
    "batched_nms",
    "bgr_to_gray",
    "box_iou_matrix",
    "decode_heads",
    "downsample2x",
    "iou_pairwise",
    "nms_keep_mask",
    "normalize",
    "preprocess_device",
    "resize_bilinear",
    "unpack_detections",
    "xywh2xyxy",
    "xyxy2xywh",
]
