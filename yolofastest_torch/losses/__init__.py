from yolofastest_torch.losses.yolo_loss import build_targets, decode_for_eval, total_loss, yolo_loss

__all__ = ["build_targets", "decode_for_eval", "total_loss", "yolo_loss"]
