from yolofastest_torch.inference.detector import Detector, detections_to_lists

__all__ = ["Detector", "detections_to_lists"]
