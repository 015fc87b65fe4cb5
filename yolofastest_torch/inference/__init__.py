from yolofastest_torch.inference.detector import Detector, detections_to_lists
from yolofastest_torch.inference.server import DetectionServer, DynamicBatcher, make_batch_fn
from yolofastest_torch.inference.sliced import sliced_detect, tile_grid
from yolofastest_torch.inference.streaming import StreamingDetector
from yolofastest_torch.inference.track import IoUTracker, TrackedBox
from yolofastest_torch.inference.video import detect_video, iter_frame_batches

__all__ = [
    "DetectionServer",
    "Detector",
    "DynamicBatcher",
    "IoUTracker",
    "StreamingDetector",
    "TrackedBox",
    "detect_video",
    "detections_to_lists",
    "iter_frame_batches",
    "make_batch_fn",
    "sliced_detect",
    "tile_grid",
]
