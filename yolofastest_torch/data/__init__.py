from yolofastest_torch.data.coco import COCOIndex, parse_coco_json, voc_to_coco, write_coco_json
from yolofastest_torch.data.pipeline import DetectionLoader, load_example, multiscale_buckets
from yolofastest_torch.data.synthetic import ListLoader, write_synthetic_voc
from yolofastest_torch.data.voc import VOCIndex, parse_voc_xml, write_voc_xml

__all__ = [
    "ListLoader",
    "write_synthetic_voc",
    "VOCIndex",
    "parse_voc_xml",
    "write_voc_xml",
    "COCOIndex",
    "parse_coco_json",
    "voc_to_coco",
    "write_coco_json",
    "DetectionLoader",
    "load_example",
    "multiscale_buckets",
]
