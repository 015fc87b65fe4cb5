from yolofastest_torch.data.anchors import (anchor_groups, collect_wh, kmeans_anchors,
                                            mean_best_iou)
from yolofastest_torch.data.coco import COCOIndex, parse_coco_json, voc_to_coco, write_coco_json
from yolofastest_torch.data.pipeline import DetectionLoader, load_example, multiscale_buckets
from yolofastest_torch.data.synthetic import ListLoader, write_synthetic_voc
from yolofastest_torch.data.lmdb_reader import (CaffeLMDBReader, decode_datum, encode_datum,
                                                write_caffe_lmdb)
from yolofastest_torch.data.voc import VOCIndex, parse_voc_xml, write_voc_xml

__all__ = [
    "CaffeLMDBReader",
    "decode_datum",
    "encode_datum",
    "write_caffe_lmdb",
    "anchor_groups",
    "collect_wh",
    "kmeans_anchors",
    "mean_best_iou",
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
