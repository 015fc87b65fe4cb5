from yolofastest_torch.eval.map_eval import (COCO_IOU_GRID, MAPEvaluator, average_precision,
                                             make_backend_eval_fn, make_eval_fn)

__all__ = ["COCO_IOU_GRID", "MAPEvaluator", "average_precision", "make_backend_eval_fn",
           "make_eval_fn"]
