from yolofastest_torch.train.distill import distill_loss, make_teacher_fn
from yolofastest_torch.train.schedule import make_lr_schedule
from yolofastest_torch.train.trainer import (TrainState, Trainer, checkpoint_variables,
                                             clip_by_global_norm, freeze_masks, make_train_step)

__all__ = ["make_lr_schedule", "TrainState", "Trainer", "make_train_step", "make_teacher_fn",
           "distill_loss", "checkpoint_variables", "clip_by_global_norm", "freeze_masks"]
