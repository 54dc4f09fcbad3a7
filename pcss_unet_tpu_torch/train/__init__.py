"""Training (port of ``pcss_unet_tpu/train``): schedules, the train state
and optimizers, the train and eval steps, checkpoints, metric writers and
the ``fit`` loop.  One device; data and spatial parallelism and the memory
governor are not ported yet."""

from pcss_unet_tpu_torch.train.loop import FitResult, fit
from pcss_unet_tpu_torch.train.state import (TrainState, create_train_state,
                                             make_optimizer)
from pcss_unet_tpu_torch.train.step import build_eval_step, build_train_step

__all__ = ["FitResult", "fit", "TrainState", "create_train_state",
           "make_optimizer", "build_train_step", "build_eval_step"]
