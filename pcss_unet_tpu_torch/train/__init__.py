"""Training (port of ``pcss_unet_tpu/train``): schedules, the train state
and optimizers, the train and eval steps, checkpoints, metric writers and
the ``fit`` loop, and the measured memory governor (``governor.py``).  Data
parallelism is the step's process group (``build_train_step(group=…)``,
``fit(group=…)``); spatial parallelism in training is ROADMAP Queue 1 item
14b."""

from pcss_unet_tpu_torch.train.loop import FitResult, fit
from pcss_unet_tpu_torch.train.state import (TrainState, create_train_state,
                                             make_optimizer)
from pcss_unet_tpu_torch.train.step import build_eval_step, build_train_step

__all__ = ["FitResult", "fit", "TrainState", "create_train_state",
           "make_optimizer", "build_train_step", "build_eval_step"]
