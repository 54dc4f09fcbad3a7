"""Twice the step's multiply-adds (``flops``: the U-Net's forward and
backward, its 3 perturbed forwards and the VGG tower on mask and target;
recomputation not counted) over the run's ``train_step_ms``, as a share
of the bf16 peak."""


def read(rec):
    return rec.get("mfu")
