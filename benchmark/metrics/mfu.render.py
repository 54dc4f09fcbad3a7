"""Twice the model's multiply-adds per frame (``flops.unet_macs`` on the
frame the engine runs) over the run's ``frame_ms``, as a share of the
bf16 peak."""


def read(rec):
    return rec.get("mfu")
