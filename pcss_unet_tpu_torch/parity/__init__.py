"""Output-consistency harness (port of ``pcss_unet_tpu/parity``)."""

from pcss_unet_tpu_torch.parity.consistency import (
    compare_outputs, validate_train_infer_consistency,
)

__all__ = ["compare_outputs", "validate_train_infer_consistency"]
