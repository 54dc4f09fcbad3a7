"""Output-consistency harness and the reference's torch ground truth (port
of ``pcss_unet_tpu/parity``)."""

from pcss_unet_tpu_torch.parity.consistency import (
    compare_outputs, validate_train_infer_consistency,
)
from pcss_unet_tpu_torch.parity.unet_torch import make_torch_reference
from pcss_unet_tpu_torch.parity.vgg_torch import (
    build_vgg19_features_torch, convert_features_module,
    load_features_npz_into_torch, reference_vgg_loss_torch,
    torch_tap_activations,
)

__all__ = ["build_vgg19_features_torch", "compare_outputs",
           "convert_features_module", "load_features_npz_into_torch",
           "make_torch_reference", "reference_vgg_loss_torch",
           "torch_tap_activations", "validate_train_infer_consistency"]
