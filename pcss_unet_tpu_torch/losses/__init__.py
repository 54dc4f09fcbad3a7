"""Training losses (port of ``pcss_unet_tpu/losses``)."""

from pcss_unet_tpu_torch.losses.composite import (LossBundle, enhanced_loss,
                                                  standard_loss)
from pcss_unet_tpu_torch.losses.extras import (high_freq_loss,
                                               penumbra_weighted_l1,
                                               sobel_gradient_loss)
from pcss_unet_tpu_torch.losses.perturbation import perturbation_loss
from pcss_unet_tpu_torch.losses.ssim import ssim, ssim_loss
from pcss_unet_tpu_torch.losses.temporal import measure_temporal_instability
from pcss_unet_tpu_torch.losses.vgg import PerceptualLoss

__all__ = [
    "LossBundle", "standard_loss", "enhanced_loss", "PerceptualLoss",
    "perturbation_loss", "high_freq_loss", "penumbra_weighted_l1",
    "sobel_gradient_loss", "measure_temporal_instability", "ssim", "ssim_loss",
]
