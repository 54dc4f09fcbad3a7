"""The port's hand-written CUDA kernels, one module per reference Pallas
module, each with its plain PyTorch version beside it.

Every wrapper takes the plain version for a CPU tensor and launches its
kernel (or raises) for a CUDA tensor, and counts kernel launches in a
``launches`` attribute.  Sources live in ``pcss_unet_tpu_torch/csrc/`` and
are built by ``_build`` at first use.  ``deploy`` is both inference
forwards' dispatch: which kernel takes a folded block, and its operands.
``resize`` holds the banded resize behind ``ops/resize.py::apply_matrix``,
a kernel with no TPU counterpart: it is not in ``KERNELS`` (the ported
ones), and ``reset_launch_counts`` zeroes its ``launches`` too.  So does
``bn_train``: the train-mode BatchNorm → activation → Dropout2d tail of a
ConvBlock, forward and backward, which no TPU kernel computes either.
It also zeroes ``fused_conv_block_nhwc.copies``, K2′'s copies of its input,
and ``fused_block128_nhwc.wgmma_launches``, K6's calls on its wgmma kernel.
"""

from pcss_unet_tpu_torch.ops.kernels.block_int8 import (fused_block_int8_kchunked,
                                                        fused_block_int8_nhwc)
from pcss_unet_tpu_torch.ops.kernels.bn_train import bn_act_dropout_train
from pcss_unet_tpu_torch.ops.kernels.conv3x3_int8 import conv3x3_int8_nhwc
from pcss_unet_tpu_torch.ops.kernels.convblock import (fused_conv_block_chw,
                                                       fused_conv_block_nhwc)
from pcss_unet_tpu_torch.ops.kernels.convblock128 import fused_block128_nhwc
from pcss_unet_tpu_torch.ops.kernels.fused import (fused_mask_to_u8,
                                                   fused_scrub_standardize)
from pcss_unet_tpu_torch.ops.kernels.resize import banded_resize

KERNELS = (fused_scrub_standardize, fused_conv_block_chw,
           fused_block_int8_nhwc, fused_mask_to_u8, fused_block_int8_kchunked,
           fused_block128_nhwc, conv3x3_int8_nhwc, fused_conv_block_nhwc)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    fused_conv_block_nhwc.copies = 0
    fused_block128_nhwc.wgmma_launches = 0
    banded_resize.launches = 0
    bn_act_dropout_train.launches = 0
