"""A folded ConvBlock on NHWC through the deployment kernels: the int8
whole-block kernels (K3, or K5 where K3's weights would not fit) and the
128-channel kernel (K6).

The one place where a block's HWIO weights become those kernels' operands,
shared by the NHWC model (``models.unet.ConvBlock``) and the channels-major
engine's NHWC interlude (``infer.chw_engine``).  Each caller keeps its own
gates and passes their verdicts in; this module adds only the kernels' own
shape picks, copied from the reference.
"""

from __future__ import annotations

import torch

from pcss_unet_tpu_torch.ops.int8 import quantize_kernel_int8
from pcss_unet_tpu_torch.ops.kernels.block_int8 import (fused_block_int8_kchunked,
                                                        fused_block_int8_nhwc,
                                                        pick_k_rows_int8,
                                                        pick_kchunked)
from pcss_unet_tpu_torch.ops.kernels.convblock128 import (fused_block128_nhwc,
                                                          pick_k_rows_128)
from pcss_unet_tpu_torch.utils.profiling import span


def int8_weights(ka: torch.Tensor, kb: torch.Tensor):
    """HWIO ``ka [3,3,Cin,Cmid]``, ``kb [1,1,Cmid,Cout]`` → the int8 blocks'
    weight operands ``(w1q [9,Cin,Cmid], s1, w2q [Cmid,Cout], s2)``, one
    scale per output channel."""
    with span("ops.weight_prep"):
        w1q, s1 = quantize_kernel_int8(ka)
        w2q, s2 = quantize_kernel_int8(kb)
        return w1q.reshape(9, *w1q.shape[2:]), s1, w2q[0, 0], s2


def block_kernel_nhwc(x: torch.Tensor, ka: torch.Tensor, b1: torch.Tensor,
                      kb: torch.Tensor, b2: torch.Tensor, *,
                      dtype: torch.dtype, int8: bool, block128: bool):
    """The folded ConvBlock on ``x [N,H,W,Cin]`` as ``(route, out)``, with
    ``out [N,H,W,Cout]`` in ``dtype`` and ``route`` the kernel's name; None
    where no kernel takes it.  ``int8`` / ``block128`` are the caller's gate
    verdicts; int8 goes first (K3 when ``pick_k_rows_int8`` fits, else K5
    when ``pick_kchunked`` does), then K6 when ``pick_k_rows_128`` fits."""
    _, h, w, cin = x.shape
    cout = kb.shape[-1]
    x = x.to(dtype)
    b1, b2 = b1.float(), b2.float()
    if int8:
        k = pick_k_rows_int8(h, w, cin, cout)
        kc = None if k else pick_kchunked(h, w, cin, cout)
        if k or kc:
            w1q, s1, w2q, s2 = int8_weights(ka, kb)
            args = (x, w1q, s1, b1, w2q, s2, b2)
            if k:
                return "fused_block_int8_nhwc", fused_block_int8_nhwc(
                    *args, k_rows=k, negative_slope=0.2)
            return "fused_block_int8_kchunked", fused_block_int8_kchunked(
                *args, k_rows=kc[0], c_chunk=kc[1], negative_slope=0.2)
    if block128 and pick_k_rows_128(h, w, cin, cout):
        with span("ops.weight_prep"):
            w1, w2 = ka.to(dtype).reshape(9, *ka.shape[2:]), kb[0, 0].to(dtype)
        return "fused_block128_nhwc", fused_block128_nhwc(
            x, w1, b1, w2, b2, negative_slope=0.2)
    return None
