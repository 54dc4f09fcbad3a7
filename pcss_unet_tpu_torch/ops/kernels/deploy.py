"""The deployment dispatch of both inference forwards: which kernel takes a
folded ConvBlock (:func:`route`, the reference's gates and the kernels'
shape picks, copied from it), fed by which operands, built from the block's
HWIO weights on every call.  The int8 whole-block kernels (K3, K5) and the
128-channel kernel (K6) are called here; K2 and K2′ by their forwards
(``infer.chw_engine``, ``models.unet``).
"""

from __future__ import annotations

import functools

import torch

from pcss_unet_tpu_torch.ops.int8 import quantize_kernel_int8
from pcss_unet_tpu_torch.ops.kernels.block_int8 import (fused_block_int8_kchunked,
                                                        fused_block_int8_nhwc,
                                                        pick_k_rows_int8,
                                                        pick_kchunked)
from pcss_unet_tpu_torch.ops.kernels.convblock128 import (fused_block128_nhwc,
                                                          pick_k_rows_128)
from pcss_unet_tpu_torch.utils.profiling import span


def int8_stage(cin: int, cout: int) -> bool:
    """The reference's int8 gate: the MXU-bound ≥256-in blocks, narrow-out
    (cin·cout < 2¹⁸) or ≥1024-in."""
    return cin >= 256 and (cin * cout < 2 ** 18 or cin >= 1024)


def nhwc_interlude(cin: int, cout: int, *, int8: bool, wide: str) -> bool:
    """Whether a wide stage of the channels-major engine goes through the
    NHWC layout (the reference's ``wide`` and int8 posture)."""
    return wide == "nhwc" or (wide == "auto" and int8 and int8_stage(cin, cout))


@functools.lru_cache(maxsize=4096)
def route(cin: int, cout: int, h: int, w: int, *, layout: str = "nhwc",
          int8: bool = False, fused: bool = True, use128_chw: bool = True,
          wide: str = "auto") -> str | None:
    """The wrapper that takes a folded ``cin`` → ``cout`` block on an ``h``
    × ``w`` activation, or None (plain convolutions, or the engine's
    einsum), with the reference's precedence
    (``pcss_unet_tpu/models/unet.py:137-182``; for ``layout="chw"``,
    ``pcss_unet_tpu/infer/chw_engine.py:376-382, 446-448``).  ``int8`` /
    ``fused``: the NHWC model's ``int8_inference`` / ``fused_inference``;
    ``use128_chw`` and ``wide``: the channels-major engine's options."""
    if layout == "chw":
        if cout <= 128 and (cin <= 64 or use128_chw and cin == 128):
            return "fused_conv_block_chw"
        if not nhwc_interlude(cin, cout, int8=int8, wide=wide):
            return None
    if int8 and int8_stage(cin, cout):
        if pick_k_rows_int8(h, w, cin, cout):
            return "fused_block_int8_nhwc"
        if pick_kchunked(h, w, cin, cout):
            return "fused_block_int8_kchunked"
    if fused and cin == 128 and cout <= 128 and pick_k_rows_128(h, w, cin, cout):
        return "fused_block128_nhwc"
    if layout == "nhwc" and fused and cin <= 64 and cout <= 128:
        return "fused_conv_block_nhwc"
    return None


def chw_operands(ka: torch.Tensor, b1: torch.Tensor, kb: torch.Tensor,
                 b2: torch.Tensor, dtype: torch.dtype):
    """K2 and K2′: HWIO ``ka [3,3,Cin,Cmid]``, ``kb [1,1,Cmid,Cout]`` →
    ``(w1 [9,Cmid,Cin], b1 [Cmid,1], w2 [Cout,Cmid], b2 [Cout,1])``, the
    weights in ``dtype``, the biases float32."""
    with span("ops.weight_prep"):
        ka = ka.to(dtype)
        return (ka.permute(0, 1, 3, 2).reshape(9, ka.shape[3], ka.shape[2]),
                b1.float()[:, None], kb[0, 0].T.to(dtype), b2.float()[:, None])


def block128_operands(ka: torch.Tensor, b1: torch.Tensor, kb: torch.Tensor,
                      b2: torch.Tensor, dtype: torch.dtype):
    """K6: HWIO → ``(w1 [9,C,C], b1 [C], w2 [C,Cout], b2 [Cout])``, the
    weights in ``dtype``, the biases float32."""
    with span("ops.weight_prep"):
        return (ka.to(dtype).reshape(9, *ka.shape[2:]), b1.float(),
                kb[0, 0].to(dtype), b2.float())


def int8_operands(ka: torch.Tensor, b1: torch.Tensor, kb: torch.Tensor,
                  b2: torch.Tensor):
    """K3 and K5: HWIO → ``(w1q [9,Cin,Cmid], s1, b1, w2q [Cmid,Cout], s2,
    b2)``, int8 weights with one scale per output channel, biases float32."""
    with span("ops.weight_prep"):
        w1q, s1 = quantize_kernel_int8(ka)
        w2q, s2 = quantize_kernel_int8(kb)
        return (w1q.reshape(9, *w1q.shape[2:]), s1, b1.float(), w2q[0, 0], s2,
                b2.float())


def block_nhwc(name: str, x: torch.Tensor, ka: torch.Tensor, b1: torch.Tensor,
               kb: torch.Tensor, b2: torch.Tensor, *,
               dtype: torch.dtype) -> torch.Tensor:
    """The folded ConvBlock on ``x [N,H,W,Cin]`` through the NHWC kernel
    ``name`` (``fused_block_int8_nhwc``, ``fused_block_int8_kchunked`` or
    ``fused_block128_nhwc``, as :func:`route` names it) → ``[N,H,W,Cout]``
    in ``dtype``."""
    dims = (*x.shape[1:], kb.shape[-1])                  # h, w, cin, cout
    x = x.to(dtype)
    if name == "fused_block128_nhwc":
        return fused_block128_nhwc(x, *block128_operands(ka, b1, kb, b2, dtype),
                                   negative_slope=0.2)
    args = (x, *int8_operands(ka, b1, kb, b2))
    if name == "fused_block_int8_nhwc":
        return fused_block_int8_nhwc(*args, k_rows=pick_k_rows_int8(*dims),
                                     negative_slope=0.2)
    k, c_chunk = pick_kchunked(*dims)
    return fused_block_int8_kchunked(*args, k_rows=k, c_chunk=c_chunk,
                                     negative_slope=0.2)
