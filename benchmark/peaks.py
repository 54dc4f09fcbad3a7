"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity, at the full 700 W power limit).  A roofline share or an
``mfu`` is stated against these, with the card's power limit beside it."""

BF16_FLOPS = 989e12       # bf16 / fp16 tensor cores
INT8_OPS = 1979e12        # int8 tensor cores
HBM_BYTES = 3.35e12       # device memory, bytes per second
