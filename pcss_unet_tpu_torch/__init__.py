"""PyTorch + CUDA port of ``pcss_unet_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here mirrors
the module of the same name there and is held against it by the tests in
``tests/test_torch_*.py``.  Nothing here imports JAX or ``pcss_unet_tpu``.

What it holds so far:

- the deployment inference forward in both of the reference's postures,
  channels-major (``layout="chw"``, ``infer.chw_engine``) and NHWC
  (``models.unet.UNet``), through ``infer.frame.InferenceEngine`` with
  ``fold_bn`` and ``quantize="int8"``, for the w16 and w64 nets;
- eight hand-written CUDA kernels for Hopper (``csrc/``, wrapped in
  ``ops.kernels``), one for each function of the reference that reaches a
  Pallas kernel: K1 scrub+standardize, K2 and K2′ the fused ConvBlock,
  K3/K5 the int8 whole blocks, K4 the uint8 mask, K6 the 128-channel block,
  K7 the int8 3×3;
- the user's entry point: ``python -m pcss_unet_tpu_torch
  train|infer|serve|validate`` (``cli``), with the EXR/PNG IO stack
  (``io``: the pure-Python codec and the native one built from
  ``native/exr``), halo-tiled inference (``infer.tiled``, ``ops.blend``),
  the train-vs-infer consistency check (``parity``), the config
  (``config``) and the train-set statistics (``data.stats``);
- training on one card: the losses (``losses``, with the VGG tower of
  ``models.vgg``), the UNet's train mode, the train step, loop, checkpoints
  and metric writers (``train``), and the packed-dataset loader
  (``data.pipeline``).

Entry points run on the card unless the caller passes ``device="cpu"``
(``--device cpu`` on the command line); on the CPU each kernel wrapper runs
its plain PyTorch version instead.
"""
