"""Command-line entry points (port of ``pcss_unet_tpu/cli``), mirroring the
reference's script UX:

    python -m pcss_unet_tpu_torch train      ≙ main.py
    python -m pcss_unet_tpu_torch infer      ≙ infer.py / inference.py
    python -m pcss_unet_tpu_torch serve      (streaming batch inference)
    python -m pcss_unet_tpu_torch validate   ≙ validate_consistency.py

(also ``python -m pcss_unet_tpu_torch.cli.train``, ``.cli.infer``,
``.cli.serve`` and ``.cli.validate``).
The other commands of ``python -m pcss_unet_tpu`` are not ported yet.
Nothing here builds or parses anything at import.
"""
