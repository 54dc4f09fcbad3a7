"""Command-line entry points (port of ``pcss_unet_tpu/cli``), mirroring the
reference's script UX:

    python -m pcss_unet_tpu_torch organize   ≙ organize_data.py
    python -m pcss_unet_tpu_torch prepare    ≙ prepare_dataset.py
    python -m pcss_unet_tpu_torch stats      ≙ calculate_dataset_stats.py
    python -m pcss_unet_tpu_torch check      ≙ check.py, check_channel_stats.py,
                                               test.py
    python -m pcss_unet_tpu_torch train      ≙ main.py
    python -m pcss_unet_tpu_torch infer      ≙ infer.py / inference.py
    python -m pcss_unet_tpu_torch serve      (streaming batch inference)
    python -m pcss_unet_tpu_torch validate   ≙ validate_consistency.py
    python -m pcss_unet_tpu_torch temporal   (pert_loss.py:170-199 over a sequence)
    python -m pcss_unet_tpu_torch inspect    ≙ inference.py:285-297, visualize.py

(also ``python -m pcss_unet_tpu_torch.cli.<command>``).  Nothing here
builds or parses anything at import.
"""
