"""Data layer (port of ``pcss_unet_tpu/data``): scene organization →
streaming record packing → per-channel statistics → host/device input
pipeline.

Reference roles covered (SURVEY.md §1 L1/L2):

- ``organize``     — scene split into pair dirs (organize_data.py:5-105)
- ``records``      — EXR/PNG pairs → mmap-able packed ``.npy`` arrays
                     (prepare_dataset.py:12-106), streaming instead of the
                     reference's all-in-RAM ``np.stack``; plus the orphan
                     per-file export (preprocess.py:31-64, transpose bug fixed)
- ``stats``        — two-pass fp64 channel statistics + reference artifact
                     formats (calculate_dataset_stats.py:23-108)
- ``pipeline``     — mmap-gather ``PackedDataset`` (setdata.py:207-331 role),
                     lazy ``PairDataset`` (setdata.py:138-205 role), the
                     shuffling/sharding/cropping ``Loader`` and device prefetch
- ``device_cache`` — device-resident dataset cache (no reference equivalent):
                     gather/crop batches on the card, no per-step copies
- ``grain_pipeline`` — the ``--grain`` loader, Grain's interface without Grain
"""

from pcss_unet_tpu_torch.data.organize import (organize_dataset,
                                               replace_exr_files)
from pcss_unet_tpu_torch.data.pipeline import (Loader, PackedDataset,
                                               PairDataset, discover_pairs,
                                               prefetch_to_device)
from pcss_unet_tpu_torch.data.records import build_packs, export_per_file
from pcss_unet_tpu_torch.data.stats import (compute_channel_stats,
                                            load_channel_stats)

__all__ = [
    "Loader", "PackedDataset", "PairDataset", "build_packs",
    "compute_channel_stats", "discover_pairs", "export_per_file",
    "load_channel_stats", "organize_dataset", "prefetch_to_device",
    "replace_exr_files",
]
