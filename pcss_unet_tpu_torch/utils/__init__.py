"""Utilities (port of ``pcss_unet_tpu/utils``): logging, the memory
governor's arithmetic, PRNG streams, the bench harness, profiling, the
numerical sanitizers and graph dumps."""
