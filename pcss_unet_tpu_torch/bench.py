"""Inference bench of the port on one card (port of the root ``bench.py``
and ``scripts/bench_probe.py``):

    python -m pcss_unet_tpu_torch.bench [--device cpu]

Times the forward of the seeded, BN-folded nets in the deployment postures
of ``scripts/bench_probe.py``, each in bfloat16 on the raw frame:

- ``plain``: ``UNet(normalization="none")``, no kernel;
- ``fused``: the same with ``fused_inference`` (K2′, K6);
- ``fused_int8``: also ``int8_inference`` (K3, K5);
- ``chw``: ``infer.chw_engine.chw_forward`` (K2);
- ``chw_int8``: the same with ``int8=True`` (K2, K3, K5).

The standardization and u8 edges of the engine (K1, K4) are not in any
posture.  The configurations are the root bench's (``CONFIGS``): the w64
reference net at 1920×1088 in every posture and in ``fused_int8`` at
batch 2 and 4, and the trimmed w16 net at the paper's 2048×1024.  Weights
come from ``models.init.seeded_variables(widths, seed=0)``, the input
from ``np.random.default_rng(0).standard_normal``.  Each configuration is
measured ``REPEATS`` times by ``utils.benchlib.measure_ms_per_frame``
(streams of 4 and 20 forwards, ``SCAN`` = 16 apart, each timed by its
fastest of ``REPS`` dispatches), in rounds over all of them, and reported
by its median, min, max and spread ``(max − min) / median``, with the
kernels' launches per forward read from their counters around each
measurement.

Prints ONE JSON line: the fastest w64 configuration as
``1080p_inference_frames_per_sec_per_chip`` (the root bench's keys where
they mean the same), ``flops_per_frame`` (GFLOP, FlopCounterMode on the
``plain`` posture: it cannot see the kernels), ``implied_tflops`` and
``mfu`` (its share of the bf16 peak, measured on a card only), the
trimmed-2K keys (always ``TRIMMED_2K``, the trimmed net's deployment
posture ``chw_int8``: the fastest w16 posture flips between runs to
``fused_int8``, whose repeats spread widely), the 2K-throughput keys, and
every configuration under ``postures``.  ``PCSS_BENCH_H`` / ``_W`` /
``_2K_H`` / ``_2K_W`` shrink the frames.  Without a card it exits 2
unless ``--device cpu`` is passed; a configuration that fails raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from pcss_unet_tpu_torch.infer.chw_engine import chw_forward
from pcss_unet_tpu_torch.models.fold_bn import fold_batchnorm
from pcss_unet_tpu_torch.models.init import seeded_variables
from pcss_unet_tpu_torch.models.unet import unet_for_variables
from pcss_unet_tpu_torch.ops.kernels import KERNELS
from pcss_unet_tpu_torch.utils import benchlib

WIDTHS = {"w64": (64, 128, 512, 1024),     # the reference net
          "w16": (16, 32, 128, 256)}       # the paper's trimmed net
PAPER_2K_MS = 5.8      # the paper's optimized net, 2048×1024, RTX 2080 Ti
REPEATS = 3            # measurements of each configuration
SCAN = 16              # hi − lo of every stream pair (lo 4, hi 20)
REPS = benchlib.CANON_REPS     # dispatches of each stream; the fastest counts


class Config(NamedTuple):
    name: str
    net: str            # "w64": the headline frame; "w16": the 2K frame
    impl: str
    batch: int


# the root bench's configurations (bench.py:221-344)
CONFIGS = tuple(Config(f"{net}_b{b}_{impl}", net, impl, b) for net, impl, b in (
    ("w64", "plain", 1), ("w64", "fused", 1), ("w64", "fused_int8", 1),
    ("w64", "chw", 1), ("w64", "chw_int8", 1),
    ("w64", "fused_int8", 2), ("w64", "fused_int8", 4),
    ("w16", "chw_int8", 1), ("w16", "chw", 1), ("w16", "fused_int8", 1),
    ("w16", "chw", 2), ("w16", "chw", 4)))
TRIMMED_2K = "w16_b1_chw_int8"


def _on_device(tree, device):
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


def posture(impl: str, folded: dict, device):
    """``(apply_fn, params)`` of one posture of a BN-folded net (JAX
    layout, ``models.fold_bn.fold_batchnorm``); ``apply_fn(variables, x)``
    runs one bf16 forward of NHWC float32 frames.  The module postures
    hold their weights (``params`` None); the channels-major ones read
    ``variables["params"]``, already on ``device`` so that no forward
    copies from the host."""
    if impl in ("chw", "chw_int8"):
        int8 = impl == "chw_int8"
        return ((lambda v, x: chw_forward(v, x, dtype=torch.bfloat16, int8=int8)),
                _on_device(folded["params"], device))
    if impl not in ("plain", "fused", "fused_int8"):
        raise ValueError(f"unknown posture: {impl}")
    model = unet_for_variables(folded, dtype=torch.bfloat16, device=device,
                               fused_inference=impl != "plain",
                               int8_inference=impl == "fused_int8")
    return (lambda v, x: model(x)), None


def frame_sizes() -> dict:
    """(H, W) of each net's frame: 1920×1088 and 2048×1024, or the
    environment's shrunk sizes."""
    env = os.environ.get
    return {"w64": (int(env("PCSS_BENCH_H", 1088)), int(env("PCSS_BENCH_W", 1920))),
            "w16": (int(env("PCSS_BENCH_2K_H", 1024)), int(env("PCSS_BENCH_2K_W", 2048)))}


def measure(apply_fn, params, x) -> tuple[float, dict, int]:
    """One measurement of one configuration: (ms per frame, each kernel's
    launches, forwards run).  The counters are host integers, read before
    and after the measurement, so reading them waits for nothing."""
    forwards = [0]

    def counted(v, xx):
        forwards[0] += 1
        return apply_fn(v, xx)

    before = [k.launches for k in KERNELS]
    ms = benchlib.measure_ms_per_frame(counted, params, {}, x, scan_len=SCAN, reps=REPS)
    launches = {k.__name__: k.launches - b for k, b in zip(KERNELS, before)}
    return ms, launches, forwards[0]


def _fastest(rows: dict, names) -> tuple[str, dict]:
    return min(((n, rows[n]) for n in names), key=lambda nr: nr[1]["median_ms"])


def build(device: str) -> dict:
    """Every configuration's ``(apply_fn, params, x)`` on ``device``: its
    posture (one per net and posture) and its input frames."""
    sizes = frame_sizes()
    folded = {net: fold_batchnorm(seeded_variables(w, seed=0))
              for net, w in WIDTHS.items()}
    postures, built = {}, {}
    for cfg in CONFIGS:
        h, w = sizes[cfg.net]
        if (cfg.net, cfg.impl) not in postures:
            postures[cfg.net, cfg.impl] = posture(cfg.impl, folded[cfg.net], device)
        x = np.random.default_rng(0).standard_normal((cfg.batch, h, w, 4))
        built[cfg.name] = (*postures[cfg.net, cfg.impl],
                           torch.as_tensor(x.astype(np.float32), device=device))
    return built


def run(device: str) -> dict:
    """Every configuration ``REPEATS`` times, in rounds; → the result
    object."""
    sizes = frame_sizes()
    built = build(device)
    runs = {cfg.name: [] for cfg in CONFIGS}
    for _ in range(REPEATS):
        for cfg in CONFIGS:
            runs[cfg.name].append(measure(*built[cfg.name]))
    lo, hi = benchlib.scan_lengths(SCAN)
    rows = {}
    for cfg in CONFIGS:
        ms = np.asarray([r[0] for r in runs[cfg.name]])
        forwards = sum(r[2] for r in runs[cfg.name])
        launches = {k: sum(r[1][k] for r in runs[cfg.name]) for k in runs[cfg.name][0][1]}
        med = float(np.median(ms))
        h, w = sizes[cfg.net]
        rows[cfg.name] = {
            "impl": cfg.impl, "widths": list(WIDTHS[cfg.net]),
            "frame": f"{w}x{h}", "batch": cfg.batch, "median_ms": med,
            "min_ms": float(ms.min()), "max_ms": float(ms.max()),
            "spread": float((ms.max() - ms.min()) / med), "runs_ms": ms.tolist(),
            "scan_lo": lo, "scan_hi": hi, "reps": REPS, "forwards": forwards,
            "launches_per_forward": {k: n / forwards for k, n in launches.items() if n}}

    plain = next(c for c in CONFIGS if c.net == "w64" and c.impl == "plain")
    apply_fn, params, x = built[plain.name]
    flops = benchlib.forward_flops(apply_fn, params, {}, x)
    on_card = device == "cuda"
    head, hrow = _fastest(rows, [c.name for c in CONFIGS if c.net == "w64"])
    fps = 1000.0 / hrow["median_ms"]
    result = {"metric": "1080p_inference_frames_per_sec_per_chip",
              "value": fps, "unit": "frames/sec", "dtype": "bfloat16",
              "frame": hrow["frame"], "batch": hrow["batch"], "impl": hrow["impl"],
              "configuration": head,
              "device": torch.cuda.get_device_name(0) if on_card else "cpu",
              "card": benchlib.card_line() if on_card else None,
              "flops_per_frame": None if flops is None else flops / plain.batch / 1e9}
    if flops is not None:
        result["implied_tflops"] = result["flops_per_frame"] * fps / 1000.0
        result["mfu"] = (result["implied_tflops"] * 1e12 / benchlib.PEAK_BF16_FLOPS
                         if on_card else None)
    row = rows[TRIMMED_2K]
    result.update({"trimmed_2k_ms_per_frame": row["median_ms"],
                   "trimmed_2k_impl": row["impl"],
                   "trimmed_2k_vs_paper_optimized_5.8ms": PAPER_2K_MS / row["median_ms"]})
    _, row = _fastest(rows, [c.name for c in CONFIGS
                                if c.net == "w16" and c.batch > 1])
    result.update({"trimmed_2k_throughput_ms_per_frame": row["median_ms"],
                   "trimmed_2k_throughput_batch": row["batch"],
                   "trimmed_2k_throughput_fps": 1000.0 / row["median_ms"]})
    result.update({"repeats": REPEATS, "postures": rows})
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Time the port's inference "
                                "postures on one card")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default: the card; the CPU only "
                        "when asked)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("pcss_unet_tpu_torch.bench: no CUDA device (pass --device cpu "
              "to run on the CPU)", file=sys.stderr)
        raise SystemExit(2)
    result = run(args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
