#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Builds the port's CUDA kernels from ``pcss_unet_tpu_torch/csrc`` (into
``build/kernels``) and, beside them, the native EXR codec from
``native/exr`` (into ``build/exr``), then runs these phases, each printing
one JSON line:

1. ``build``: the card (name, power limit), the kernels' build time and the
   ``ptxas`` register/spill report.  For the bf16 tensor-core kernels (K2's
   ``convblock_chw_tc_kernel``, K6's ``block128_tc_kernel`` and
   ``block128_tc_kernel_wgmma``) and each int8 kernel (the 3×3
   ``int8_taps_kernel_wgmma`` and 1×1 ``int8_taps_kernel`` instantiations)
   it prints the registers, spill bytes, shared memory per block (K6 at the
   recorded w64 ``dec_2`` shape, K5's 3×3 at four chunks) and the count of
   ``HMMA``, ``HGMMA``, ``IMMA``, ``IGMMA`` and ``IDP4A`` instructions in the
   library's SASS (``cuobjdump``); it fails if any of them spills, if a
   ``mma.sync`` bf16 kernel has no ``HMMA``, K6's wgmma kernel no ``HGMMA``,
   the 1×1 no ``IMMA`` or the 3×3 no ``IGMMA`` (warpgroup MMA), or if any
   function has an ``IDP4A``.
   ``band_copy``: the int8 blocks' band copy (``rowmax_kernel_quant_bands``,
   each input quantized once) at the w64 ``dec_1`` (K3) and ``dec_0`` (K5)
   shapes: equal to its plain version byte for byte, no spills, each block
   call's device launches exactly the row maxima, the band copy, the 3×3
   and the 1×1 (so one band copy per int8 block, 2 a w64 frame), the copy's
   device ms against its bytes bound.
Then the training phases (before the kernel phase, which also holds the
trained net's kernel calls), each freeing what it used:

- ``train``: 16 train and 8 val renderer-plausible 2048×1024 frames with
  a learnable soft-shadow label, written from seed 0 as NHWC float32
  packs with ``train_stats.npy``; ``cli.train.main`` in process with
  ``--config config.ini --loss_type perturb --allow_random_vgg
  --num_epochs 2`` (w64, batch 8, adamw, bf16: 2 epochs × 2 steps, at
  the smallest ``--grad_accum_steps`` of 1, 2, 4 that fits, an
  out-of-memory at a smaller one printed as ``train_oom``): every step's
  loss terms finite and none skipped, validation in both epochs,
  checkpoints ``ckpt_0.pt`` and ``ckpt_1000.pt`` (the save rules), the
  last equal to the final parameters; per-step ms (CUDA-synchronised),
  steps/s and samples/s after the first step, peak allocated and reserved
  memory.  ``train_resume``: ``--num_epochs 3`` resumes at epoch 2, step
  4, with the saved parameters bit for bit, and ends at step 6.
- ``train_bench``: the JAX train bench's configs (``scripts/
  bench_train.py:28-39``): 256² crops at batch 8, standard and perturb,
  and 2048×1024 batch 8 (standard) at the smallest accumulation that
  fits: the median of 10 CUDA-synchronised steps after 3, peak memory;
  ``train_profile``: one more step of each under torch.profiler (device
  busy against the step, launches, the largest device items).
  ``train_overfit``: 30 steps on one 256² batch of 8, warmup 0, dropout 0,
  and the loss must fall.
- ``train_parity``: 3 train steps of the w64 net (batch 2, 128×128,
  dropout 0, float32, TF32 off) on the card and on the CPU: losses within
  1e-4, each parameter's change at cosine > 0.995 and norm within 2 %.
- ``bn_tail``: the train-mode BatchNorm → LeakyReLU → Dropout2d kernel
  pair (``ops/kernels/bn_train.py``) on the inputs one w64 bf16 train
  forward and backward at batch 8 of 2048×1024 gives it: every block routed
  to it, its launches (3 a conv output forward, 3 backward, 3 more a conv
  output of the bottleneck's recompute), each call's forward and backward
  against the plain versions (output and dx within one bf16 rounding, two
  for a dropout's output; the running statistics within 1e-5, dγ and dβ
  within 1e-4), the storage of
  each conv output and incoming gradient, wrapper, device, plain and bound
  ms (bytes at 3.35 TB/s: 6 an element forward, 10 backward).
- ``dp_train``: two gloo ranks on cuda:0 (each ``python3 chip_smoke.py
  --dp-rank R WORK``, joined from the environment as ``--multihost`` joins)
  at w64 on a global batch of 8 512×1024 frames, float32 with TF32 off: the
  group step, standard and perturbed, against the one-process batch-8 step
  (train_parity's bars, the BatchNorm statistics within 1e-4), ZeRO-1 against
  the explicit step (rtol 1e-4, atol 1e-5), bf16 ms per step of the two
  ranks beside one process's; then ``train --data_parallel 2 --device
  cuda:0`` for one epoch: one set of checkpoints, written by rank 0.
- ``train_to_serve``: the trained net exported with
  ``export_reference_checkpoint``, loaded with ``load_variables`` and run
  through both int8 engines (bf16, 1920×1080 padded to 1088): launch
  counts as the seeded w64 paths' (``train_to_serve_nhwc`` / ``_chw``),
  ``w64_trained_vs_plain`` as ``w64_vs_plain``, and the masks against the
  trained float32 net on the 8 val frames (reported).  The kernel phase
  holds the kernel calls of one NHWC and one chw trained frame as path
  ``w64_trained``.

Then the chain from renders to a trained net, every command through
``python -m pcss_unet_tpu_torch`` in process:

- ``data_cli``: 20 renderer-plausible 2048×1024 frames written by the
  port's ``write_exr`` and ``encode_png`` as a raw scene, then
  ``organize`` → ``prepare`` → ``stats`` → ``check channels`` → ``check
  packs``: the split 16/4, every pack row equal to its file's decode in
  ``discover_pairs`` order, the stats equal to numpy float64 over the pack
  within 1e-12 relative, both checks exit 0; seconds of each step and
  prepare's ms per frame.
- ``train_governor``: ``train`` on those packs at config.ini's reference
  settings (w64, batch 8, perturb, ``--allow_random_vgg``, governor = xla:
  one real step per candidate, its peak allocated memory measured), 1
  epoch of 2 steps, ``--grad_accum_steps 0``: accum 1 picked, the probe's
  peak within ±10 % of the peak allocated during the run's ``fit``, the
  model ``fit`` receives equal to a ``--grad_accum_steps 1`` run's (the
  probe touched nothing); each probe, the card's budget and the analytic
  answers beside them; then batch 16 (which accum, whether its first step
  completes).
- ``train_cache``: every train and val batch of ``DeviceCache.batches``
  equal to the streamed one (``torch.equal``), full frames and 512² crops;
  step ms of the reference config with ``device_data_cache`` on and off.
- ``grain``: ``train --grain --grain_workers 4``, 2 finite steps at 256²
  batch 8.
- ``temporal``: the CLI on deploy_w16's golden sequence (``--fold_bn``, and
  with ``--quantize int8``): the score under the JAX suite's gate and equal
  within 1e-6 to the metric of the engine's masks, one PNG per frame; on
  the seeded w64 net over 4 animated 1920×1080 frames with motion vectors,
  int8, with the main paths' stats: the score and the launches per frame
  (the ``main_path_w64_nhwc`` path's, without K4).
- ``e2e_chain``: ``infer`` of a val EXR of the scene with the checkpoint
  directory ``train_governor`` wrote and ``--stats_dir`` from ``stats``
  (``--fold_bn --quantize int8``): the launches per frame, and the PNG's
  codes ``trunc(255 · engine mask)``.
- ``spatial_train``: row-sharded training, four gloo ranks on cuda:0 (each
  ``python3 chip_smoke.py --sp-rank R WORK``): the w64 group step on the
  1×2 and 2×2 grids of ``DP_HW`` frames against ``dp_train``'s one-process
  run (adamw, float64, deterministic cuDNN: train_parity's bars); the 1×2
  grid against one process at config.ini's reference (batch 8 of
  2048×1024, bf16, perturb): ms per step, each rank's peak allocated
  memory, halo exchanges per step and the bytes they all-reduce; then
  ``train --spatial_parallel 2 --device cuda:0`` for one epoch on the
  chain's packs (one set of checkpoints).

2. ``kernel``: each kernel against its plain PyTorch version on the card, on
   the inputs each main path really gives it (recorded from one forward of
   each of the three paths below, and of the tiled CLI's forward,
   ``w16_tiled``: the 2048×1024 frame as 15 tiles of 512 in one batch, so
   K1, K2 and K3 are held at N = 15), in bfloat16, plus one float32 case per
   kernel with TF32 off; max |d| against the stated tolerance (exact for K1
   in each of its layouts, the int8 kernels and K4), kernel and plain times
   from CUDA events, per path.  Each kernel also prints one ``kernel_call``
   line per recorded call (each tensor argument's shape and strides, ms,
   ``ms_cold``: the mean of 10 calls each after a 128 MiB write that
   flushes the L2, CUDA events around the call alone, bound, its share of
   the kernel's time, plain ms, max and signed mean of the difference), with
   ``device_total_ms``: the call's device time from CUDA events around 20
   calls queued behind a device-side wait, ``device_ms``: that less the
   wrapper's own device copies and casts (from torch.profiler over 20 more
   calls), its ``device_bound_share``, and ``profile_kernel_events``: the
   library's kernel events the profile kept a call; K2′'s lines name the
   ``stage`` it took (``convblock.stage_of``).  K1 is checked as each path calls it (entry
   ``chw`` or ``nhwc``, bf16) and in the reference's layout (entry None).
   The headline path of K1–K4 is
   the w16 2048×1024 chw+int8 forward, that of K5 (w64 ``dec_0``), K6 (w64
   ``dec_2``) and K2′ (w64 ``enc_0``, ``enc_1``, ``dec_final``) the w64
   1920×1088 NHWC forward; K7, on no model path, runs at the w64 ``dec_1``
   conv shape [1,272,480,512] → 512.  ``banded_resize`` (the kernel behind
   ``ops/resize.py::apply_matrix``, with no TPU counterpart) on the w64
   NHWC forward's eight calls, against the dense product
   (``apply_matrix_dense``) as its plain version: within one ulp of bf16 at
   the values' magnitude, and of float32 per addition in the float32 case;
   its bound is the bytes of x, the output and the band tables.
   ``block128_storage``: K6's recorded main-path input (channels-last
   storage, as the resize before it keeps its input's) reaches
   ``block128_tc_kernel_wgmma`` in place, with no copy (one more
   ``fused_block128_nhwc.wgmma_launches``, printed), and the output comes
   back channels-last.  Every main path's K6 calls take that kernel
   (``wgmma_launches`` equal to ``launches``).  ``weight_prep``: the per-frame int8
   quantization of the w64 int8 blocks' weights.  ``w64_vs_plain``: the w64
   forward through the kernels against the same forward with every kernel
   swapped for its plain version, within twice the plain forward's change
   under a one-ulp nudge of its input: both int8 postures in bfloat16 (the
   main paths' engines) and float32 (TF32 off), and the NHWC fused posture
   without int8 in float32.
3. ``golden``: the committed ``tests/golden/deploy_w16`` net through
   ``InferenceEngine(layout="chw", fold_bn=True, quantize="int8")`` in
   bfloat16 on the 8 validation frames (PSNR ≥ 11.69 dB), and in float32
   against the same engine on the CPU.
4. ``main_path``: full-width 2048×1024 w16 frames through the chw+int8
   ``render_u8`` with the kernels' launch counters zeroed just before and
   read just after (per frame: K1 ×1, K2 ×6, K3 ×1, K4 ×1; the banded
   resize's launches are printed, and must not be 0), the time per frame,
   then one frame under ``torch.profiler`` (device busy and idle share,
   ``device_launches``: the device kernels, copies and memsets of the
   frame, and the device events from K1 to the first block kernel in time
   order).  ``benchmark/run.py --trace 1`` compares such counts between
   two checkouts.
5. ``golden_nhwc``: the golden net as in 3 through
   ``InferenceEngine(layout="nhwc", fold_bn=True, quantize="int8")``.
6. ``main_path_w64_nhwc``: 1920×1080 frames padded to 1920×1088 through the
   NHWC fused+int8 ``render_u8`` of the w64 net ``(64, 128, 512, 1024)``
   with seeded weights (per frame: K1 ×1, K2′ ×3 and so K2 ×3, K3 ×1,
   K5 ×1, K6 ×1, K4 ×1; the stage routing is printed; K2′ copies none of
   its inputs, as every main path must), then a profile.
7. ``main_path_w64_chw``: the same frames through the chw+int8 engine (per
   frame: K1 ×1, K2 ×4, K3 ×1, K5 ×1, K4 ×1), then a profile.
   ``sharded_infer``: the spatially sharded forward (``infer_sharded``) on
   1×2 and 1×4 meshes of this card (the windows run one after another: not
   a faster path on one card) for the w64 1080p frame in four postures (plain
   float32 with TF32 off, NHWC fused+int8, chw+int8 through the NHWC kernel
   model, NHWC fused bf16 without int8) and the w16 2048×1024 frame in
   chw+int8: launches per sharded frame (per window: K1 ×1, K2′ ×3, K3 ×1,
   K5 ×1, K6 ×1 in the int8 postures), max |d| and uint8 codes changed
   against the unsharded forward of the same padded frame (gated: plain
   float32 ≤ 5e-7, fused bf16 without int8 exact), sharded and unsharded ms.
   The kernel phase holds the 1×2 NHWC fused+int8 windows' calls as path
   ``w64_sharded``: K1 (float32 out), K3, K5 exact, K2′ and K6 within 2e-2.

8. ``cli_infer``: the user's command, in process: the w16 main-path frame
   written as a float32 ZIP EXR by the port's ``write_exr``, a
   ``train_stats.npy`` from ``deploy_w16.json``, then ``cli.infer.main``
   with ``--weights tests/golden/deploy_w16.npz --stats_dir … --fold_bn
   --quantize int8 --layout chw``, launch counters zeroed just before each
   run and read just after (K1 ×1, K2 ×6, K3 ×1, K4 ×0: the CLI truncates
   on the host as the reference does); the PNG's codes must equal
   ``trunc(255 · engine(frame))`` exactly; the EXR codec that decoded
   (``native`` or ``python``, with the build error if any) and the median
   host-clock ms of decode, forward and PNG write over 5 runs after one warm
   run.
9. ``cli_tiled``: the same with ``--tile 512 --halo 32`` (one batch of 15
   tiles, the same launch counts): PSNR ≥ 35 dB against the untiled mask,
   device blend within 1e-6 of host blend, PNG codes those of the mask.
10. ``cli_validate``: ``cli.validate.main`` on the first deploy_w16
    validation frame as an EXR, float32 ``--fold_bn`` (must be EXACT or
    PASS) and ``--fold_bn --quantize int8 --bf16``, with the state of TF32.
11. ``serve``: the streaming server (``infer/server.py``) on the w64 NHWC
    fused+int8 engine of phase 6: 8 renderer-plausible 1920×1080 frames
    per codec (``scripts/bench_serve.py``'s content, written by the port's
    ``write_exr``) served as 32 files, DWAA and PIZ, at (batch, decode
    workers) = (1, 4) and (4, 8), one line per run with the JAX bench's
    fields (fps, p50/p99 ms, decode / dispatch / sync / wall s, the
    decode-only and compute-side fps ceilings) and the launches per batch
    (K1 ×1, K2′ ×3, K3 ×1, K5 ×1, K6 ×1, K4 ×1, checked); every served mask
    must equal ``render_u8`` of the same padded batch, code for code (the
    difference from the same frame at N = 1 is printed, not gated).  The
    kernel phase holds the same engine's batch of 4 frames (path
    ``w64_serve_b4``): K1, K3, K4, K5 exact, K2′ and K6 within 2e-2.
12. ``serve_cli``: ``python -m pcss_unet_tpu_torch serve`` in process on the
    8 DWAA frames (``--quantize int8 --batch 4``, the w64 weights as an
    ``.npz``): every PNG's codes equal ``render_u8``'s; fps and the PNG
    write's share of the wall time.
13. ``export``: the w64 engine's plain graph through ``torch.export`` at
    1088×1920 on the card, loaded from bytes: float32 (TF32 off) within
    1e-6 of ``run_padded(x, plain=True)`` (the trace holds the banded
    resize's plain version, bit for bit the kernel's); the bf16 export
    against the kernel path (max |d| and ms per frame of each); blob size,
    torch version.

14. ``bench``: ``python -m pcss_unet_tpu_torch.bench`` in process
    (streams of 4 and 20 forwards, fastest of 4 dispatches, 3 repeats): one
    line per configuration (the root bench's postures ``plain``, ``fused``,
    ``fused_int8``, ``chw``, ``chw_int8`` of the seeded w64 net at
    1920×1088, ``fused_int8`` at batch 2 and 4, the w16 net at 2048×1024 in
    ``chw_int8``, ``chw``, ``fused_int8`` and ``chw`` at batch 2 and 4):
    median, min, max, spread, scan lengths, repeats, and the launches per
    forward read from the counters around every measurement, held to
    ``BENCH_WANT``; one profiled stream of 8 forwards (the host's enqueue,
    the device's busy share inside it); then the bench's own JSON line.
15. ``inspect``: ``python -m pcss_unet_tpu_torch inspect --config
    config.ini --memory --latency --dot …`` in process (the w64 net at
    2048×1024): its rows ``enc_0`` … ``dec_final``, ``full_model``, and a DOT
    graph.
16. ``parity_ref``: the reference's torch U-Net (``parity/unet_torch.py``,
    w64, seeded BatchNorm statistics) at 1088×1920 in float32 with TF32 off
    against the port's plain ``UNet`` loaded from its state dict (PSNR > 50
    dB and max |d| ≤ 1e-4), and the two bf16 int8 engines' PSNR and max |d|
    against it (reported).

Then the ``{"kernels": [...]}`` line (``launches``: the sum over the three
main-path runs, the ten sharded frames, the two trained-net runs, the temporal and e2e_chain runs,
the two counted CLI runs, the four server runs, the serve CLI's run and the
bench; ``ms``, ``plain_ms`` and ``bound_ms``: per frame of the
kernel's headline path; ``max_abs_err``: over every path), the card's name and power limit as ``nvidia-smi`` prints
them, and the result line.  Any failure raises and exits non-zero; with no
CUDA device the script exits 2 and prints nothing.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pcss_unet_tpu_torch.utils.benchlib import (PEAK_BF16_FLOPS,
                                                PEAK_BYTES_PER_S,
                                                PEAK_F32_FLOPS, PEAK_INT8_OPS,
                                                card_line)

REPO = os.path.dirname(os.path.abspath(__file__))
FRAME_H, FRAME_W = 1024, 2048
MAIN_FRAMES = 10
W64 = (64, 128, 512, 1024)
W64_H, W64_W = 1080, 1920       # padded to 1088 rows by the engine's ×16
W64_FRAMES = 5
TILE, HALO = 512, 32           # the tiled CLI's --tile / --halo: 3 x 5 tiles
CLI_RUNS = 5                   # timed CLI runs after one warm run
SERVE_FRAMES, SERVE_FILES = 8, 32   # distinct frames per codec, files served
SERVE_RUNS = ((1, 4), (4, 8))       # (batch, decode workers), as the JAX bench
SERVE_BATCH = 4                     # the kernel phase's w64_serve_b4 batch
WEIGHTS = os.path.join(REPO, "tests", "golden", "deploy_w16.npz")
NO_LIBRARY = ("no single PyTorch call computes this function (a whole "
              "block, or an int8 conv with per-band dynamic scales)")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_state() -> str:
    """The card's SM clock and its maximum, power draw and temperature, as
    ``nvidia-smi`` prints them (what it says on a failure)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60)
    return (out.stdout or out.stderr).strip()


def ptxas_entries(log: str, kernel: str) -> list[dict]:
    """Every entry function whose mangled name contains ``kernel``: its
    name, registers and [spill store, spill load] bytes from ``ptxas -v``."""
    lines, found = log.splitlines(), []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m and kernel in m.group(1):
            rep = " ".join(lines[i + 1:i + 4])
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", rep)
            rg = re.search(r"Used (\d+) registers", rep)
            found.append({"name": m.group(1), "registers": int(rg.group(1)),
                          "spill_bytes": [int(sp.group(1)), int(sp.group(2))]})
    if not found:
        raise AssertionError(f"no ptxas report for {kernel}")
    return found


def sass_counts(lib_path: str) -> dict:
    """{function: {"HMMA": n, "HGMMA": n, "IMMA": n, "IGMMA": n, "IDP4A": n}}
    over the library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = {"HMMA": 0, "HGMMA": 0, "IMMA": 0, "IGMMA": 0, "IDP4A": 0}
        elif fn is not None:
            counts[fn]["HMMA"] += len(re.findall(r"\bHMMA\b", ln))
            counts[fn]["HGMMA"] += len(re.findall(r"\bHGMMA\b", ln))
            counts[fn]["IMMA"] += len(re.findall(r"\bIMMA\b", ln))
            counts[fn]["IGMMA"] += len(re.findall(r"\bIGMMA\b", ln))
            counts[fn]["IDP4A"] += len(re.findall(r"\bIDP\.?4A\b", ln))
    return counts


def demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
        return out if len(out) == len(names) else names
    except (OSError, subprocess.SubprocessError):
        return names


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card from CUDA events (warm L2)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


L2_FLUSH_BYTES = 128 * 2 ** 20      # written before each cold call (L2: 50 MB)


@functools.cache
def l2_flush_buffer():
    import torch

    return torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")


def cuda_ms_cold(fn, iters: int = 10) -> float:
    """Mean time of ``fn`` on the card with a cold L2: a 128 MiB buffer is
    written before each call, and CUDA events bracket the call alone."""
    import torch

    flush = l2_flush_buffer()
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, stop in events:
        flush.zero_()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


@contextlib.contextmanager
def no_tf32():
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def deterministic_cudnn():
    """cuDNN's deterministic algorithms: one process's runs of a step then
    agree bit for bit, and two runs differ only by what they compute."""
    import torch

    return torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                      allow_tf32=False)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(n_bytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def golden_frames():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_deployment_golden import make_frames

    with open(os.path.join(REPO, "tests", "golden", "deploy_w16.json")) as f:
        meta = json.load(f)
    xv, yv = make_frames(meta["seed_val"], meta["n_val"])
    return meta, xv, yv


@contextlib.contextmanager
def swapped(replacements):
    """Module attributes ``(module, name, fn)`` replaced while inside."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in replacements]
    try:
        for mod, name, fn in replacements:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def record_calls(run, patched):
    """Run ``run()`` (one forward) with the given kernel wrappers (module,
    name, key) recording their arguments (the inputs the main path gives
    each) as copies with the caller's strides, so that a wrapper is timed on
    the layout the main path hands it (K2′, for one, stages channels-last
    storage at ``enc_0`` and ``dec_final`` and channels-major storage at
    ``enc_1`` in place, each its own way)."""
    import torch

    calls = {key: [] for _, _, key in patched}

    def recorder(fn, key):
        def record(*args, **kw):
            calls[key].append((tuple(
                a.clone() if torch.is_tensor(a) else a for a in args), kw))
            return fn(*args, **kw)
        return record

    with swapped([(mod, name, recorder(getattr(mod, name), key))
                  for mod, name, key in patched]):
        run()
    return calls


def dev_ms(e) -> float:
    """A profiler event's own device time in ms."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0)) / 1e3


def device_events(fn, expect=(), tries: int = 3):
    """``fn()`` under torch.profiler: (the device-side events (kernels,
    copies, memsets) summed by name, the same events one by one in time
    order).  The trace starts one step before ``fn`` (a warm-up step with
    one small kernel, not kept): started with the call, it can miss the
    call's first kernel.  A profile that still caught no device event, or
    none whose name holds one of ``expect``, is taken again, up to
    ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def on_device(e):   # the step's own span is an annotation, not work
        return e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
        summed = [e for e in prof.key_averages() if on_device(e)]
        if summed and (not expect or any(k in e.key for e in summed for k in expect)):
            break
    ordered = sorted(filter(on_device, prof.events()), key=lambda e: e.time_range.start)
    return summed, ordered


def kernel_counts(summed) -> dict:
    """Launches of each device kernel by its function's name (the word
    before its template arguments), from :func:`device_events`' sums."""
    counts = {}
    for e in summed:
        m = re.search(r"(\w+)<", e.key)
        name = m.group(1) if m else e.key[:60]
        counts[name] = counts.get(name, 0) + e.count
    return counts


# each int8 block call: the row maxima, the band copy, the 3×3, the 1×1
INT8_BLOCK_LAUNCHES = {"rowmax_kernel": 1, "rowmax_kernel_quant_bands": 1,
                       "int8_taps_kernel_wgmma": 1, "int8_taps_kernel": 1}


def band_copy_phase(log: str, card: str, own) -> dict:
    """The int8 blocks' band copy at the w64 frame's int8 blocks (K3 at
    ``dec_1``, K5 at ``dec_0``, bf16, deploy's bands), early in a fresh
    process, where torch.profiler keeps every kernel event: the copy equal
    to its plain version byte for byte, each block call's device launches
    (the library's kernels, ``own``; ``INT8_BLOCK_LAUNCHES``: one band copy
    a call, so 2 a w64 frame, whose NHWC and chw forwards call K3 and K5
    once each), the copy's device ms
    (the profile's ``rowmax_kernel_quant_bands`` events) against its bytes
    bound (x read once, the copy written once), and its ptxas report (no
    spills)."""
    import torch

    from pcss_unet_tpu_torch.ops.kernels import block_int8 as kb8
    from pcss_unet_tpu_torch.ops.kernels.taps import band_copy_shape

    rep = ptxas_entries(log, "rowmax_kernel_quant_bands")
    if any(e["spill_bytes"] != [0, 0] for e in rep):
        raise AssertionError(f"band copy spills: {rep}")
    gen = np.random.default_rng(0)
    line = {"phase": "band_copy", "card": card, "registers": [e["registers"] for e in rep],
            "blocks": []}
    for name, (h, w, c, co), (k, cc) in (
            ("fused_block_int8_nhwc", W64_DEC_1, (kb8.pick_k_rows_int8(*W64_DEC_1), W64_DEC_1[2])),
            ("fused_block_int8_kchunked", W64_DEC_0, kb8.pick_kchunked(*W64_DEC_0))):
        x = torch.from_numpy(gen.standard_normal((1, h, w, c), np.float32)).cuda().bfloat16()
        params = {"conv_a": {"kernel": gen.standard_normal((3, 3, c, c)) * 0.05,
                             "bias": gen.standard_normal(c) * 0.1},
                  "conv_b": {"kernel": gen.standard_normal((1, 1, c, co)) * 0.05,
                             "bias": gen.standard_normal(co) * 0.1}}
        ops = kb8.pack_block_int8_params(params, device="cuda")
        kw = dict(k_rows=k) if cc == c else dict(k_rows=k, c_chunk=cc)
        block = getattr(kb8, name)
        block(x, *ops, **kw)
        summed, _ = device_events(lambda: block(x, *ops, **kw), ("int8_taps_kernel",))
        launches = {k: v for k, v in kernel_counts(summed).items() if k in own}
        if launches != INT8_BLOCK_LAUNCHES:
            raise AssertionError(f"{name}: device launches {launches}, want "
                                 f"{INT8_BLOCK_LAUNCHES}")
        got = kb8.quantize_bands(x, k_rows=k, c_chunk=cc)
        if not torch.equal(got, kb8.quantize_bands_plain(x, k_rows=k, c_chunk=cc)):
            raise AssertionError(f"{name}: band copy differs from its plain version")
        copy_bytes = math.prod(band_copy_shape(1, h, w, c, k, cc))
        summed, _ = device_events(lambda: [kb8.quantize_bands(x, k_rows=k, c_chunk=cc)
                                           for _ in range(20)], ("quant_bands",))
        ms = sum(dev_ms(e) for e in summed if "rowmax_kernel_quant_bands" in e.key) / 20
        b, _ = bound_ms(x.numel() * x.element_size() + copy_bytes, 0.0, PEAK_INT8_OPS)
        line["blocks"].append({"name": name, "x": [1, h, w, c], "k_rows": k, "c_chunk": cc,
                               "device_launches_per_call": launches,
                               "copy_bytes": copy_bytes, "copy_device_ms": ms,
                               "copy_bound_ms": b, "copy_bound_share": b / ms if ms else None})
        del x, got
    per_frame = sum(W64_NHWC_WANT[b["name"]] * b["device_launches_per_call"][
        "rowmax_kernel_quant_bands"] for b in line["blocks"])
    if per_frame != 2 or any(W64_CHW_WANT[b["name"]] != W64_NHWC_WANT[b["name"]]
                             for b in line["blocks"]):
        raise AssertionError(f"band copies a w64 frame: {per_frame}, want 2")
    line["band_copies_per_w64_frame"] = per_frame
    emit(line)
    return line


def profile_frame(phase, engine, frames, frame_ms: float, own) -> dict:
    """One frame under torch.profiler: time of the device-side events
    (kernels, copies) by name, their sum against the measured frame time
    (the device's busy share) and without the host-to-device copies (whose
    time follows the host), their count (``device_launches``), and in time
    order the events from K1 to the first block kernel (``own``: the
    library's kernel names) with their device µs."""
    summed, ordered = device_events(lambda: engine.render_u8(frames), ("scrub_",))
    blocks = [k for k in own if not k.startswith(("scrub_", "mask_to_u8"))]
    k1 = next((i for i, e in enumerate(ordered) if "scrub_" in e.name), 0)
    first_block = next((i for i in range(k1, len(ordered))
                        if any(k in ordered[i].name for k in blocks)), k1)
    busy = sum(dev_ms(e) for e in summed)
    top = sorted(summed, key=dev_ms, reverse=True)[:15]
    return {"phase": phase, "device_busy_ms": busy, "frame_ms": frame_ms,
            "idle_share": 1.0 - busy / frame_ms if busy else None,
            "device_busy_ms_without_htod": sum(dev_ms(e) for e in summed
                                               if "HtoD" not in e.key),
            "device_launches": sum(e.count for e in summed),
            "k1_to_first_block_us": [[e.name[:60], e.time_range.elapsed_us()]
                                     for e in ordered[k1:first_block + 1]],
            "top_device_ms": [[e.key[:70], dev_ms(e), e.count] for e in top]}


QUEUE_CYCLES = 200_000_000     # the device-side wait ahead of queued calls (~0.1 s)


def queued_device_ms(fn, iters: int = 20):
    """Device time per call of ``fn`` from CUDA events around ``iters``
    calls queued behind a device-side wait, so that the device never waits
    for the host between them: the calls' device work alone (kernels,
    copies, casts; warm L2).  None where enqueuing the calls took the host
    longer than the wait lasted."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(QUEUE_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        return None
    return ev[1].elapsed_time(ev[2]) / iters


def kernel_device_ms(fn, own, iters: int = 20):
    """Device time per call of ``fn``: (the library's own kernels, every
    device operation of the call), ms, and the events of the library's
    kernels that torch.profiler kept a call.  The whole is
    :func:`queued_device_ms`; the library's kernels are the whole less the
    other device operations of a profile of ``iters`` calls.  The profile's
    own kernel times are not summed: late in this script it has kept about
    half of K2's kernel events, which the count shows.  The first is None
    where the profile shows none of the library's kernels, the first two
    where the wait did not cover the calls."""
    total = queued_device_ms(fn, iters)
    summed, _ = device_events(lambda: [fn() for _ in range(iters)], own)
    mine = [e for e in summed if any(k in e.key for k in own)]
    other = (sum(dev_ms(e) for e in summed) - sum(dev_ms(e) for e in mine)) / iters
    caught = sum(e.count for e in mine) / iters
    if total is None:
        return None, None, caught
    return (max(total - other, 0.0) if mine else None), total, caught


def kernel_names(log: str) -> set:
    """The identifiers of the library's kernels (its entry functions, from
    the ptxas report), as the profiler's demangled names hold them."""
    mangled = sorted(set(re.findall(r"Compiling entry function '(\w+)'", log)))
    names = set()
    for pretty in demangle(mangled):
        m = re.search(r"(\w+)[<(]", pretty)
        if m:
            names.add(m.group(1))
    return names


def check_kernel(name, kernel, plain, paths, tol_fn, work_fn, f32_case, own):
    """Kernel vs plain on each call recorded from each main path (``paths``:
    [(path, calls)], the kernel's headline path first; bf16) and on one
    float32 case with TF32 off.  Prints one ``kernel_call`` line per call
    (each tensor argument's shape and strides, times, bound, max and signed
    mean of the difference), so that a time can be put on a stage.  ``ms``
    is the wrapper's time from CUDA events over 20 calls; ``device_ms`` and
    ``device_total_ms`` the device time of the library's kernels (``own``:
    their names) and of every device operation of the call (the wrapper's
    own copies and casts too), by :func:`kernel_device_ms`.  Returns the
    kernels-line entry: max |d| over every path, time, plain time and bound
    per frame of the headline path."""
    import torch

    per_path = {}
    for path, calls in paths:
        worst, ms, plain_ms, t_bound, by_ops = 0.0, 0.0, 0.0, 0.0, 0.0
        dev, ms_cold = 0.0, 0.0
        for i, (args, kw) in enumerate(calls):
            # the tap strategy only orders the kernel's sum; the plain
            # version has one order
            pkw = {k: v for k, v in kw.items() if k != "taps"}
            got = kernel(*args, **kw)
            want = plain(*args, **pkw)
            torch.cuda.synchronize()
            diff = got.float() - want.float()
            d = diff.abs().max().item()
            tol = tol_fn(want, args)
            shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
            if not (d <= tol):
                raise AssertionError(f"{name} ({path}): max |d| {d} > tol {tol} at "
                                     f"{shapes}")
            worst = max(worst, d)
            t = cuda_ms(lambda: kernel(*args, **kw))
            tc = cuda_ms_cold(lambda: kernel(*args, **kw))
            ms_cold += tc
            td, td_all, caught = kernel_device_ms(lambda: kernel(*args, **kw), own)
            tp = cuda_ms(lambda: plain(*args, **pkw), iters=5, warmup=1)
            b, kind = work_fn(args, kw)
            ms, plain_ms, t_bound = ms + t, plain_ms + tp, t_bound + b
            dev = None if dev is None or td is None else dev + td
            by_ops += b if kind == "operations" else 0.0
            emit({"phase": "kernel_call", "name": name, "path": path,
                  "stage": stage_name(name, args[0]),
                  "bound_share": b / t, "device_ms": td,
                  "device_total_ms": td_all, "profile_kernel_events": caught,
                  "device_bound_share": None if td is None else b / td,
                  "call": i, "args": [[list(a.shape), list(a.stride())]
                                      for a in args if torch.is_tensor(a)],
                  "options": {k: list(v.shape) if torch.is_tensor(v) else
                              v if isinstance(v, (int, float, str)) else str(v)
                              for k, v in kw.items()},
                  "ms": t, "ms_cold": tc, "plain_ms": tp, "bound_ms": b,
                  "bound_by": kind,
                  "max_abs_err": d, "mean_signed_err": diff.mean().item(),
                  "tol": tol})
        per_path[path] = {
            "calls_per_frame": len(calls), "max_abs_err": worst, "ms": ms,
            "ms_cold": ms_cold, "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": t_bound,
            "bound_by": "operations" if by_ops > t_bound / 2 else "bytes",
            "shapes": [[tuple(a.shape) for a in args if hasattr(a, "shape")][:1]
                       for args, _ in calls]}
    with no_tf32():
        args, kw = f32_case
        got = kernel(*args, **kw)
        want = plain(*args, **{k: v for k, v in kw.items() if k != "taps"})
        torch.cuda.synchronize()
        d32 = (got.float() - want.float()).abs().max().item()
        tol32 = tol_fn(want, args)
        if not (d32 <= tol32):
            raise AssertionError(f"{name} float32: max |d| {d32} > tol {tol32}")
    emit({"phase": "kernel", "name": name, "max_abs_err_f32": d32,
          "paths": per_path})
    head = per_path[paths[0][0]]
    return {"name": name, "library_ms": None,
            "max_abs_err": max(p["max_abs_err"] for p in per_path.values()),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def stage_name(name, x):
    """How K2′ stages x (``convblock.stage_of``: in place in one of its
    stages, or ``copy``); None for the other kernels."""
    from pcss_unet_tpu_torch.ops.kernels import convblock as kcb

    return kcb.stage_of(x) if name == "fused_conv_block_nhwc" else None


def f32(call):
    import torch

    args, kw = call
    return (tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                  else a for a in args),
            {k: (v.float() if torch.is_tensor(v) else v) for k, v in kw.items()})


# bf16 output: one bf16 rounding of the output plus flips of the hidden
# tile's bf16 rounding from a different float32 sum order; float32 (TF32
# off): sum-order noise only
def conv_tol(want, args):
    import torch

    return ((2e-2 if want.dtype == torch.bfloat16 else 1e-4)
            * max(1.0, want.float().abs().max().item()))


def peak_for(dtype):
    import torch

    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS


def conv_work(args, kw):
    """Operations and input reads over the true columns (those at or past
    ``true_w`` are only written, as zeros); the output over all of Wp."""
    x, w1, _, w2, _ = args
    n, cin, h, wp = x.shape
    cmid, cout = w1.shape[1], w2.shape[0]
    w = kw.get("true_w") or wp
    ops = 2.0 * n * h * w * (9 * cin * cmid + cmid * cout)
    res = kw.get("residual")
    in_bytes = n * h * w * (cin + (0 if res is None else cout)) * x.element_size()
    out_bytes = n * cout * h * wp * x.element_size()
    return bound_ms(in_bytes + nbytes(w1, w2) + out_bytes, ops, peak_for(x.dtype))


def conv_nhwc_work(args, kw):
    x, w1, _, w2, _ = args
    n, h, w, cin = x.shape
    cmid, cout = w1.shape[1], w2.shape[0]
    ops = 2.0 * n * h * w * (9 * cin * cmid + cmid * cout)
    out_bytes = n * h * w * cout * x.element_size()
    return bound_ms(nbytes(x, w1, w2) + out_bytes, ops, peak_for(x.dtype))


def block128_work(args, kw):
    x, w1, _, w2, _ = args
    n, h, w, c = x.shape
    cout = w2.shape[1]
    ops = 2.0 * n * h * w * (9 * c * c + c * cout)
    out_bytes = n * h * w * cout * x.element_size()
    return bound_ms(nbytes(x, w1, w2) + out_bytes, ops, peak_for(x.dtype))


def int8_work(args, kw):
    x, w1q, _, _, w2q, _, _ = args
    n, h, w, c = x.shape
    ops = 2.0 * n * h * w * (9 * c * w1q.shape[2] + w2q.numel())
    out_bytes = n * h * w * w2q.shape[1] * x.element_size()
    return bound_ms(nbytes(x, w1q, w2q) + out_bytes, ops, PEAK_INT8_OPS)


def conv3x3_int8_work(args, kw):
    import torch

    x, wq, _, _ = args
    n, h, w, c = x.shape
    co = wq.shape[2]
    ops = 2.0 * n * h * w * 9 * c * co
    out_bytes = n * h * w * co * (2 if kw["out_dtype"] == torch.bfloat16 else 4)
    return bound_ms(nbytes(x, wq) + out_bytes, ops, PEAK_INT8_OPS)


def scrub_work(args, kw):
    """The frame read once, the output written once with its pad columns
    (the entry's layout, in ``out_dtype``)."""
    import torch

    from pcss_unet_tpu_torch.ops.kernels.fused import entry_shape

    x = args[0]
    out = math.prod(entry_shape(x.shape, kw.get("entry")))
    out_size = torch.empty((), dtype=kw.get("out_dtype", torch.bfloat16)).element_size()
    return bound_ms(nbytes(x) + out * out_size, 0, 1)


def u8_work(args, kw):
    """The float32 mask read once, one byte a pixel written once."""
    return bound_ms(nbytes(args[0]) + args[0].numel(), 0, 1)


def resize_tol(want, args):
    """Kernel vs the dense product: one ulp of the dtype at the largest
    magnitude of x and the result (interpolation weights are at most 1 and
    sum to 1 a row), at float32 one per addition of the band."""
    import torch

    x, bands = args[0], args[1]
    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[want.dtype]
    mag = max(x.float().abs().max().item(), want.float().abs().max().item(), 1e-30)
    adds = max(bands.width - 1, 1) if want.dtype == torch.float32 else 1
    return adds * 2.0 ** (math.floor(math.log2(mag)) - mant)


def resize_work(args, kw):
    """x read once, the output written once, the band tables read once."""
    x, bands, axis = args
    out = x.numel() // x.shape[axis] * bands.out_size * x.element_size()
    return bound_ms(nbytes(x, bands.start, bands.weight) + out, 0, 1)


@functools.lru_cache(maxsize=64)
def _dense_of_bands(bands):
    import torch

    from pcss_unet_tpu_torch.ops.kernels.resize import dense_of

    return torch.as_tensor(dense_of(bands.start.cpu().numpy(), bands.weight.cpu().numpy(),
                                    bands.in_size), device=bands.start.device)


def resize_dense_plain(x, bands, axis):
    """The dense ``apply_matrix`` product of the matrix the tables describe
    (its device copy made once per tables)."""
    from pcss_unet_tpu_torch.ops.resize import apply_matrix_dense

    return apply_matrix_dense(x, _dense_of_bands(bands), axis)


def block128_storage(kc128, build, call) -> None:
    """K6 once on its recorded main-path call with the C entry watched: the
    main path's input (channels-last storage: the resize before ``dec_2``
    keeps the layout of K3's output) must reach ``block128_tc_kernel_wgmma``
    in place (the same pointer, its entry ``pcss_block128_wgmma``, one more
    ``wgmma_launches``) and come back channels-last."""
    args, kw = call
    seen, real = [], build.call

    def watch(name, *a):
        seen.append((name, a))
        return real(name, *a)

    before = kc128.fused_block128_nhwc.wgmma_launches
    with swapped([(build, "call", watch)]):
        out = kc128.fused_block128_nhwc(*args, **kw)
    x = args[0]
    (entry, a), = seen
    line = {"phase": "block128_storage", "x_shape": list(x.shape),
            "x_strides": list(x.stride()),
            "x_channels_major": x.permute(0, 3, 1, 2).is_contiguous(),
            "x_nhwc": x.is_contiguous(), "mode": build.stage_mode(
                tuple(x.shape), x.stride(), x.data_ptr() % 16),
            "kernel": kc128.bf16_kernel(x.shape, x.stride(), x.data_ptr() % 16,
                                        args[3].shape[1]),
            "entry": entry, "x_in_place": a[0] == x.data_ptr(),
            "wgmma_launches": kc128.fused_block128_nhwc.wgmma_launches - before,
            "out_strides": list(out.stride()), "out_nhwc": out.is_contiguous()}
    emit(line)
    if not (line["x_nhwc"] and line["mode"] == kc128.NHWC and line["x_in_place"]
            and line["kernel"] == kc128.WGMMA_KERNEL and entry == "pcss_block128_wgmma"
            and line["wgmma_launches"] == 1 and line["out_nhwc"]):
        raise AssertionError(f"K6 main-path storage: {line}")


def vs_plain_phase(engine, frames, plain, kernels, phase="w64_vs_plain") -> None:
    """One forward (TF32 off) through the kernels against the same forward
    with every kernel wrapper swapped for its plain version (``plain``:
    (module, name, fn)) on the card, held to the forward's own noise floor:
    how far the plain forward moves when each input value moves by one
    float32 ulp.  The int8 postures are not continuous: a one-ulp change
    can move an int8 rounding tie, and on the seeded w64 net a tie moves
    the mask by up to ~0.1, so the kernels (equal to their plain versions
    up to float32 sum order) must stay within twice that floor, in max and
    in mean |d|; without int8 the floor is ~2e-5 and the limits are 1e-3
    (max) and 1e-5 (mean)."""
    import torch

    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    with no_tf32():
        reset_launch_counts()
        got = engine.run_padded(frames)
        launched = {k.__name__: k.launches for k in kernels if k.launches}
        with swapped(plain):
            want = engine.run_padded(frames)
            nudged = engine.run_padded(frames * (1 + 2.0 ** -23))
        torch.cuda.synchronize()
    if not launched or any(k.launches != launched.get(k.__name__, 0)
                           for k in kernels):
        raise AssertionError(f"{engine.layout}: kernel launches {launched} "
                             "before the plain swap, and none under it")
    d, floor = (got - want).abs(), (nudged - want).abs()
    line = {"phase": phase, "layout": engine.layout,
            "dtype": str(engine._dtype).replace("torch.", ""),
            "quantize": engine.quantize,
            "max_abs_err": d.max().item(), "mean_abs_err": d.mean().item(),
            "floor_max": floor.max().item(), "floor_mean": floor.mean().item(),
            "kernels_launched": launched}
    line["tol_max"] = max(2 * line["floor_max"], 1e-3)
    line["tol_mean"] = max(2 * line["floor_mean"], 1e-5)
    if engine.model is not None:
        line["routes"] = engine.model.routes()
    emit(line)
    if not (line["max_abs_err"] <= line["tol_max"]
            and line["mean_abs_err"] <= line["tol_mean"]):
        raise AssertionError(f"w64 {engine.layout} {line['dtype']} "
                             f"{engine.quantize}: kernels vs plain mask "
                             f"|d| beyond twice the noise floor: {line}")


def golden_phase(phase, variables, meta, xv, yv, layout):
    """deploy_w16 through the ``layout`` int8 posture: PSNR in bf16 on the
    card, and the float32 card engine against the float32 CPU engine."""
    import torch

    from pcss_unet_tpu_torch.infer import InferenceEngine

    kw = dict(means=np.asarray(meta["means"], np.float32),
              stds=np.asarray(meta["stds"], np.float32), fold_bn=True,
              quantize="int8", layout=layout)
    engine = InferenceEngine(None, variables, dtype=torch.bfloat16,
                             device="cuda", **kw)
    psnrs = []
    for x, y in zip(xv, yv):
        pred = engine(x)[..., 0]
        psnrs.append(10 * math.log10(1.0 / max(float(np.mean((pred - y[..., 0]) ** 2)), 1e-12)))
    psnr = float(np.mean(psnrs))
    with no_tf32():
        e32 = InferenceEngine(None, variables, dtype=torch.float32,
                              device="cuda", **kw)
        c32 = InferenceEngine(None, variables, dtype=torch.float32,
                              device="cpu", **kw)
        d_cpu = max(float(np.abs(e32(x) - c32(x)).max()) for x in xv)
    line = {"phase": phase, "psnr_db_bf16": psnr, "min_psnr_db": 11.69,
            "max_abs_err_f32_card_vs_cpu": d_cpu, "tol": 2e-2}
    if engine.model is not None:
        line["routes"] = engine.model.routes()
    emit(line)
    if not psnr >= 11.69:
        raise AssertionError(f"{phase} PSNR {psnr} < 11.69 dB")
    if not d_cpu <= 2e-2:
        raise AssertionError(f"{phase}: float32 card vs CPU mask max |d| {d_cpu}")


def main_path(phase, engine, frames, n_frames, want, card, own):
    """``n_frames`` frames through ``render_u8`` with every launch counter
    zeroed just before and read just after; every kernel must have launched
    exactly ``want[name]`` times per frame (0 if absent), K2′ must have
    read its input in place (``fused_conv_block_nhwc.copies`` 0) and every
    K6 call must have taken ``block128_tc_kernel_wgmma``."""
    import torch

    from pcss_unet_tpu_torch.ops.kernels import (KERNELS, banded_resize,
                                                 fused_block128_nhwc,
                                                 fused_conv_block_nhwc,
                                                 reset_launch_counts)

    engine.render_u8(frames)            # warm
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [engine.render_u8(frames) for _ in range(n_frames)]
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / n_frames * 1e3
    launches = {k.__name__: k.launches for k in KERNELS}
    for name, count in launches.items():
        if count != want.get(name, 0) * n_frames:
            raise AssertionError(f"{phase}: {name} launched {count} times in "
                                 f"{n_frames} frames, want {want.get(name, 0)} each")
    resize = {"launches_per_frame": banded_resize.launches / n_frames}
    if not resize["launches_per_frame"]:
        raise AssertionError(f"{phase}: no banded resize launched")
    if fused_conv_block_nhwc.copies:
        raise AssertionError(f"{phase}: K2′ copied its input "
                             f"{fused_conv_block_nhwc.copies} times")
    k6 = {"launches": fused_block128_nhwc.launches,
          "wgmma_launches": fused_block128_nhwc.wgmma_launches}
    if k6["wgmma_launches"] != k6["launches"]:
        raise AssertionError(f"{phase}: K6 took its wgmma kernel in {k6}")
    out = outs[-1]
    b, h, w, _ = frames.shape
    if (tuple(out.shape) != (b, h, w, 1) or out.dtype != torch.uint8
            or not torch.equal(out, outs[0]) or out.min() == out.max()):
        raise AssertionError(f"{phase}: bad output {tuple(out.shape)} {out.dtype}")
    line = {"phase": phase, "frames": n_frames, "frame_hw": [h, w],
            "ms_per_frame": frame_ms, "launches": launches,
            "k2n_copies": fused_conv_block_nhwc.copies, "k6": k6,
            "launches_per_frame_want": want, "banded_resize": resize, "card": card}
    if engine.model is not None:
        line["routes"] = engine.model.routes()
    emit(line)
    emit(profile_frame(f"profile_{phase}", engine, frames, frame_ms, own))
    return launches


def launch_counts() -> dict:
    from pcss_unet_tpu_torch.ops.kernels import KERNELS

    return {k.__name__: k.launches for k in KERNELS}


def run_cli(main, argv, want):
    """``main(argv)`` in process with every launch counter zeroed just
    before and read just after; each kernel must have launched ``want[name]``
    times (0 if absent).  → (what main returned, the counts)."""
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts()
    out = main(argv)
    launches = launch_counts()
    bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{argv}: launches {launches}, want {want}")
    return out, launches


def png_codes(mask: np.ndarray) -> np.ndarray:
    """The mask's PNG codes as the reference writes them: scrubbed,
    clipped, ×255 and truncated (not K4's half-even rounding)."""
    m = np.clip(np.nan_to_num(mask[..., 0], nan=0.0, posinf=1.0, neginf=0.0),
                0.0, 1.0)
    return (m * 255.0).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    from pcss_unet_tpu_torch.io.png import decode_png_l

    with open(path, "rb") as f:
        return decode_png_l(f.read())


CLI_WANT = {"fused_scrub_standardize": 1, "fused_conv_block_chw": 6,
            "fused_block_int8_nhwc": 1}


def cli_infer_phase(work, frame, stats, card):
    """The user's command on one 2048×1024 frame, in process:
    ``infer --input f.exr --output m.png --weights deploy_w16.npz
    --stats_dir d --fold_bn --quantize int8 --layout chw`` (bf16, the
    card).  The frame is written as a float32 ZIP EXR by the port's
    ``write_exr``.  One warm run with the launch counters checked (K1 ×1,
    K2 ×6, K3 ×1, K4 ×0), then ``CLI_RUNS`` timed runs (host clock: decode,
    forward, PNG write; medians).  The PNG must hold exactly the codes
    ``trunc(255 · engine(frame))`` of an engine built the same way.  Also
    the decode time of the frame as a DWAA file (median of 5 after one).
    → (the launch counts, the engine, the frame as read, its mask)."""
    from pcss_unet_tpu_torch.cli import infer as cli_infer
    from pcss_unet_tpu_torch.infer import InferenceEngine, load_variables
    from pcss_unet_tpu_torch.io import exr

    import torch

    path, png = os.path.join(work, "frame.exr"), os.path.join(work, "mask.png")
    t0 = time.perf_counter()
    exr.write_exr(path, {c: frame[..., i] for i, c in enumerate("RGBA")})
    exr_write_ms = (time.perf_counter() - t0) * 1e3
    np.save(os.path.join(work, "train_stats.npy"),
            {"means": stats["means"].tolist(), "stds": stats["stds"].tolist()},
            allow_pickle=True)
    argv = ["--input", path, "--output", png, "--weights", WEIGHTS,
            "--stats_dir", work, "--fold_bn", "--quantize", "int8",
            "--layout", "chw"]
    _, launches = run_cli(cli_infer.main, argv, CLI_WANT)
    timed = [run_cli(cli_infer.main, argv, CLI_WANT)[0] for _ in range(CLI_RUNS)]
    # the same frame as a DWAA file (lossy DCT, the costliest decode): its
    # decode time on this host beside the forward's
    dwaa = os.path.join(work, "frame_dwaa.exr")
    exr.write_exr(dwaa, {c: frame[..., i] for i, c in enumerate("RGBA")},
                  compression="DWAA")
    dwaa_ms = []
    for _ in range(CLI_RUNS + 1):
        t0 = time.perf_counter()
        exr.read_exr_stack(dwaa)
        dwaa_ms.append((time.perf_counter() - t0) * 1e3)
    engine = InferenceEngine(None, load_variables(WEIGHTS), fold_bn=True,
                             quantize="int8", layout="chw",
                             dtype=torch.bfloat16, device="cuda", **stats)
    x = exr.read_exr_stack(path)
    mask = engine(x)
    got, want = read_png(png), png_codes(mask)
    line = {"phase": "cli_infer", "frame_hw": list(x.shape[:2]),
            "exr_backend": timed[-1]["exr_backend"],
            "exr_native_error": exr.native_error(),
            "exr_read_back_equal": bool(np.array_equal(x, frame)),
            "exr_write_ms": exr_write_ms, "runs": CLI_RUNS,
            **{f"{k}_median": float(np.median([t[k] for t in timed]))
               for k in ("decode_ms", "forward_ms", "write_ms")},
            **{k: [t[k] for t in timed]
               for k in ("decode_ms", "forward_ms", "write_ms")},
            "dwaa_decode_ms_median": float(np.median(dwaa_ms[1:])),
            "dwaa_backend": exr.last_backend(),
            "launches": launches, "png_codes_differing": int((got != want).sum()),
            "card": card}
    emit(line)
    if not (line["exr_read_back_equal"] and got.shape == want.shape
            and line["png_codes_differing"] == 0 and want.min() < want.max()):
        raise AssertionError(f"cli_infer: {line}")
    return launches, engine, x, mask


def cli_tiled_phase(work, engine, x, mask, card):
    """The same command with ``--tile 512 --halo 32``: 3 × 5 tiles in one
    batch of 15 (K1 ×1, K2 ×6, K3 ×1).  The tiled mask must be within
    35 dB PSNR of the untiled one (the JAX suite's bar), the device blend
    within 1e-6 of the host blend, and the PNG's codes those of the device
    blend.  → the launch counts."""
    from pcss_unet_tpu_torch.cli import infer as cli_infer
    from pcss_unet_tpu_torch.infer import infer_tiled
    from pcss_unet_tpu_torch.parity import compare_outputs

    png = os.path.join(work, "mask_tiled.png")
    argv = ["--input", os.path.join(work, "frame.exr"), "--output", png,
            "--weights", WEIGHTS, "--stats_dir", work, "--fold_bn",
            "--quantize", "int8", "--layout", "chw", "--tile", str(TILE),
            "--halo", str(HALO)]
    times, launches = run_cli(cli_infer.main, argv, CLI_WANT)
    dev = infer_tiled(engine, x, tile=TILE, halo=HALO, blend="device")
    host = infer_tiled(engine, x, tile=TILE, halo=HALO, blend="host")
    res = compare_outputs(dev, mask, psnr_pass=35.0)
    line = {"phase": "cli_tiled", "tile": TILE, "halo": HALO,
            "forward_ms": times["forward_ms"], "launches": launches,
            "psnr_vs_untiled_db": res["psnr"], "min_psnr_db": 35.0,
            "max_abs_vs_untiled": res["max_abs"],
            "device_vs_host_blend_max_abs": float(np.abs(dev - host).max()),
            "tol_blend": 1e-6,
            "png_codes_differing": int((read_png(png) != png_codes(dev)).sum()),
            "card": card}
    emit(line)
    if not (res["psnr"] >= 35.0 and line["device_vs_host_blend_max_abs"] <= 1e-6
            and line["png_codes_differing"] == 0):
        raise AssertionError(f"cli_tiled: {line}")
    return launches


def cli_validate_phase(work, frame, stats):
    """``validate`` on the first deploy_w16 validation frame, written as an
    EXR, in two postures: float32 ``--fold_bn`` (must be EXACT or PASS) and
    ``--fold_bn --quantize int8 --bf16``.  The training pathway's float32
    convolutions are cuDNN's, so the line carries TF32's state."""
    import torch

    from pcss_unet_tpu_torch.cli import validate as cli_validate
    from pcss_unet_tpu_torch.io import exr

    path = os.path.join(work, "val0.exr")
    exr.write_exr(path, {c: frame[..., i] for i, c in enumerate("RGBA")})
    for posture in (["--fold_bn"], ["--fold_bn", "--quantize", "int8", "--bf16"]):
        res = cli_validate.main(["--weights", WEIGHTS, "--input", path,
                                 "--output_dir", os.path.join(work, "validate"),
                                 "--stats_dir", work, *posture])
        line = {"phase": "cli_validate", "posture": " ".join(posture),
                "frame_hw": list(frame.shape[:2]), **res,
                "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        emit(line)
        if posture == ["--fold_bn"] and res["verdict"] not in ("exact", "pass"):
            raise AssertionError(f"cli_validate float32: {line}")


# per batch of the w64 NHWC fused+int8 forward (K2′ launches K2 once each)
W64_DEC_1 = (272, 480, 512, 128)    # (H, W, C, Cout) of the w64 frame's K3 block
W64_DEC_0 = (136, 240, 1024, 512)   # ... and of its K5 block
W64_NHWC_WANT = {"fused_scrub_standardize": 1, "fused_conv_block_nhwc": 3,
                 "fused_conv_block_chw": 3, "fused_block_int8_nhwc": 1,
                 "fused_block_int8_kchunked": 1, "fused_block128_nhwc": 1,
                 "fused_mask_to_u8": 1}
W64_CHW_WANT = {"fused_scrub_standardize": 1, "fused_conv_block_chw": 4,
                "fused_block_int8_nhwc": 1, "fused_block_int8_kchunked": 1,
                "fused_mask_to_u8": 1}


def serve_files(root: str, codec: str):
    """``SERVE_FRAMES`` renderer-plausible 1920×1080 frames (the content of
    ``scripts/bench_serve.py::make_frames``: smooth G-buffer fields, which
    compress as renders do) written as ``codec`` EXRs by the port's
    ``write_exr``, and ``SERVE_FILES`` files to serve, file j a link to
    frame j mod 8.  → (the source paths, the served paths, each source frame
    as it decodes)."""
    from pcss_unet_tpu_torch.io.exr import read_exr_stack, write_exr

    src, served = os.path.join(root, codec, "src"), os.path.join(root, codec, "serve")
    os.makedirs(src)
    os.makedirs(served)
    h, w = W64_H, W64_W
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sources = []
    for i in range(SERVE_FRAMES):
        base = np.sin(xx / (40 + i) + i) * np.cos(yy / (60 + i))
        chans = {
            "R": (base + 0.05 * rng.standard_normal((h, w))).astype(np.float32),
            "G": (base * 0.5 + 0.3).astype(np.float32),
            "B": (xx / w + 0.02 * rng.standard_normal((h, w))).astype(np.float32),
            "A": np.ones((h, w), np.float32),
        }
        sources.append(os.path.join(src, f"f{i:04d}.exr"))
        write_exr(sources[-1], chans, compression=codec)
    paths = []
    for j in range(SERVE_FILES):
        paths.append(os.path.join(served, f"f{j:04d}.exr"))
        os.link(sources[j % SERVE_FRAMES], paths[-1])
    return sources, paths, [read_exr_stack(p) for p in sources]


def batch_codes(engine, frames):
    """``render_u8`` of the padded batch, cropped: uint8 [N, H, W, 1]."""
    from pcss_unet_tpu_torch.infer import pad_to_multiple

    padded, (h, w) = pad_to_multiple(np.stack(frames), engine.pad_multiple)
    return engine.render_u8(padded).cpu().numpy()[:, :h, :w]


def serve_phase(engine, root, card):
    """The streaming server on the w64 NHWC fused+int8 engine (bf16):
    DWAA and PIZ files at (batch, decode workers) = (1, 4) and (4, 8), each
    run after a warm forward of its batch shape, with the launch counters
    zeroed just before and read just after (``W64_NHWC_WANT`` per batch).
    One line per run with ``scripts/bench_serve.py``'s fields.  Every served
    mask must equal ``render_u8`` of the same padded batch (the sink sees
    the batches in order), code for code; against the same frame at N = 1
    the difference is printed, not gated (the int8 postures are not
    continuous).  → (the launch counts of every run, the DWAA sources and
    their decoded frames)."""
    import torch

    from pcss_unet_tpu_torch.infer import ShadowServer
    from pcss_unet_tpu_torch.io.exr import read_exr_stack
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    runs, kept = [], {}
    for codec in ("DWAA", "PIZ"):
        t0 = time.perf_counter()
        sources, paths, decoded = serve_files(root, codec)
        write_s = time.perf_counter() - t0
        kept[codec] = (sources, decoded)
        frame_of = {p: j % SERVE_FRAMES for j, p in enumerate(paths)}
        at_n1 = {}
        for batch, workers in SERVE_RUNS:
            batch_codes(engine, decoded[:1] * batch)          # warm
            torch.cuda.synchronize()
            got, order = {}, []

            def sink(p, m):
                got[p] = m
                order.append(p)
            server = ShadowServer(engine, batch_size=batch, decode_workers=workers)
            reset_launch_counts()
            stats = server.run(paths, sink)
            launches = launch_counts()
            n_batches = -(-len(paths) // batch)
            t0 = time.perf_counter()
            for p in paths[:16]:
                read_exr_stack(p)
            decode_fps = 16 / (time.perf_counter() - t0) * workers
            compute_fps = stats.frames / max(stats.compute_seconds
                                             + stats.sync_seconds, 1e-9)
            differing, n1_diff, n1_pixels = 0, 0, 0
            for b in range(0, len(order), batch):
                group = order[b:b + batch]
                want = batch_codes(engine, [decoded[frame_of[p]] for p in group])
                for k, p in enumerate(group):
                    differing += int((got[p] != want[k]).sum())
                    if batch == 1:
                        at_n1[frame_of[p]] = got[p]
                    else:
                        d = np.abs(got[p].astype(int) - at_n1[frame_of[p]].astype(int))
                        n1_diff, n1_pixels = max(n1_diff, int(d.max())), n1_pixels + int((d > 0).sum())
            line = {"phase": "serve", "metric": "serve_e2e_fps", "value": stats.fps,
                    "unit": "frames/sec", "frame": f"{W64_W}x{W64_H}",
                    "compression": codec, "batch": batch, "decode_workers": workers,
                    "frames": stats.frames, "distinct_frames": SERVE_FRAMES,
                    "p50_ms": stats.p50_ms, "p99_ms": stats.p99_ms,
                    "decode_s": stats.decode_seconds, "dispatch_s": stats.compute_seconds,
                    "sync_s": stats.sync_seconds, "wall_s": stats.wall_seconds,
                    "decode_only_fps_ceiling": decode_fps, "compute_side_fps": compute_fps,
                    "pipeline_efficiency_vs_ceiling": stats.fps / min(decode_fps, compute_fps),
                    "launches_per_batch": {k: v / n_batches for k, v in launches.items() if v},
                    "codes_differing_from_render_u8": differing,
                    "exr_write_s": write_s, "card": card}
            if batch > 1:
                line.update(max_code_diff_vs_n1=n1_diff, pixels_differing_vs_n1=n1_pixels)
            emit(line)
            bad = {k: v for k, v in launches.items()
                   if v != W64_NHWC_WANT.get(k, 0) * n_batches}
            if stats.frames != SERVE_FILES or differing or bad or len(got) != SERVE_FILES:
                raise AssertionError(f"serve {codec} batch {batch}: frames "
                                     f"{stats.frames}, codes differing {differing}, "
                                     f"launches {launches}")
            runs.append(launches)
    return runs, kept["DWAA"]


def serve_cli_phase(root, engine, variables, stats, sources, decoded, card):
    """``python -m pcss_unet_tpu_torch serve`` in process (the dispatcher,
    ``sys.argv`` patched) on the 8 DWAA frames, with ``--quantize int8
    --batch 4 --decode_workers 1`` (one worker: the batches are the sorted
    files in fours) and the w64 seeded weights saved as a reference-named
    ``.npz``.  Launch counters zeroed just before and read just after (two
    batches).  Every PNG's codes must equal ``render_u8`` of the same batch
    of the engine the phase ``serve`` ran.  → the launch counts."""
    import pcss_unet_tpu_torch.__main__ as pmain
    from pcss_unet_tpu_torch.models.torch_import import export_to_torch_state_dict
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    os.makedirs(root)
    weights, out = os.path.join(root, "w64.npz"), os.path.join(root, "masks")
    np.savez(weights, **export_to_torch_state_dict(variables))
    np.save(os.path.join(root, "train_stats.npy"),
            {"means": stats["means"].tolist(), "stds": stats["stds"].tolist()},
            allow_pickle=True)
    argv = ["pcss_unet_tpu_torch", "serve", "--frames_dir", os.path.dirname(sources[0]),
            "--out_dir", out, "--weights", weights, "--stats_dir", root,
            "--quantize", "int8", "--batch", "4", "--decode_workers", "1"]
    saved, sys.argv = sys.argv, argv
    try:
        reset_launch_counts()
        res = pmain.main()
        launches = launch_counts()
    finally:
        sys.argv = saved
    st = res["stats"]
    differing = 0
    for b in range(0, len(sources), 4):
        want = batch_codes(engine, decoded[b:b + 4])
        for k, src in enumerate(sources[b:b + 4]):
            name = os.path.splitext(os.path.basename(src))[0] + ".png"
            differing += int((read_png(os.path.join(out, name)) != want[k][..., 0]).sum())
    line = {"phase": "serve_cli", "frames": st.frames, "fps": st.fps,
            "wall_s": st.wall_seconds, "png_write_s": res["write_seconds"],
            "png_write_share_of_wall": res["write_seconds"] / st.wall_seconds,
            "p50_ms": st.p50_ms, "p99_ms": st.p99_ms, "launches": launches,
            "png_codes_differing_from_render_u8": differing, "card": card}
    emit(line)
    bad = {k: v for k, v in launches.items() if v != W64_NHWC_WANT.get(k, 0) * 2}
    if st.frames != len(sources) or differing or bad:
        raise AssertionError(f"serve_cli: {line}")
    return launches


def export_phase(variables, kw, frames, engine_bf16, card):
    """The w64 serving engine's plain graph exported by ``torch.export`` at
    1088×1920, batch 1, on the card, and loaded from bytes: in float32 with
    TF32 off within 1e-6 of ``run_padded(x, plain=True)`` (the JAX suite's
    tolerance; the trace holds the banded resize's plain version, which
    equals the eager kernel bit for bit); the bf16 export against the
    kernel path (the same engine's ``run_padded``), reported with both ms
    per frame (CUDA events)."""
    import torch

    from pcss_unet_tpu_torch.infer import (InferenceEngine, export_inference,
                                           load_exported)

    h, w = frames.shape[1:3]
    with torch.inference_mode(False), no_tf32():
        e32 = InferenceEngine(None, variables, layout="nhwc",
                              **dict(kw, dtype=torch.float32))
        t0 = time.perf_counter()
        blob32 = export_inference(e32, h, w, batch=1)
        export_s = time.perf_counter() - t0
        fn32 = load_exported(blob32)
        d32 = (fn32(frames) - e32.run_padded(frames, plain=True)).abs().max().item()
        del e32, fn32
        blob16 = export_inference(engine_bf16, h, w, batch=1)
        fn16 = load_exported(blob16)
        kernel_path = engine_bf16.run_padded(frames)
        d16 = (fn16(frames) - kernel_path).abs().max().item()
        ms16 = cuda_ms(lambda: fn16(frames), iters=10)
        ms_kernels = cuda_ms(lambda: engine_bf16.run_padded(frames), iters=10)
    line = {"phase": "export", "frame_hw": [h, w], "torch": torch.__version__,
            "blob_bytes_f32": len(blob32), "blob_bytes_bf16": len(blob16),
            "export_s_f32": export_s, "max_abs_err_f32_vs_plain": d32, "tol_f32": 1e-6,
            "max_abs_err_bf16_vs_kernel_path": d16,
            "ms_per_frame_bf16_export": ms16, "ms_per_frame_bf16_kernel_path": ms_kernels,
            "card": card}
    emit(line)
    if not d32 <= 1e-6:
        raise AssertionError(f"export float32: {line}")


# -------------------------------------------------- bench, inspect, parity
K2, K2N, K3, K5, K6 = ("fused_conv_block_chw", "fused_conv_block_nhwc",
                       "fused_block_int8_nhwc", "fused_block_int8_kchunked",
                       "fused_block128_nhwc")
# per forward, (net, posture) -> kernel -> launches (0 where absent); K2′
# launches K2 and counts on K2's counter too.  w16 fused_int8's K2′ and K6
# counts, which the reference's gates leave to the kernels' shape picks,
# are those the first card run recorded (dec_1 at 128 -> 32 takes no K6)
BENCH_WANT = {
    ("w64", "plain"): {},
    ("w64", "fused"): {K2N: 3, K2: 3, K6: 1},
    ("w64", "fused_int8"): {K2N: 3, K2: 3, K3: 1, K5: 1, K6: 1},
    ("w64", "chw"): {K2: 4},
    ("w64", "chw_int8"): {K2: 4, K3: 1, K5: 1},
    ("w16", "chw"): {K2: 6},
    ("w16", "chw_int8"): {K2: 6, K3: 1},
    ("w16", "fused_int8"): {K2N: 5, K2: 5, K3: 1},
}


PROFILED_STREAM = 8     # forwards in the bench phase's profiled stream


def stream_profile(apply_fn, params, x, n: int) -> dict:
    """One bench stream of ``n`` forwards (``benchlib.make_stream``, after
    one warm stream), per forward: the host's time to enqueue it (the
    stream's call, before the synchronisation), its CUDA-event time, and
    its device busy time under torch.profiler (a second dispatch).  A
    stream is host-bound where the device idles inside it: busy share
    (busy / event time) well below 1.  Enqueue ≈ event time alone says
    nothing where the launch queue fills and the host waits on it."""
    import torch

    from pcss_unet_tpu_torch.utils import benchlib

    stream = benchlib.make_stream(apply_fn, params, {}, n)
    stream(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    stream(x)
    enqueue = (time.perf_counter() - t) * 1e3
    stop.record()
    stop.synchronize()
    elapsed = start.elapsed_time(stop)
    summed, _ = device_events(lambda: stream(x))
    busy = sum(dev_ms(e) for e in summed)
    return {"stream_forwards": n, "stream_enqueue_ms_per_forward": enqueue / n,
            "stream_event_ms_per_forward": elapsed / n,
            "stream_busy_ms_per_forward": busy / n, "stream_busy_share": busy / elapsed}


def bench_phase(card: str) -> dict:
    """``python -m pcss_unet_tpu_torch.bench`` in process (its ``REPEATS``
    measurements of each configuration at ``SCAN`` and ``REPS``): one line
    per configuration, then the bench's own JSON line.  The bench reads
    the kernels' counters around each measurement; every configuration's
    launches per forward must be ``BENCH_WANT``'s.  Then one stream of
    ``PROFILED_STREAM`` forwards per configuration, profiled
    (``stream_profile``: whether the device idles inside a stream).  → the launches of the
    bench's run (counters zeroed just before it)."""
    import torch

    from pcss_unet_tpu_torch import bench
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    state_before = card_state()
    t0 = time.perf_counter()
    result = bench.main([])
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    state_after = card_state()
    built = bench.build("cuda")
    bad = []
    for cfg in bench.CONFIGS:
        row = result["postures"][cfg.name]
        want = {k: float(v) for k, v in BENCH_WANT[cfg.net, cfg.impl].items()}
        if row["launches_per_forward"] != want:
            bad.append((cfg.name, row["launches_per_forward"]))
        emit({"phase": "bench", "configuration": cfg.name,
              **{k: row[k] for k in ("impl", "frame", "batch", "median_ms", "min_ms",
                                     "max_ms", "spread", "runs_ms", "scan_lo",
                                     "scan_hi", "reps", "forwards",
                                     "launches_per_forward")},
              "repeats": result["repeats"], "launches_per_forward_want": want,
              **stream_profile(*built[cfg.name], PROFILED_STREAM),
              "card": card})
    emit({"phase": "bench_seconds", "seconds": seconds, "launches": launches,
          "card_state_before_after": [state_before, state_after],
          "card_state_fields": "clocks.sm, clocks.max.sm, power.draw, "
                               "temperature.gpu"})
    if bad:
        raise AssertionError(f"bench: launches per forward other than "
                             f"BENCH_WANT's: {bad[:4]}")
    return launches


INSPECT_STAGES = ["enc_0", "enc_1", "enc_2", "enc_3", "dec_0", "dec_1", "dec_2",
                  "dec_final", "full_model"]


def inspect_phase(card: str) -> None:
    """``python -m pcss_unet_tpu_torch inspect --config config.ini --memory
    --latency --dot …`` in process: the w64 net at 2048×1024 on the card;
    its rows ``enc_0`` … ``dec_final``, ``full_model``, and a DOT graph."""
    import torch

    fd, dot = tempfile.mkstemp(suffix=".dot", dir=os.path.join(REPO, "build"))
    os.close(fd)
    try:
        t0 = time.perf_counter()
        with torch.inference_mode(False):
            report, code = dispatch(["inspect", "--config",
                                     os.path.join(REPO, "config.ini"), "--memory",
                                     "--latency", "--dot", dot])
        seconds = time.perf_counter() - t0
        with open(dot) as f:
            text = f.read()
    finally:
        os.remove(dot)
    rows = [{"stage": r["stage"], "ms": r["seconds"] * 1e3,
             **{k: list(r[k]) if k == "shape" else r[k]
                for k in ("shape", "out_ch", "flops", "tf32") if k in r}}
            for r in report or []]
    line = {"phase": "inspect", "exit_code": code, "rows": rows,
            "dot_bytes": len(text), "dot_nodes": text.count("label="),
            "seconds": seconds, "card": card}
    emit(line)
    if (code != 0 or [r["stage"] for r in rows] != INSPECT_STAGES
            or not text.startswith("digraph")):
        raise AssertionError(f"inspect: {line}")


PARITY_HW = (1088, 1920)
PARITY_TOL = 1e-4   # max |d| of the float32 plain UNet (1.49e-6 measured); the
                    # bf16 int8 engines' RMS error is ~1e-4 at their 80-82 dB


def psnr_db(a, b) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-12))


def parity_ref_phase(card: str) -> None:
    """The reference's torch U-Net (``parity.make_torch_reference``, w64,
    torch seed 0, non-trivial BatchNorm statistics as
    ``tests/test_model_parity.py`` seeds them) on the card in float32 with
    TF32 off at 1088×1920: the port's plain ``UNet`` loaded from its state
    dict through ``models.torch_import`` must reach PSNR > 50 dB (the JAX
    test's bar) and max |d| ≤ ``PARITY_TOL``: the seeded mask sits near
    0.5, where PSNR alone passes a bf16 net.  Each error is also given
    against the reference mask's own spread (max |d| / its max deviation
    from its mean).  The two bf16 int8 engines are reported against it
    (not gated: the seeded int8 postures are not continuous in their
    input)."""
    import torch

    from pcss_unet_tpu_torch.infer import InferenceEngine
    from pcss_unet_tpu_torch.models.torch_import import convert_torch_state_dict
    from pcss_unet_tpu_torch.models.unet import unet_for_variables
    from pcss_unet_tpu_torch.parity import make_torch_reference

    torch.manual_seed(0)
    ref = make_torch_reference()
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.05)
                mod.running_var.uniform_(0.8, 1.2)
    ref = ref.eval().cuda()
    variables = convert_torch_state_dict(
        {k: v.cpu().numpy() for k, v in ref.state_dict().items()})
    x = np.random.default_rng(0).standard_normal((1, *PARITY_HW, 4))
    xt = torch.from_numpy(x.astype(np.float32)).cuda()
    with no_tf32():
        want = ref(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        outs = {"plain_f32": unet_for_variables(variables, device="cuda")(xt)}
    for layout in ("nhwc", "chw"):
        engine = InferenceEngine(None, variables, layout=layout, fold_bn=True,
                                 quantize="int8", dtype=torch.bfloat16, device="cuda")
        outs[f"{layout}_int8_bf16"] = engine.run_padded(xt)
    spread = (want - want.mean()).abs().max().item()
    line = {"phase": "parity_ref", "frame_hw": list(xt.shape[1:3]),
            "min_psnr_db": 50.0, "max_abs_err_tol_plain_f32": PARITY_TOL,
            "ref_mean": want.mean().item(), "ref_max_dev_from_mean": spread}
    for name, got in outs.items():
        err = (got.float() - want).abs().max().item()
        line.update({f"psnr_db_{name}": psnr_db(got, want), f"max_abs_err_{name}": err,
                     f"rel_err_{name}": err / spread})
    line["card"] = card
    emit(line)
    if not (line["psnr_db_plain_f32"] > 50.0
            and line["max_abs_err_plain_f32"] <= PARITY_TOL):
        raise AssertionError(f"parity_ref: {line}")


# ------------------------------------------------------------------ training
# synthetic 2048×1024 packs: 8 val frames, since the CLI validates in
# batches of batch_size (8) and drops a remainder, as the JAX CLI does
TRAIN_FRAMES, VAL_FRAMES = 16, 8
DEVICE = "cuda"                        # the training phases' device
BENCH_WARM, BENCH_STEPS = 3, 10
BENCH_CONFIGS = (                      # scripts/bench_train.py:28-39
    ("256crop_b8_standard", 8, 256, 256, "standard"),
    ("256crop_b8_perturb", 8, 256, 256, "perturb"),
    ("2k_b8_standard", 8, FRAME_H, FRAME_W, "standard"))


def gbuffer(rng, i: int, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """A renderer-plausible G-buffer frame [h, w, 4] (the serve phase's
    content: smooth fields, a little noise) and a learnable soft shadow
    [h, w, 1]: a sigmoid of a smooth function of the channels."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.sin(xx / (40 + i) + i) * np.cos(yy / (60 + i))
    x = np.empty((h, w, 4), np.float32)
    x[..., 0] = base + 0.05 * rng.standard_normal((h, w))
    x[..., 1] = base * 0.5 + 0.3
    x[..., 2] = xx / w + 0.02 * rng.standard_normal((h, w))
    x[..., 3] = 1.0
    y = 1.0 / (1.0 + np.exp(-6.0 * (x[..., 0] - x[..., 2] + 0.25)))
    return x, y[..., None].astype(np.float32)


def write_packs(root: str) -> dict:
    """16 train and 8 val 2048×1024 frames as NHWC float32 ``.npy`` packs
    and the train split's ``train_stats.npy``, from seed 0."""
    os.makedirs(root)
    rng = np.random.default_rng(0)
    frames = [gbuffer(rng, i, FRAME_H, FRAME_W) for i in range(TRAIN_FRAMES + VAL_FRAMES)]
    x = np.stack([f[0] for f in frames])
    y = np.stack([f[1] for f in frames])
    for split, sl in (("train", slice(0, TRAIN_FRAMES)), ("val", slice(TRAIN_FRAMES, None))):
        np.save(os.path.join(root, f"{split}_inputs.npy"), x[sl])
        np.save(os.path.join(root, f"{split}_labels.npy"), y[sl])
    stats = {"means": x[:TRAIN_FRAMES].mean(axis=(0, 1, 2), dtype=np.float64).astype(np.float32),
             "stds": x[:TRAIN_FRAMES].std(axis=(0, 1, 2), dtype=np.float64).astype(np.float32)}
    np.save(os.path.join(root, "train_stats.npy"), stats)
    return stats


def timed_step_builder(loop_mod, records):
    """``build_train_step`` whose steps are timed (CUDA-synchronised) and
    whose metrics are read back, one record per step."""
    import torch

    real = loop_mod.build_train_step

    def build(*a, **k):
        step = real(*a, **k)

        def timed(state, x, y, gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, x, y, gen)
            torch.cuda.synchronize()
            records.append({"ms": (time.perf_counter() - t0) * 1e3,
                            **{k: float(v) for k, v in m.items()
                               if not k.startswith("grad_norm/")}})
            return m
        return timed
    return build


def train_phase(work: str, card: str):
    """``python -m pcss_unet_tpu_torch train`` in process at the reference
    config (config.ini: w64, batch 8 of 2048×1024, adamw, bf16) with
    ``--loss_type perturb --allow_random_vgg --num_epochs 2``, then
    ``--num_epochs 3``, which resumes.  → (the export of the trained net,
    the train stats)."""
    import torch

    from pcss_unet_tpu_torch.cli import train as cli_train
    from pcss_unet_tpu_torch.train import checkpoint as ckm
    from pcss_unet_tpu_torch.train import loop

    t_start = time.perf_counter()
    data, ck = os.path.join(work, "data"), os.path.join(work, "ckpt")
    stats = write_packs(data)
    pack_s = time.perf_counter() - t_start
    argv = ["--config", os.path.join(REPO, "config.ini"), "--loss_type", "perturb",
            "--allow_random_vgg", "--processed_data_dir", data, "--save_dir", ck,
            "--device", DEVICE]
    cwd = os.getcwd()
    os.chdir(work)                 # config.ini's log_dir=./logs: the work dir's
    try:
        for accum in (1, 2, 4):
            records = []
            torch.cuda.reset_peak_memory_stats()
            try:
                with swapped([(loop, "build_train_step", timed_step_builder(loop, records))]):
                    r1 = cli_train.main(argv + ["--num_epochs", "2",
                                                "--grad_accum_steps", str(accum)])
                break
            except torch.cuda.OutOfMemoryError as e:
                emit({"phase": "train_oom", "grad_accum_steps": accum,
                      "error": str(e).splitlines()[0][:200]})
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(ck, ignore_errors=True)
        else:
            raise AssertionError("train: batch 8 at 2048x1024 does not fit at "
                                 "grad_accum_steps 1, 2 or 4")
        peak = (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())
        ms = [r["ms"] for r in records[1:]]
        bad = [r for r in records if r["skipped"] != 0 or not all(
            math.isfinite(r[k]) for k in ("l1_loss", "vgg_loss", "perturbation_loss",
                                          "total_loss", "grad_norm"))]
        files = sorted(f for f in os.listdir(ck) if f.endswith(".pt"))
        with open(os.path.join(ck, "checkpoints.json")) as f:
            index = json.load(f)
        saved = torch.load(os.path.join(ck, "ckpt_1000.pt"), weights_only=True)
        model = r1.state.model
        final_eq = all(torch.equal(p.detach().cpu(), saved["params"][n])
                       for n, p in model.named_parameters())
        line = {"phase": "train", "card": card, "config": "config.ini",
                "loss_type": "perturb", "batch": 8, "frame_hw": [FRAME_H, FRAME_W],
                "grad_accum_steps": accum, "steps": len(records),
                "step_ms": [r["ms"] for r in records], "ms_per_step_median": float(np.median(ms)),
                "steps_per_s": 1e3 / float(np.median(ms)),
                "samples_per_s": 8e3 / float(np.median(ms)),
                "peak_allocated_gb": peak[0] / 1e9, "peak_reserved_gb": peak[1] / 1e9,
                "losses": [{k: r[k] for k in ("total_loss", "l1_loss", "vgg_loss",
                                              "perturbation_loss", "grad_norm",
                                              "clip_max_norm")} for r in records],
                "history": r1.history, "checkpoints": files, "index": index,
                "saved_equals_final": final_eq, "packs_s": pack_s}
        del r1, model, saved
        gc.collect()
        emit(line)
        if (len(records) != 4 or bad or files != ["ckpt_0.pt", "ckpt_1000.pt"]
                or not all(h["val"] for h in line["history"]) or not final_eq
                or any(v is None or "val_loss" not in v for v in index.values())):
            raise AssertionError(f"train: steps {len(records)}, bad {bad}, "
                                 f"checkpoints {files} {index}, saved==final {final_eq}")

        # resume: epoch 2 from the epoch-1 checkpoint at step 4, bit for bit
        restored = {}
        real_restore = ckm.CheckpointManager.restore

        def restore(self, state, epoch=None):
            state, cursor = real_restore(self, state, epoch)
            restored.update(step=int(state.step), cursor=cursor, params={
                n: p.detach().cpu().clone() for n, p in state.model.named_parameters()})
            return state, cursor

        records2 = []
        with swapped([(loop, "build_train_step", timed_step_builder(loop, records2)),
                      (ckm.CheckpointManager, "restore", restore)]):
            r2 = cli_train.main(argv + ["--num_epochs", "3",
                                        "--grad_accum_steps", str(accum)])
        saved = torch.load(os.path.join(ck, "ckpt_1000.pt"), weights_only=True)
        exact = all(torch.equal(restored["params"][n], saved["params"][n])
                    for n in saved["params"])
        resume = {"phase": "train_resume", "restored_step": restored.get("step"),
                  "cursor": restored.get("cursor"),
                  "epochs": [h["epoch"] for h in r2.history],
                  "final_step": int(r2.state.step), "restored_params_exact": exact,
                  "steps": len(records2), "step_ms": [r["ms"] for r in records2],
                  "skipped": int(r2.state.skipped_steps),
                  "losses": [r["total_loss"] for r in records2]}
        emit(resume)
        if (resume["restored_step"] != 4 or resume["epochs"] != [2] or not exact
                or resume["final_step"] != 6 or resume["skipped"] != 0):
            raise AssertionError(f"train resume: {resume}")
        from pcss_unet_tpu_torch.train.checkpoint import export_reference_checkpoint

        npz = os.path.join(work, "trained_w64.npz")
        export_reference_checkpoint(r2.state, npz)
        del r2, saved, restored
    finally:
        os.chdir(cwd)
        gc.collect()
        torch.cuda.empty_cache()
    return npz, stats, time.perf_counter() - t_start


def bench_state(cfg, hw_batch, loss_type, seed=0):
    """A w64 bf16 train state, its step and a device batch."""
    import torch

    from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
    from pcss_unet_tpu_torch.models.init import init_train_weights
    from pcss_unet_tpu_torch.models.unet import unet_from_config
    from pcss_unet_tpu_torch.train import build_train_step, create_train_state

    model = init_train_weights(unet_from_config(cfg, device="cpu"),
                               torch.Generator().manual_seed(seed)).to(DEVICE).train()
    state = create_train_state(model, cfg, 100)
    bundle = LossBundle(perceptual=PerceptualLoss(None, device=DEVICE),
                        alpha=cfg.alpha, perturb_weight=cfg.perturb_weight,
                        perturbation_count=cfg.perturbation_count)
    step = build_train_step(cfg, bundle, np.zeros(4, np.float32),
                            np.ones(4, np.float32), 100, per_block_norms=False)
    b, h, w = hw_batch
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, 4)).astype(np.float32)
    y = (x.mean(axis=-1, keepdims=True) > 0).astype(np.float32)
    return state, step, torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)


def train_bench_phase(card: str) -> float:
    """The JAX train bench's configs on the card (w64 bf16, adamw,
    config.ini's settings): steps/s as the median of 10 CUDA-synchronised
    steps after 3 warm ones, peak memory; 2048×1024 at the smallest
    grad_accum_steps that fits.  Then the overfit check: 30 steps on one
    fixed 256² batch of 8, warmup 0, dropout 0 — the loss must fall."""
    import torch

    from pcss_unet_tpu_torch.config import load_config

    t0 = time.perf_counter()
    base = load_config(os.path.join(REPO, "config.ini")).replace(num_epochs=100)
    for tag, b, h, w, loss_type in BENCH_CONFIGS:
        for accum in (1, 2, 4, 8):
            cfg = base.replace(loss_type=loss_type, grad_accum_steps=accum)
            torch.cuda.reset_peak_memory_stats()
            try:
                state, step, x, y = bench_state(cfg, (b, h, w), loss_type)
                gen = torch.Generator(DEVICE).manual_seed(0)
                times = []
                for i in range(BENCH_WARM + BENCH_STEPS):
                    torch.cuda.synchronize()
                    ts = time.perf_counter()
                    m = step(state, x, y, gen)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - ts) * 1e3)
                loss, skipped = float(m["total_loss"]), int(state.skipped_steps)
                break
            except torch.cuda.OutOfMemoryError:
                emit({"phase": "train_bench_oom", "config": tag, "grad_accum_steps": accum})
            finally:
                state = step = x = y = None
                gc.collect()
                torch.cuda.empty_cache()
        else:
            raise AssertionError(f"train_bench {tag}: no grad_accum_steps fits")
        med = float(np.median(times[BENCH_WARM:]))
        if DEVICE == "cuda":
            # one more step under torch.profiler: device busy time against
            # the step's wall time, and the largest device items
            state, step, x, y = bench_state(cfg, (b, h, w), loss_type)
            step(state, x, y, gen)
            summed, _ = device_events(lambda: step(state, x, y, gen))
            busy = sum(dev_ms(e) for e in summed)
            emit({"phase": "train_profile", "config": tag, "step_ms": med,
                  "device_busy_ms": busy, "idle_share": 1.0 - busy / med,
                  "device_launches": sum(e.count for e in summed),
                  "top_device_ms": [[e.key[:70], dev_ms(e), e.count] for e in
                                    sorted(summed, key=dev_ms, reverse=True)[:20]]})
            state = step = x = y = None
            gc.collect()
            torch.cuda.empty_cache()
        line = {"phase": "train_bench", "config": tag, "card": card, "batch": b,
                "hw": [h, w], "loss_type": loss_type, "grad_accum_steps": accum,
                "ms_per_step_median": med, "steps_per_s": 1e3 / med,
                "samples_per_s": b * 1e3 / med, "step_ms": times,
                "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                "last_loss": loss, "skipped": skipped}
        emit(line)
        if skipped or not math.isfinite(loss):
            raise AssertionError(f"train_bench {tag}: {line}")

    cfg = base.replace(loss_type="standard", warmup_epochs=0, dropout_rate=0.0)
    state, step, x, y = bench_state(cfg, (8, 256, 256), "standard", seed=1)
    losses = [float(step(state, x, y)["total_loss"]) for _ in range(30)]
    emit({"phase": "train_overfit", "steps": 30, "first_loss": losses[0],
          "last_loss": losses[-1], "losses": losses})
    del state, step, x, y
    gc.collect()
    torch.cuda.empty_cache()
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_overfit: loss {losses[0]} -> {losses[-1]}")
    return time.perf_counter() - t0


def train_parity_phase() -> float:
    """The port's train step on the card and on the CPU, float32 with TF32
    off, w64 widths, batch 2 at 128×128, dropout 0, adamw, 3 steps from the
    same weights on the same batches: losses within 1e-4 relative, each
    parameter's change along the same direction (cosine > 0.995, norm
    within 2 %: tests/test_train_parity.py's criteria for Adam, whose first
    steps are sign-like), and each BatchNorm running statistic's change by
    the same criteria (it follows the parameters, so it diverges with
    them).  The conv biases in front of a BatchNorm have a zero true
    gradient: only their size is held (< 1e-3)."""
    import torch

    from pcss_unet_tpu_torch.config import Config
    from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
    from pcss_unet_tpu_torch.models.init import init_train_weights
    from pcss_unet_tpu_torch.models.unet import UNet
    from pcss_unet_tpu_torch.train import build_train_step, create_train_state

    t0 = time.perf_counter()
    cfg = Config(batch_size=2, num_epochs=4, warmup_epochs=1, dropout_rate=0.0,
                 compute_dtype="float32")
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((2, 128, 128, 4)).astype(np.float32),
                rng.random((2, 128, 128, 1), dtype=np.float32)) for _ in range(3)]
    runs = {}
    with no_tf32():
        for dev in (DEVICE, "cpu"):
            model = init_train_weights(UNet(encoder_widths=W64, dropout_rate=0.0),
                                       torch.Generator().manual_seed(0)).to(dev).train()
            before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            state = create_train_state(model, cfg, 4)
            step = build_train_step(cfg, LossBundle(perceptual=PerceptualLoss(None, device=dev)),
                                    np.zeros(4, np.float32), np.ones(4, np.float32), 4)
            losses = [float(step(state, torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev))["total_loss"])
                      for x, y in batches]
            runs[dev] = (losses, {n: (p.detach().cpu() - before[n]).double().numpy().ravel()
                                  for n, p in model.named_parameters()},
                         {n: (b.detach().cpu().double() - float("var" in n)).numpy().ravel()
                          for n, b in model.named_buffers() if "running" in n})
    (cl, cd, cs), (hl, hd, hs) = runs[DEVICE], runs["cpu"]
    worst_cos, worst_ratio, bias_max = 1.0, 0.0, 0.0
    for name in hd:
        a, b = cd[name], hd[name]
        if re.search(r"\.conv_[ab]\.bias$", name):
            bias_max = max(bias_max, float(np.abs(a).max()), float(np.abs(b).max()))
            continue
        worst_cos = min(worst_cos, float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
        worst_ratio = max(worst_ratio, abs(float(np.linalg.norm(a) / np.linalg.norm(b)) - 1))
    stat_cos = min(float(cs[n] @ hs[n] / (np.linalg.norm(cs[n]) * np.linalg.norm(hs[n])))
                   for n in hs)
    stat_ratio = max(abs(float(np.linalg.norm(cs[n]) / np.linalg.norm(hs[n])) - 1)
                     for n in hs)
    loss_rel = max(abs(a / b - 1) for a, b in zip(cl, hl))
    line = {"phase": "train_parity", "widths": list(W64), "batch": 2, "hw": [128, 128],
            "dtype": "float32", "tf32": False, "steps": 3, "loss_card": cl, "loss_cpu": hl,
            "loss_max_rel": loss_rel, "delta_worst_cos": worst_cos,
            "delta_worst_norm_ratio_err": worst_ratio,
            "pre_bn_bias_delta_max": bias_max, "bn_stat_change_worst_cos": stat_cos,
            "bn_stat_change_worst_norm_ratio_err": stat_ratio,
            "tol": {"loss_rel": 1e-4, "cos": 0.995, "norm_ratio": 2e-2,
                    "pre_bn_bias": 1e-3}}
    emit(line)
    if not (loss_rel <= 1e-4 and min(worst_cos, stat_cos) > 0.995
            and max(worst_ratio, stat_ratio) < 2e-2 and bias_max < 1e-3):
        raise AssertionError(f"train_parity: {line}")
    return time.perf_counter() - t0


def storage(t) -> str:
    import torch

    if t.is_contiguous():
        return "nchw"
    return "channels_last" if t.is_contiguous(memory_format=torch.channels_last) else \
        f"strides {list(t.stride())}"


def bf16_bound_err(got, want, roundings=1) -> tuple[float, float, float]:
    """(max |d|, the largest |d| over its bound: ``roundings`` bf16
    roundings of the value plus 1e-5 of the largest value (sum-order noise
    that cancels), the share of values that differ)."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    over = d / (roundings * 2 ** -7 * want.abs() + 1e-5 * want.abs().max() + 1e-30)
    return d.max().item(), over.max().item(), (d > 0).float().mean().item()


def bn_tail_phase(card: str, own) -> dict:
    """The train-mode BatchNorm tail (``ops/kernels/bn_train.py``) on the
    main path's inputs: one w64 bf16 ``forward_train`` and backward at
    batch 8 of 2048×1024, dropout 0.2 (config.ini's), records every call's
    conv output, mask and, in the backward, incoming gradient; then each
    call's kernels against the plain versions on those inputs.  Forward:
    the output codes within one bf16 rounding (two with the dropout's
    second; plus 1e-5 of the largest) of ``bn_act_dropout_plain``'s, the
    running statistics within 1e-5.  Backward, from the kernel forward's
    statistics:
    ``bn_act_dropout_backward_plain``'s dx within the same bound, dγ and dβ
    within 1e-4 of the largest.  One ``bn_tail_call`` line a call: the
    storage of x and of the incoming gradient (as the convolutions hand
    them over), wrapper ms from CUDA events (20 calls), device ms of the
    library's kernels (torch.profiler), plain ms, bound ms: bytes at 3.35
    TB/s, 6 an element forward, 10 backward.  Also the step's launches of
    the op (3 a conv output forward, 3 backward, and 3 a conv output of the
    checkpointed bottleneck's recompute) and every block's route."""
    import torch

    from pcss_unet_tpu_torch.models.unet import UNet
    from pcss_unet_tpu_torch.ops.kernels import bn_train as kbn
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    t0 = time.perf_counter()
    mine = {k for k in own if k.startswith("tail_") or k.endswith("_final_kernel")}
    torch.manual_seed(0)
    model = UNet(encoder_widths=W64, dropout_rate=0.2, dtype=torch.bfloat16).to(DEVICE).train()
    x = torch.from_numpy(np.stack([gbuffer(np.random.default_rng(i), i, FRAME_H, FRAME_W)[0]
                                   for i in range(8)])).to(DEVICE)
    masks = model.dropout_masks(8, torch.Generator(DEVICE).manual_seed(0), DEVICE)
    fwd_calls, bwd_calls = [], []
    orig_f, orig_b = kbn._forward, kbn._backward

    def clone(a):
        return a.detach().clone(memory_format=torch.preserve_format) if torch.is_tensor(a) else a

    def rec_f(*a):
        if not bwd_calls:                   # the recompute's calls are the forward's
            fwd_calls.append(tuple(map(clone, a)))
        return orig_f(*a)

    def rec_b(*a):
        bwd_calls.append(tuple(map(clone, a)))
        return orig_b(*a)

    names = [f"{b}.{c}" for b in model.blocks() for c in ("conv_a", "conv_b")]
    reset_launch_counts()
    with swapped([(kbn, "_forward", rec_f), (kbn, "_backward", rec_b)]):
        out, _ = model.forward_train(x, masks)
        fwd_launches = kbn.bn_act_dropout_train.launches
        torch.autograd.grad(out.mean(), list(model.parameters()))
    step_launches = kbn.bn_act_dropout_train.launches
    routes = model.routes()
    del model, out, x
    gc.collect()
    torch.cuda.empty_cache()
    want_launches = (3 * len(names), 3 * len(names) + 3 * len(names) + 3 * 2)
    if (set(routes.values()) != {"bn_act_dropout_train"} or len(fwd_calls) != len(names)
            or (fwd_launches, step_launches) != want_launches):
        raise AssertionError(f"bn_tail: routes {routes}, {len(fwd_calls)} forward calls, "
                             f"launches {fwd_launches}, {step_launches} (want {want_launches})")
    per = {"forward": [0.0] * 4, "backward": [0.0] * 4}   # ms, device ms, plain ms, bound ms
    worst = {"forward": 0.0, "backward": 0.0, "stats": 0.0, "dgamma_dbeta": 0.0}
    for name, a in zip(names, fwd_calls):
        got, stats = kbn._forward(*a)
        want, pstats = kbn.bn_act_dropout_plain(*a)
        # the dropout rounds twice: a flip of the first carries through
        d, over, share = bf16_bound_err(got, want, 1 if a[5] is None else 2)
        run_err = max(((stats[k] - pstats[k]).abs() / (1e-5 * pstats[k].abs() + 1e-6)).max().item()
                      for k in (4, 5))
        worst["forward"], worst["stats"] = max(worst["forward"], over), max(worst["stats"], run_err)
        xb = a[0]
        t = cuda_ms(lambda: kbn._forward(*a))
        td, *_ = kernel_device_ms(lambda: kbn._forward(*a), mine)
        tp = cuda_ms(lambda: kbn.bn_act_dropout_plain(*a), iters=3, warmup=1)
        b = 6 * xb.numel() / PEAK_BYTES_PER_S * 1e3
        for k, v in enumerate((t, td or 0.0, tp, b)):
            per["forward"][k] += v
        emit({"phase": "bn_tail_call", "pass": "forward", "call": name, "shape": list(xb.shape),
              "x_storage": storage(xb), "dropout": a[5] is not None, "ms": t, "device_ms": td,
              "plain_ms": tp, "bound_ms": b, "bound_by": "bytes", "device_bound_share":
              None if not td else b / td, "max_abs_err": d, "err_over_bound": over,
              "codes_differing": share, "running_err_over_1e-5": run_err})
        del got, stats, want, pstats
    for j, a in enumerate(bwd_calls):
        xb, g = a[0], a[1]
        dx, dw, db = kbn._backward(*a)
        pdx, pdw, pdb = kbn.bn_act_dropout_backward_plain(g, xb, *a[2:])
        d, over, share = bf16_bound_err(dx, pdx)
        gerr = max(((u - v).abs().max() / v.abs().max()).item() for u, v in ((dw, pdw), (db, pdb)))
        worst["backward"] = max(worst["backward"], over)
        worst["dgamma_dbeta"] = max(worst["dgamma_dbeta"], gerr)
        t = cuda_ms(lambda: kbn._backward(*a))
        td, *_ = kernel_device_ms(lambda: kbn._backward(*a), mine)
        tp = cuda_ms(lambda: kbn.bn_act_dropout_backward_plain(g, xb, *a[2:]), iters=3, warmup=1)
        b = 10 * xb.numel() / PEAK_BYTES_PER_S * 1e3
        for k, v in enumerate((t, td or 0.0, tp, b)):
            per["backward"][k] += v
        emit({"phase": "bn_tail_call", "pass": "backward", "call": j, "shape": list(xb.shape),
              "x_storage": storage(xb), "grad_storage": storage(g), "dropout": a[4] is not None,
              "ms": t, "device_ms": td, "plain_ms": tp, "bound_ms": b, "bound_by": "bytes",
              "device_bound_share": None if not td else b / td, "max_abs_err": d,
              "err_over_bound": over, "codes_differing": share, "dgamma_dbeta_rel_err": gerr})
        del dx, dw, db, pdx, pdw, pdb
    del fwd_calls, bwd_calls
    gc.collect()
    torch.cuda.empty_cache()
    line = {"phase": "bn_tail", "card": card, "path": "w64_train_b8",
            "routes": routes, "launches_forward": fwd_launches, "launches_step": step_launches,
            **{f"{p}_{k}": v[i] for p, v in per.items()
               for i, k in enumerate(("ms", "device_ms", "plain_ms", "bound_ms"))},
            "err_over_bound": worst, "seconds": time.perf_counter() - t0}
    emit(line)
    if max(worst["forward"], worst["backward"], worst["stats"]) > 1.0 or \
            worst["dgamma_dbeta"] > 1e-4:
        raise AssertionError(f"bn_tail: {worst}")
    return {"name": "bn_act_dropout_train", "route": "cuda",
            "source": "pcss_unet_tpu_torch/csrc/bn_train.cu",
            "replaces": "none (the plain batch_norm_train, activation, cast and where chain)",
            "launches": step_launches,
            **{k: line[k] for k in ("forward_ms", "forward_device_ms", "forward_plain_ms",
                                    "forward_bound_ms", "backward_ms", "backward_device_ms",
                                    "backward_plain_ms", "backward_bound_ms")}}


def train_to_serve_phase(npz, stats, data, plain, card, own):
    """The trained net (``export_reference_checkpoint``'s ``.npz``) through
    ``load_variables`` and both deployment engines (fold_bn, int8, bf16) at
    1920×1080 padded to 1088: main-path launch counts as the seeded w64
    net's, the w64_vs_plain check, and the int8 mask against the trained
    float32 net's plain forward on the 4 validation frames (reported).
    → (the engines, the frames, the launch counts)."""
    import torch

    from pcss_unet_tpu_torch.infer import (InferenceEngine, load_variables,
                                           pad_to_multiple)
    from pcss_unet_tpu_torch.ops.kernels import KERNELS

    t0 = time.perf_counter()
    variables = load_variables(npz)
    kw = dict(fold_bn=True, quantize="int8", dtype=torch.bfloat16, device=DEVICE,
              means=stats["means"], stds=stats["stds"])
    e_nhwc = InferenceEngine(None, variables, layout="nhwc", **kw)
    e_chw = InferenceEngine(None, variables, layout="chw", **kw)
    x, _ = gbuffer(np.random.default_rng(7), 3, W64_H, W64_W)
    frames, _ = pad_to_multiple(x[None], e_nhwc.pad_multiple)
    frames = torch.from_numpy(frames).to(DEVICE)
    runs = [main_path("train_to_serve_nhwc", e_nhwc, frames, 2, W64_NHWC_WANT, card, own),
            main_path("train_to_serve_chw", e_chw, frames, 2, W64_CHW_WANT, card, own)]
    for engine in (e_nhwc, e_chw):
        vs_plain_phase(engine, frames, plain, KERNELS, phase="w64_trained_vs_plain")
    # the int8 postures against the trained net's own float32 forward
    xv = np.load(os.path.join(data, "val_inputs.npy"))
    yv = np.load(os.path.join(data, "val_labels.npy"))
    with no_tf32():
        e32 = InferenceEngine(None, variables, dtype=torch.float32, device=DEVICE,
                              means=stats["means"], stds=stats["stds"])
        refs = [e32(f[None])[0] for f in xv]
    quality = {"float32": {"l1_vs_label": float(np.mean([np.abs(r - y).mean()
                                                         for r, y in zip(refs, yv)]))}}
    for name, eng in (("nhwc", e_nhwc), ("chw", e_chw)):
        d = [(eng(f[None])[0], r, y) for f, r, y in zip(xv, refs, yv)]
        quality[name] = {
            "max_abs_vs_f32": max(float(np.abs(m - r).max()) for m, r, _ in d),
            "psnr_db_vs_f32": float(np.mean([10 * math.log10(1.0 / max(
                float(np.mean((m - r) ** 2)), 1e-12)) for m, r, _ in d])),
            "l1_vs_label": float(np.mean([np.abs(m - y).mean() for m, _, y in d]))}
    emit({"phase": "train_to_serve", "card": card, "val_frames": len(xv),
          "quality_on_val": quality, "seconds": time.perf_counter() - t0})
    return e_nhwc, e_chw, frames, runs


# ------------------------------------------- from renders to a trained net
# The data CLIs, the memory governor, the device cache, the --grain loader,
# temporal and the chain that ends in infer: every step through
# ``python -m pcss_unet_tpu_torch`` in process.
SCENE_TRAIN, SCENE_VAL = 16, 4
CACHE_CROP = 512
GRAIN_HW = 256
TEMPORAL_GATE = 1.25 * 0.007692 + 1e-4      # tests/test_torch_deployment_golden.py
W64_ENGINE_WANT = {k: v for k, v in W64_NHWC_WANT.items()
                   if k != "fused_mask_to_u8"}   # engine(frame): no K4


def dispatch(argv):
    """``python -m pcss_unet_tpu_torch <argv>`` in process → (what the
    command returned, its exit code)."""
    import pcss_unet_tpu_torch.__main__ as pmain

    saved, sys.argv = sys.argv, ["pcss_unet_tpu_torch", *argv]
    try:
        return pmain.main(), 0
    except SystemExit as e:
        return None, e.code
    finally:
        sys.argv = saved


def derived_ini(work: str, name: str, **keys) -> str:
    """config.ini with ``keys`` set in its [base] section."""
    with open(os.path.join(REPO, "config.ini")) as f:
        text = f.read()
    extra = "".join(f"{k} = {v}\n" for k, v in keys.items())
    path = os.path.join(work, name)
    with open(path, "w") as f:
        f.write(text.replace("[base]\n", "[base]\n" + extra, 1))
    return path


def data_cli_phase(work: str, card: str):
    """A synthetic scene of 20 renderer-plausible 2048×1024 frames written
    by the port's writers (float32 ZIP EXRs in ``conditioning_images/``,
    8-bit PNG labels in ``images/``), then ``organize`` → ``prepare`` →
    ``stats`` → ``check channels`` → ``check packs``.  Checks: the split
    16/4; every pack row equal to ``read_exr_stack`` / ``read_label_png``
    of its file in ``discover_pairs`` order; the stats equal numpy float64
    over the pack within 1e-12 relative; both checks exit 0.  → (the
    processed dir, the split dir)."""
    from pcss_unet_tpu_torch.data.pipeline import discover_pairs
    from pcss_unet_tpu_torch.io.exr import read_exr_stack, write_exr
    from pcss_unet_tpu_torch.io.png import encode_png, read_label_png

    scene, split, data = (os.path.join(work, d) for d in ("scene", "split", "data"))
    for sub in ("conditioning_images", "images"):
        os.makedirs(os.path.join(scene, sub))
    def write(i, x, y):
        write_exr(os.path.join(scene, "conditioning_images", f"frame{i:03d}.exr"),
                  {c: x[..., k] for k, c in enumerate("RGBA")})
        with open(os.path.join(scene, "images", f"frame{i:03d}.png"), "wb") as f:
            f.write(encode_png(np.rint(y[..., 0] * 255).astype(np.uint8), "L"))

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    # the codecs release the GIL: the writes overlap on threads
    with ThreadPoolExecutor(max_workers=8) as pool:
        jobs = [pool.submit(write, i, *gbuffer(rng, i, FRAME_H, FRAME_W))
                for i in range(SCENE_TRAIN + SCENE_VAL)]
        for job in jobs:
            job.result()
    seconds = {"scene_write": time.perf_counter() - t0}
    results, codes = {}, {}
    for name, argv in (
            ("organize", ["organize", "--scene_dir", scene, "--out_dir", split]),
            ("prepare", ["prepare", "--train_dir", os.path.join(split, "train"),
                         "--val_dir", os.path.join(split, "val"), "--out_dir", data]),
            ("stats", ["stats", "--dataset_path", data]),
            ("check_channels", ["check", "channels", os.path.join(split, "train"),
                                os.path.join(split, "val")]),
            ("check_packs", ["check", "packs", "--dataset_path", data,
                             "--report", os.path.join(work, "packs.json")])):
        t0 = time.perf_counter()
        results[name], codes[name] = dispatch(argv)
        seconds[name] = time.perf_counter() - t0
    rows_differing = 0
    for part in ("train", "val"):
        xs = np.load(os.path.join(data, f"{part}_inputs.npy"), mmap_mode="r")
        ys = np.load(os.path.join(data, f"{part}_labels.npy"), mmap_mode="r")
        pairs = discover_pairs(os.path.join(split, part))
        rows_differing += abs(len(pairs) - len(xs))
        for i, (exr, png) in enumerate(pairs):
            x = read_exr_stack(exr)
            y = read_label_png(png, target_hw=x.shape[:2])[..., None]
            rows_differing += int(not (np.array_equal(xs[i], x) and np.array_equal(ys[i], y)))
    x64 = np.load(os.path.join(data, "train_inputs.npy")).astype(np.float64)
    rel = 0.0          # a constant channel's std is 0 on both sides, exactly
    for k, ref in (("means", x64.mean(axis=(0, 1, 2))),
                   ("stds", x64.std(axis=(0, 1, 2)))):
        d = np.abs(results["stats"][k] - ref)
        rel = max(rel, float(np.max(np.where(ref != 0, d / np.where(ref != 0, np.abs(ref), 1),
                                             np.where(d == 0, 0.0, np.inf)))))
    del x64
    line = {"phase": "data_cli", "card": card, "frames": SCENE_TRAIN + SCENE_VAL,
            "frame_hw": [FRAME_H, FRAME_W], "split": results["organize"],
            "seconds": seconds,
            "prepare_ms_per_frame": seconds["prepare"] / (SCENE_TRAIN + SCENE_VAL) * 1e3,
            "pack_rows_differing": rows_differing, "stats_max_rel_vs_numpy": rel,
            "exit_codes": codes}
    emit(line)
    if (results["organize"] != {"train": SCENE_TRAIN, "val": SCENE_VAL}
            or rows_differing or not rel <= 1e-12 or any(codes.values())):
        raise AssertionError(f"data_cli: {line}")
    return data, split


def snapshot(model) -> dict:
    return {n: t.detach().cpu().clone() for n, t in model.state_dict().items()}


def train_governor_phase(work: str, data: str, card: str) -> str:
    """``train`` at config.ini's reference settings (w64, batch 8 of
    2048×1024, perturb, ``--allow_random_vgg``, governor = xla: the measured
    probe) on the data_cli packs, 1 epoch of 2 steps, with
    ``--grad_accum_steps 0``.  Checks: accum 1 picked; the probe's peak at
    accum 1 within ±10 % of the peak allocated during the run's ``fit``;
    the model handed to ``fit`` equal, parameters and buffers, to a run's
    with ``--grad_accum_steps 1`` (the probe touched nothing).  Then batch
    16 with accum 0 (which accum, does its first step complete), and the
    analytic answers on this card.  → the run's checkpoint directory."""
    import torch

    from pcss_unet_tpu_torch.cli import train as cli_train
    from pcss_unet_tpu_torch.config import load_config
    from pcss_unet_tpu_torch.models.unet import unet_from_config
    from pcss_unet_tpu_torch.train import governor, loop
    from pcss_unet_tpu_torch.utils import memory

    t_start = time.perf_counter()
    probes, fits = [], []
    real_probe, real_fit = governor.probe_step_memory, loop.fit

    def probe(cfg, *a, **k):
        t0 = time.perf_counter()
        plan = real_probe(cfg, *a, **k)
        probes.append({"grad_accum_steps": cfg.grad_accum_steps, "batch": a[3],
                       "total_gb": plan["total"] / 1e9, "state_gb": plan["args"] / 1e9,
                       "oom": plan["oom"], "seconds": time.perf_counter() - t0})
        return plan

    def fit_spy(cfg, model, *a, stub=False, **k):
        rec = {"grad_accum_steps": cfg.grad_accum_steps, "batch": cfg.batch_size,
               "model": snapshot(model)}
        fits.append(rec)
        if stub:           # the model as fit receives it is all this run needs
            return types.SimpleNamespace(best_val_loss=float("nan"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = real_fit(cfg, model, *a, **k)
        torch.cuda.synchronize()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return r

    base = ["--config", os.path.join(REPO, "config.ini"), "--loss_type", "perturb",
            "--allow_random_vgg", "--processed_data_dir", data, "--device", DEVICE,
            "--num_epochs", "1"]
    ck = os.path.join(work, "ckpt_governor")
    cwd = os.getcwd()
    os.chdir(work)
    records, records16 = [], []
    try:
        with swapped([(governor, "probe_step_memory", probe), (loop, "fit", fit_spy),
                      (loop, "build_train_step", timed_step_builder(loop, records))]):
            cli_train.main(base + ["--save_dir", ck, "--grad_accum_steps", "0"])
        run_probes = list(probes)
        with swapped([(loop, "fit", functools.partial(fit_spy, stub=True))]):
            cli_train.main(base + ["--save_dir", os.path.join(work, "ckpt_accum1"),
                                   "--grad_accum_steps", "1"])
        gc.collect()
        torch.cuda.empty_cache()
        del probes[:]
        with swapped([(governor, "probe_step_memory", probe), (loop, "fit", fit_spy),
                      (loop, "build_train_step", timed_step_builder(loop, records16))]):
            cli_train.main(base + ["--save_dir", os.path.join(work, "ckpt_b16"),
                                   "--grad_accum_steps", "0", "--batch_size", "16"])
    finally:
        os.chdir(cwd)
        gc.collect()
        torch.cuda.empty_cache()
    cfg = load_config(os.path.join(REPO, "config.ini"))
    n = memory.param_count(unet_from_config(cfg, device="cpu"))
    budget = memory.device_budget(DEVICE)
    run, accum1, b16 = fits
    picked = {p["grad_accum_steps"]: p for p in run_probes}
    probe_at_pick = picked.get(run["grad_accum_steps"], {}).get("total_gb")
    probe_vs_run = (probe_at_pick / run["peak_gb"] - 1) if probe_at_pick else None
    same_start = all(torch.equal(run["model"][k], accum1["model"][k]) for k in run["model"])
    line = {"phase": "train_governor", "card": card, "config": "config.ini",
            "governor": cfg.governor, "batch": 8, "frame_hw": [FRAME_H, FRAME_W],
            "card_budget_gb": budget / 1e9, "reserve_gb": None,
            "probes": run_probes, "grad_accum_steps_picked": run["grad_accum_steps"],
            "run_peak_allocated_gb": run["peak_gb"],
            "probe_vs_run_peak": probe_vs_run,
            "step_ms": [r["ms"] for r in records],
            "losses": [r["total_loss"] for r in records],
            "model_at_fit_equals_accum1_run": same_start,
            "analytic": {"params": n,
                         "estimate_gb_batch8": memory.estimate_memory_usage(
                             n, 8, FRAME_H, FRAME_W, optimizer=cfg.optimizer_type)["total"] / 1e9,
                         "grad_accum_steps": memory.find_accum_steps(
                             n, 8, FRAME_H, FRAME_W, cfg.optimizer_type, hbm_bytes=budget),
                         "batch_size_0_picks": min(memory.find_optimal_batch_size(
                             n, FRAME_H, FRAME_W, cfg.optimizer_type, hbm_bytes=budget),
                             SCENE_TRAIN)},
            "batch16": {"probes": list(probes),
                        "grad_accum_steps_picked": b16["grad_accum_steps"],
                        "first_step_completed": len(records16) == 1 and all(
                            math.isfinite(r["total_loss"]) and r["skipped"] == 0
                            for r in records16),
                        "step_ms": [r["ms"] for r in records16],
                        "peak_allocated_gb": b16.get("peak_gb")},
            "seconds": time.perf_counter() - t_start}
    from pcss_unet_tpu_torch.data.device_cache import dataset_nbytes
    from pcss_unet_tpu_torch.data.pipeline import PackedDataset

    line["reserve_gb"] = dataset_nbytes(PackedDataset(data, "train")) / 1e9
    emit(line)
    bad = [r for r in records if not math.isfinite(r["total_loss"]) or r["skipped"]]
    if (run["grad_accum_steps"] != 1 or probe_vs_run is None
            or abs(probe_vs_run) > 0.10 or not same_start or len(records) != 2 or bad
            or not line["batch16"]["first_step_completed"]):
        raise AssertionError(f"train_governor: {line}")
    return ck


def train_cache_phase(work: str, data: str, card: str) -> None:
    """The device cache on the card: every train and val batch of
    ``DeviceCache.batches`` equal (``torch.equal``) to the streamed batch
    (``prefetch_to_device``), full frames and 512² crops; then the
    reference config's ``train`` (2 epochs of 2 steps, accum 1) with
    ``device_data_cache = on`` and with ``off``: step ms of each path."""
    import torch

    from pcss_unet_tpu_torch.cli import train as cli_train
    from pcss_unet_tpu_torch.data import device_cache
    from pcss_unet_tpu_torch.data.pipeline import (Loader, PackedDataset,
                                                   prefetch_to_device)
    from pcss_unet_tpu_torch.train import loop

    t_start = time.perf_counter()
    ds, vds = PackedDataset(data, "train"), PackedDataset(data, "val")
    compared, differing = 0, 0
    for part, batch in ((ds, 8), (vds, 4)):
        for crop in (None, (CACHE_CROP, CACHE_CROP)):
            loader = Loader(part, batch, shuffle=part is ds, seed=42, crop_hw=crop)
            cache = device_cache.DeviceCache(part, crop_hw=crop, device=DEVICE)
            for epoch in (0, 1):
                got = list(cache.batches(loader, epoch))
                want = list(prefetch_to_device(loader.epoch(epoch), DEVICE))
                differing += abs(len(got) - len(want))
                for (x, y), (a, b) in zip(got, want):
                    compared += 1
                    differing += int(not (torch.equal(x, a) and torch.equal(y, b)))
            del cache, got, want
    runs = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for mode in ("on", "off"):
            records, built = [], []
            real = device_cache.DeviceCache

            def spy(*a, **k):
                built.append(1)
                return real(*a, **k)

            ini = derived_ini(work, f"cache_{mode}.ini", device_data_cache=mode)
            with swapped([(loop, "build_train_step", timed_step_builder(loop, records)),
                          (loop, "DeviceCache", spy)]):
                cli_train.main(["--config", ini, "--loss_type", "perturb",
                                "--allow_random_vgg", "--processed_data_dir", data,
                                "--save_dir", os.path.join(work, f"ckpt_cache_{mode}"),
                                "--device", DEVICE, "--num_epochs", "2",
                                "--grad_accum_steps", "1"])
            ms = [r["ms"] for r in records]
            runs[mode] = {"caches_built": len(built), "step_ms": ms,
                          "ms_per_step_median": float(np.median(ms[1:])),
                          "losses": [r["total_loss"] for r in records]}
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
    line = {"phase": "train_cache", "card": card, "batches_compared": compared,
            "batches_differing": differing,
            "cache_mb": (device_cache.dataset_nbytes(ds) + device_cache.dataset_nbytes(vds)) / 1e6,
            "runs": runs, "seconds": time.perf_counter() - t_start}
    emit(line)
    if (differing or compared != 2 * 2 * 2 + 1 * 2 * 2   # batches × crops × epochs
            or runs["on"]["caches_built"] != 2 or runs["off"]["caches_built"] != 0
            or any(len(r["step_ms"]) != 4 for r in runs.values())
            or not all(math.isfinite(v) for r in runs.values() for v in r["losses"])):
        raise AssertionError(f"train_cache: {line}")


def grain_phase(work: str, card: str) -> None:
    """``train --grain --grain_workers 4``: 16 frames of 256² (the cache off,
    so the loader's read-ahead threads feed the steps), batch 8, 1 epoch of
    2 steps; every step finite, the train loader a ``GrainLoader``."""
    from pcss_unet_tpu_torch.cli import train as cli_train
    from pcss_unet_tpu_torch.data.grain_pipeline import GrainLoader
    from pcss_unet_tpu_torch.train import loop

    t_start = time.perf_counter()
    data = os.path.join(work, "grain_data")
    os.makedirs(data)
    rng = np.random.default_rng(5)
    frames = [gbuffer(rng, i, GRAIN_HW, GRAIN_HW) for i in range(16)]
    x = np.stack([f[0] for f in frames])
    np.save(os.path.join(data, "train_inputs.npy"), x)
    np.save(os.path.join(data, "train_labels.npy"), np.stack([f[1] for f in frames]))
    np.save(os.path.join(data, "train_stats.npy"),
            {"means": x.mean(axis=(0, 1, 2)), "stds": x.std(axis=(0, 1, 2))})
    records, loaders = [], []
    real_fit = loop.fit

    def fit_spy(cfg, model, train_loader, *a, **k):
        loaders.append(type(train_loader).__name__)
        return real_fit(cfg, model, train_loader, *a, **k)

    ini = derived_ini(work, "grain.ini", device_data_cache="off")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with swapped([(loop, "build_train_step", timed_step_builder(loop, records)),
                      (loop, "fit", fit_spy)]):
            cli_train.main(["--config", ini, "--loss_type", "perturb",
                            "--allow_random_vgg", "--processed_data_dir", data,
                            "--save_dir", os.path.join(work, "ckpt_grain"),
                            "--device", DEVICE, "--num_epochs", "1", "--batch_size", "8",
                            "--grad_accum_steps", "1", "--grain", "--grain_workers", "4"])
    finally:
        os.chdir(cwd)
    line = {"phase": "grain", "card": card, "frame_hw": [GRAIN_HW, GRAIN_HW], "batch": 8,
            "loader": loaders, "steps": len(records),
            "step_ms": [r["ms"] for r in records],
            "losses": [r["total_loss"] for r in records],
            "seconds": time.perf_counter() - t_start}
    emit(line)
    if (loaders != [GrainLoader.__name__] or len(records) != 2 or any(
            not math.isfinite(r["total_loss"]) or r["skipped"] for r in records)):
        raise AssertionError(f"grain: {line}")


def temporal_phase(work: str, card: str) -> dict:
    """``python -m pcss_unet_tpu_torch temporal`` in process.  The
    committed deploy_w16 net on its golden sequence (8 frames of 192×256
    and their motion vectors: the frames behind its pinned instability
    0.007692, measured at the metric's default alpha 5), ``--fold_bn`` and
    ``--fold_bn --quantize int8`` (bf16): the score within the JAX suite's
    gate, equal within 1e-6 to ``measure_temporal_instability`` of the
    masks ``engine(frame)`` gives, one PNG per frame.  Then the seeded w64
    net on 4 animated 1920×1080 frames with their motion vectors, int8,
    with the main paths' stats (so K1 runs): the score, and the launches
    per frame by kernel, which must be the
    ``main_path_w64_nhwc`` path's without K4 (``engine(frame)`` returns the
    float mask).  → the launch counts of the runs."""
    import torch

    from pcss_unet_tpu_torch.infer import InferenceEngine, load_variables
    from pcss_unet_tpu_torch.io.exr import read_exr_stack, write_exr
    from pcss_unet_tpu_torch.losses import measure_temporal_instability
    from pcss_unet_tpu_torch.models.init import seeded_variables
    from pcss_unet_tpu_torch.models.torch_import import export_to_torch_state_dict
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_deployment_golden import make_sequence
    from make_synthetic_scene import render_sequence

    t_start = time.perf_counter()
    with open(os.path.join(REPO, "tests", "golden", "deploy_w16.json")) as f:
        meta = json.load(f)

    def write_sequence(root, seq, mv):
        os.makedirs(os.path.join(root, "frames"))
        for t, fr in enumerate(seq):
            write_exr(os.path.join(root, "frames", f"t{t:03d}.exr"),
                      {c: fr[..., k] for k, c in enumerate("RGBA")})
        np.save(os.path.join(root, "motion.npy"), mv)

    def run(root, weights, posture, extra=()):
        reset_launch_counts()
        t0 = time.perf_counter()
        res, code = dispatch(["temporal", "--frames_dir", os.path.join(root, "frames"),
                              "--weights", weights, "--motion_vectors",
                              os.path.join(root, "motion.npy"), "--device", DEVICE,
                              *posture, *extra])
        return res, code, launch_counts(), time.perf_counter() - t0

    total = {}
    golden = os.path.join(work, "temporal_w16")
    seq, mv = make_sequence(meta["seed_seq"], meta["n_seq"])
    write_sequence(golden, seq, mv)
    np.save(os.path.join(golden, "train_stats.npy"),
            {"means": meta["means"], "stds": meta["stds"]})
    variables = load_variables(WEIGHTS)
    lines, bad = [], []
    for posture in (["--fold_bn"], ["--fold_bn", "--quantize", "int8"]):
        masks_dir = os.path.join(golden, "masks" + "_".join(posture))
        res, code, launches, secs = run(golden, WEIGHTS, posture, [
            "--stats_dir", golden, "--alpha", "5", "--save_masks_dir", masks_dir])
        engine = InferenceEngine(None, variables, means=np.asarray(meta["means"], np.float32),
                                 stds=np.asarray(meta["stds"], np.float32), fold_bn=True,
                                 quantize="int8" if "int8" in posture else "none",
                                 device=DEVICE)
        frames = sorted(os.listdir(os.path.join(golden, "frames")))
        masks = np.stack([engine(read_exr_stack(os.path.join(golden, "frames", f)))
                          for f in frames])
        ref = float(measure_temporal_instability(
            torch.from_numpy(masks)[:, None].to(DEVICE),
            torch.from_numpy(mv)[:, None].to(DEVICE), alpha=5.0))
        line = {"phase": "temporal", "card": card, "net": "deploy_w16",
                "posture": " ".join(posture), "frames": len(frames),
                "frame_hw": list(seq.shape[1:3]), "alpha": 5.0,
                "score": res and res["score"], "gate": TEMPORAL_GATE,
                "score_from_engine_masks": ref, "pngs": len(os.listdir(masks_dir)),
                "launches": launches, "seconds": secs}
        lines.append(line)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if (code or res["score"] > TEMPORAL_GATE or abs(res["score"] - ref) > 1e-6
                or line["pngs"] != len(frames)
                or launches["fused_scrub_standardize"] != len(frames)):
            bad.append(line)
    # the seeded w64 net, 4 animated 1080p frames, int8
    w64 = os.path.join(work, "temporal_w64")
    seq64, mv64 = render_sequence(np.random.default_rng(0), W64_H, W64_W, 4)
    write_sequence(w64, np.stack([g for g, _ in seq64]).astype(np.float32), mv64)
    weights = os.path.join(w64, "w64.npz")
    np.savez(weights, **export_to_torch_state_dict(seeded_variables(W64, seed=0)))
    np.save(os.path.join(w64, "train_stats.npy"),      # the main paths' stats
            {"means": meta["means"], "stds": meta["stds"]})
    res, code, launches, secs = run(w64, weights, ["--fold_bn", "--quantize", "int8"],
                                    ["--stats_dir", w64])
    want = {k: v * 4 for k, v in W64_ENGINE_WANT.items()}
    line = {"phase": "temporal", "card": card, "net": "w64 seeded",
            "posture": "--fold_bn --quantize int8", "frames": 4,
            "frame_hw": [W64_H, W64_W], "alpha": 3.0, "score": res and res["score"],
            "launches": launches, "launches_want": want, "seconds": secs}
    lines.append(line)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    if code or not math.isfinite(res["score"]) or {
            k: v for k, v in launches.items() if v} != want:
        bad.append(line)
    for ln in lines:
        emit(ln)
    emit({"phase": "temporal_seconds", "card": card, "seconds": time.perf_counter() - t_start})
    if bad:
        raise AssertionError(f"temporal: {bad}")
    return total


def e2e_chain_phase(work: str, data: str, split: str, ckpt: str, card: str) -> dict:
    """``infer`` of the first val EXR of the data_cli scene with the
    checkpoint directory ``train_governor`` wrote (its best checkpoint)
    and ``--stats_dir`` from ``stats``, in the deployment posture
    (``--fold_bn --quantize int8``, bf16): the launches per frame the w64
    NHWC path's without K4, and the PNG's codes ``trunc(255 · engine
    mask)`` of an engine built from the same checkpoint.  → the launch
    counts."""
    import torch

    from pcss_unet_tpu_torch.data.pipeline import discover_pairs
    from pcss_unet_tpu_torch.data.stats import load_channel_stats
    from pcss_unet_tpu_torch.infer import InferenceEngine, load_variables
    from pcss_unet_tpu_torch.io.exr import read_exr_stack
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts

    exr = discover_pairs(os.path.join(split, "val"))[0][0]
    png = os.path.join(work, "e2e_mask.png")
    reset_launch_counts()
    times, code = dispatch(["infer", "--input", exr, "--output", png, "--weights", ckpt,
                            "--stats_dir", data, "--fold_bn", "--quantize", "int8",
                            "--device", DEVICE])
    launches = launch_counts()
    means, stds = load_channel_stats(data)
    engine = InferenceEngine(None, load_variables(ckpt), means=means, stds=stds,
                             fold_bn=True, quantize="int8", dtype=torch.bfloat16,
                             device=DEVICE)
    want_codes = png_codes(engine(read_exr_stack(exr)))
    got = read_png(png) if os.path.exists(png) else None
    line = {"phase": "e2e_chain", "card": card, "weights": "train --save_dir (best)",
            "input": os.path.basename(exr), "frame_hw": list(want_codes.shape),
            "times": times, "launches": launches,
            "png_codes_differing": None if got is None else int((got != want_codes).sum())}
    emit(line)
    if (code or got is None or got.shape != want_codes.shape or line["png_codes_differing"]
            or {k: v for k, v in launches.items() if v} != W64_ENGINE_WANT):
        raise AssertionError(f"e2e_chain: {line}")
    return launches


# ------------------------------------------ sharded inference, data parallel
SHARD_MESHES = (2, 4)              # 1×n meshes of cuda:0
SHARD_REPS = 5
W64_SHARDED_WANT = {k: v for k, v in W64_NHWC_WANT.items()
                    if k != "fused_mask_to_u8"}   # per window; masks stay float32
W64_FUSED_SHARDED_WANT = {"fused_scrub_standardize": 1, "fused_conv_block_nhwc": 3,
                          "fused_conv_block_chw": 3, "fused_block128_nhwc": 1}


def window_block_diffs(eng, x, n, plain):
    """Per ConvBlock of the model the windows run, the max |d| between each
    window's own rows of the block's output and the same rows of the
    unsharded forward's (every block's rows there lie inside the window's
    receptive field, so they must agree where each op computes a window as
    it computes the frame).  → ({block: max |d|}, the first block that
    differs or None, that block's route)."""
    from pcss_unet_tpu_torch.models.unet import ConvBlock, spatial_halo
    from pcss_unet_tpu_torch.parallel import make_mesh

    model = eng.plain_model if plain else eng.sharding_model()
    halo = spatial_halo(model)
    fwd = eng.build_sharded_forward(make_mesh(1, n, devices=["cuda:0"] * n), halo,
                                    False, plain)
    # the windows run the engine's own model on its card: one set of hooks,
    # one dict of outputs per forward
    windows, frame = {}, {}
    outs = windows
    hooks = [m.register_forward_hook(
        lambda mod, a, o, name=name: outs.setdefault(name, []).append(o.float()))
        for name, m in model.named_children() if isinstance(m, ConvBlock)]
    try:
        fwd(x)
        outs = frame
        model(eng._preprocess(x, fused=not plain))
    finally:
        for h in hooks:
            h.remove()
    h = x.shape[1]
    shard = h // n
    ext = min(h, shard + 2 * halo)
    diffs = {}
    for name in model.blocks():
        full = frame[name][0]
        f = h // full.shape[2]                    # the block's row scale
        worst = 0.0
        for i, win in enumerate(windows[name]):
            start = i * shard
            s = min(max(start - halo, 0), h - ext)
            a = win[:, :, (start - s) // f:(start - s + shard) // f]
            worst = max(worst, float((a - full[:, :, start // f:(start + shard) // f])
                                     .abs().max()))
        diffs[name] = worst
    first = next((b for b, d in diffs.items() if d > 0), None)
    return diffs, first, None if first is None else getattr(model, first).route


def sharded_infer_phase(postures, card):
    """Each posture ``(name, engine, frames, gate, want)`` through
    ``infer_sharded`` on 1×n meshes of cuda:0 (the frames unpadded, numpy;
    the path pads them): launches per sharded frame from counters zeroed
    just before and read just after (``want`` per window, if given), the
    sharded masks against the unsharded forward of the same padded frame
    through the model the windows run (max |d|, codes changed; ``gate``:
    the largest max |d| allowed, None to report only; and against the
    engine's own forward, which for a chw engine is its channels-major
    forward, reported), and the sharded frame's ms beside the unsharded one's
    (the device-side forward on the padded frame already on the card,
    CUDA-synchronised, median of ``SHARD_REPS`` after one warm).  Where
    the sharded masks differ, ``window_block_diffs`` names the first block
    whose rows differ; where a gate applies and that block runs cuDNN's
    convolutions (``plain``), the comparison is made again with cuDNN off.  A gate
    holds where no cuDNN block differs, and otherwise requires the windows
    to agree with cuDNN off (so the difference is cuDNN's algorithm choice
    for the window's height, not the port's).  On one card the windows run
    one after another: this is not a faster path on one card.  → the
    launch counts of each sharded frame."""
    import torch

    from pcss_unet_tpu_torch.infer import infer_sharded
    from pcss_unet_tpu_torch.models.unet import spatial_halo
    from pcss_unet_tpu_torch.ops.kernels import reset_launch_counts
    from pcss_unet_tpu_torch.parallel import make_mesh

    def median_ms(fn):
        fn()
        times = []
        for _ in range(SHARD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    runs = []
    for name, eng, frames, gate, want in postures:
        h, w = frames.shape[1:3]
        for n in SHARD_MESHES:
            mesh = make_mesh(1, n, devices=["cuda:0"] * n)
            infer_sharded(eng, frames, mesh)                       # warm
            torch.cuda.synchronize()
            reset_launch_counts()
            got = infer_sharded(eng, frames, mesh)
            launches = launch_counts()
            if want is not None:
                bad = {k: v for k, v in launches.items() if v != want.get(k, 0) * n}
                if bad:
                    raise AssertionError(f"sharded_infer {name} 1x{n}: launches "
                                         f"{launches}, want {want} per window")
            plain = eng.sharding_model() is eng.plain_model
            model = eng.plain_model if plain else eng.sharding_model()
            hp = -(-h // (16 * n)) * 16 * n
            wp = -(-w // 16) * 16
            padded = np.pad(frames, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)),
                            mode="reflect")
            x = torch.from_numpy(padded).cuda()
            # the unsharded forward of the model the windows run (for a chw
            # engine, its NHWC kernel model; its own forward is reported too)
            ref = eng._postprocess(model(eng._preprocess(x, fused=not plain)))
            ref = ref.cpu().numpy()[:, :h, :w]
            d = float(np.abs(got - ref).max())
            codes = int((np.round(got * 255) != np.round(ref * 255)).sum())
            own = eng.run_padded(x, plain=plain).cpu().numpy()[:, :h, :w]
            fwd = eng.build_sharded_forward(mesh, spatial_halo(model), False, plain)
            line = {"phase": "sharded_infer", "posture": name, "mesh": [1, n],
                    "frame_hw": [h, w], "padded_hw": [hp, wp],
                    "halo": spatial_halo(model),
                    "window_rows": min(hp, hp // n + 2 * spatial_halo(model)),
                    "launches": launches, "launches_per_window_want": want,
                    "max_abs_vs_unsharded": d, "codes_changed": codes,
                    "max_abs_vs_engine_forward": float(np.abs(got - own).max()),
                    "gate": gate,
                    "sharded_ms": median_ms(lambda: fwd(x)),
                    "unsharded_ms": median_ms(lambda: eng.run_padded(x, plain=plain)),
                    "card": card}
            line["sharded_over_unsharded"] = line["sharded_ms"] / line["unsharded_ms"]
            cudnn_off_exact = None
            if d > 0:
                diffs, first, route = window_block_diffs(eng, x, n, plain)
                line.update(block_max_abs=diffs, first_block_that_differs=first,
                            its_route=route)
                if route == "plain" and gate is not None:
                    with torch.backends.cudnn.flags(
                            enabled=False, allow_tf32=torch.backends.cudnn.allow_tf32):
                        off, _, _ = window_block_diffs(eng, x, n, plain)
                    line["block_max_abs_cudnn_off"] = off
                    cudnn_off_exact = not any(off.values())
            emit(line)
            if not (np.isfinite(got).all() and got.shape == (1, h, w, 1)):
                raise AssertionError(f"sharded_infer {name}: bad output")
            if gate is not None and not (d <= gate or cudnn_off_exact):
                raise AssertionError(f"sharded_infer {name} 1x{n}: max |d| {d} "
                                     f"against the unsharded forward > {gate}")
            runs.append(launches)
    return runs


DP_HW = (512, 1024)               # the data-parallel phase's frames (h, w)
DP_BATCH, DP_STEPS, DP_TIMED = 8, 2, 4


def dp_rank_main(rank: int, work: str) -> int:
    """One of the two ranks of ``dp_train`` (``python3 chip_smoke.py
    --dp-rank R WORK``; the launcher's environment joins them over gloo on
    cuda:0): the group step, standard and perturbed, on this rank's rows
    of the batch; the explicit step and ZeRO-1; then timed
    steps in the reference dtype and the gradient bucket's all-reduce alone.
    Writes ``rank<R>.pkl`` in ``work``."""
    import pickle

    import torch
    import torch.distributed as dist

    from pcss_unet_tpu_torch.train.step import rank_rows
    from pcss_unet_tpu_torch.utils.distributed import initialize_multihost

    initialize_multihost()
    group = dist.group.WORLD
    rows = torch.from_numpy(rank_rows(DP_BATCH, rank, dist.get_world_size()))
    out = {}
    with no_tf32(), deterministic_cudnn():
        for loss_type in ("standard", "perturb"):
            out[loss_type] = dp_run(loss_type, group, rows, dtype="float64")
        # two runs of one step take the same gradients, so ZeRO-1 and the
        # explicit step differ only by ZeRO-1
        for builder in ("explicit", "zero1"):
            out[builder] = dp_run("standard", group, rows, builder=builder)
    out["timed"] = dp_run("standard", group, rows, dtype="bfloat16",
                          steps=DP_TIMED)["ms"]
    # the step's one collective alone: the gradient bucket's all-reduce
    bucket = torch.zeros(sum(v.size for v in out["standard"]["delta"].values()),
                         device=DEVICE)
    ms = []
    for _ in range(DP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(bucket)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"], out["bucket_floats"] = ms, bucket.numel()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dp_run(loss_type, group, rows, builder=None, steps=DP_STEPS,
           dtype="float32", shard=None, hw=DP_HW):
    """``steps`` w64 train steps (config.ini's settings, adamw included,
    with ``loss_type`` and ``dtype``, 4 steps an epoch, no warmup; float64
    makes the parameters float64 too) from seed 0 on ``rows`` of a seeded
    batch of ``DP_BATCH`` renderer-plausible ``hw`` frames on cuda:0,
    through the group step (``group``; None: one process; ``shard``: this
    rank's row shard of a (data × spatial) grid, ``parallel/spatial.py``),
    or through ``parallel/dp.py``'s ``builder`` ("explicit" or "zero1").
    → losses, per-step ms, the parameters' changes, the BatchNorm
    statistics (host numpy), the peak allocated GB and the banded resize's
    launches."""
    import torch

    from pcss_unet_tpu_torch.config import load_config
    from pcss_unet_tpu_torch.parallel.dp import (build_explicit_dp_train_step,
                                                 build_zero1_dp_train_step,
                                                 create_zero1_state)
    from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
    from pcss_unet_tpu_torch.models.init import init_train_weights
    from pcss_unet_tpu_torch.models.unet import unet_from_config
    from pcss_unet_tpu_torch.ops.kernels import banded_resize
    from pcss_unet_tpu_torch.train import build_train_step, create_train_state

    resizes = banded_resize.launches
    cfg = load_config(os.path.join(REPO, "config.ini"), {
        "loss_type": loss_type, "compute_dtype": dtype, "batch_size": DP_BATCH,
        "num_epochs": 2, "warmup_epochs": 0})
    model = init_train_weights(unet_from_config(cfg, device="cpu"),
                               torch.Generator().manual_seed(0)).to(DEVICE).train()
    if dtype == "float64":
        model.double()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    bundle = LossBundle(perceptual=PerceptualLoss(None, device=DEVICE), alpha=cfg.alpha,
                        perturb_weight=cfg.perturb_weight,
                        perturbation_count=cfg.perturbation_count)
    args = (cfg, bundle, np.zeros(4, np.float32), np.ones(4, np.float32), 4)
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(model, cfg, 4)
    if builder == "explicit":
        step = build_explicit_dp_train_step(*args, group)
    elif builder == "zero1":
        state = create_zero1_state(model, cfg, 4, group)
        step = build_zero1_dp_train_step(*args, group)
    else:
        step = build_train_step(*args, per_block_norms=False, group=group,
                                rows=shard)
    rng = np.random.default_rng(0)
    pairs = [gbuffer(rng, i, *hw) for i in range(DP_BATCH)]
    x = torch.from_numpy(np.stack([p[0] for p in pairs])).to(DEVICE)[rows.to(DEVICE)]
    y = torch.from_numpy(np.stack([p[1] for p in pairs])).to(DEVICE)[rows.to(DEVICE)]
    del pairs
    if shard is not None:
        h = hw[0] // shard.count
        x, y = (t[:, shard.index * h:(shard.index + 1) * h].contiguous() for t in (x, y))
    losses, ms = [], []
    for i in range(steps):
        gen = torch.Generator(device=DEVICE).manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, x, y, gen)
        losses.append(float(m["total_loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if int(m["skipped"]):
            raise AssertionError(f"dp_run {loss_type}: step {i} skipped")
    return {"losses": losses, "ms": ms,
            "delta": {n: (p.detach() - before[n]).double().cpu().numpy().ravel()
                      for n, p in model.named_parameters()},
            "stats": {n: b.detach().double().cpu().numpy()
                      for n, b in model.named_buffers() if "running" in n},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "resize_launches": banded_resize.launches - resizes}


def _cos_ratio(pairs):
    """The worst cosine and norm-ratio error over (got, want) vector pairs."""
    cos, ratio = 1.0, 0.0
    for a, b in pairs:
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if nb:
            cos = min(cos, float(a @ b / (na * nb)))
            ratio = max(ratio, abs(float(na / nb) - 1))
    return cos, ratio


def dp_compare(got, want):
    """train_parity's criteria between two ``dp_run`` results: the losses'
    largest relative difference; each parameter change's and each running
    statistic's change's worst cosine and norm-ratio error (the conv biases
    in front of a BatchNorm, whose true gradient is zero, by the size of
    their change); the statistics' largest difference, reported."""
    pre_bn = [n for n in want["delta"] if re.search(r"\.conv_[ab]\.bias$", n)]
    cos, ratio = _cos_ratio((got["delta"][n], d) for n, d in want["delta"].items()
                            if n not in pre_bn)
    # a running statistic's change: from mean 0, variance 1
    moved = {n: (s, got["stats"][n]) for n, s in want["stats"].items()}
    s_cos, s_ratio = _cos_ratio((g - float("var" in n), w - float("var" in n))
                                for n, (w, g) in moved.items())
    return {"loss_max_rel": max(abs(a / b - 1) for a, b in zip(got["losses"],
                                                                 want["losses"])),
            "delta_worst_cos": cos, "delta_worst_norm_ratio_err": ratio,
            "pre_bn_bias_delta_max": max(float(np.abs(d[n]).max()) for d in
                                         (got["delta"], want["delta"]) for n in pre_bn),
            "bn_stat_change_worst_cos": s_cos, "bn_stat_change_worst_norm_ratio_err": s_ratio,
            "bn_stat_max_abs_diff": max(float(np.abs(g - w).max())
                                        for w, g in moved.values())}


def dp_train_phase(work: str, card: str) -> None:
    """Data parallelism on one card: two gloo ranks on cuda:0 (NCCL refuses
    two ranks on one card), each a process of its own (``dp_rank_main``),
    the w64 net at full width on a global batch of 8 ``DP_HW`` frames,
    deterministic cuDNN, TF32 off.  The group step, standard and perturbed,
    with config.ini's adamw, against the one-process batch-8 step on the
    card: losses within 1e-4, each parameter's and each BatchNorm running
    statistic's change at cosine > 0.995 and norm within 2 %
    (train_parity's bars).  These runs are float64: Adam's first steps are
    sign-like and turn any float32 difference of summation order on
    near-zero coordinates into ±lr, and splitting the batch over two ranks
    changes the order of the sums; ZeRO-1 against the replicated explicit
    step, float32 (rtol 1e-4, atol 1e-5: tests/test_dp_explicit.py's bar;
    the pre-BN conv biases by size, as above); the ranks' step ms beside
    the one process's, in bf16 (config.ini's dtype).  Then ``python -m
    pcss_unet_tpu_torch train --data_parallel 2 --device cuda:0`` in
    process for one epoch of 16 ``DP_HW`` frames (the CLI starts its two
    ranks): its checkpoints written once, by rank 0.  → the one-process
    float64 standard run (``spatial_train``'s reference)."""
    import pickle
    import socket

    import torch

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                               "--dp-rank", str(r), work],
                              env=dict(env, RANK=str(r), LOCAL_RANK="0"), cwd=REPO)
             for r in range(2)]
    try:
        for p in procs:
            if p.wait(timeout=600):
                raise AssertionError(f"dp_train: a rank exited {p.returncode}")
    finally:
        for p in procs:
            p.kill()
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    rows = torch.arange(DP_BATCH)
    with no_tf32(), deterministic_cudnn():
        single = {lt: dp_run(lt, None, rows, dtype="float64")
                  for lt in ("standard", "perturb")}
    single_ms = dp_run("standard", None, rows, dtype="bfloat16", steps=DP_TIMED)["ms"]
    line = {"phase": "dp_train", "ranks": 2, "backend": "gloo", "device": "cuda:0",
            "widths": list(W64), "global_batch": DP_BATCH, "hw": list(DP_HW),
            "optimizer": "adamw", "parity_dtype": "float64", "zero1_dtype": "float32",
            "cudnn_deterministic": True, "tf32": False, "card": card}
    ok = True
    for lt in ("standard", "perturb"):
        c = dp_compare(ranks[0][lt], single[lt])
        c["ranks_agree"] = all(np.array_equal(ranks[1][lt]["delta"][n], d)
                               for n, d in ranks[0][lt]["delta"].items())
        line[lt] = c
        ok &= (c["loss_max_rel"] <= 1e-4
               and min(c["delta_worst_cos"], c["bn_stat_change_worst_cos"]) > 0.995
               and max(c["delta_worst_norm_ratio_err"],
                       c["bn_stat_change_worst_norm_ratio_err"]) < 2e-2
               and c["pre_bn_bias_delta_max"] < 1e-3 and c["ranks_agree"])
    z, e = ranks[0]["zero1"], ranks[0]["explicit"]
    # (the pre-BN conv biases move on rounding noise: held by size above)
    zero1_err = max(float(np.max(np.abs(z["delta"][n] - d) - 1e-4 * np.abs(d) - 1e-5))
                    for n, d in e["delta"].items()
                    if not re.search(r"\.conv_[ab]\.bias$", n))
    line["zero1_vs_explicit"] = {
        "loss_max_rel": max(abs(a / b - 1) for a, b in zip(z["losses"], e["losses"])),
        "max_excess_over_rtol_1e-4_atol_1e-5": zero1_err}
    ok &= zero1_err <= 0 and line["zero1_vs_explicit"]["loss_max_rel"] <= 1e-5
    rank_ms = [max(a, b) for a, b in zip(ranks[0]["timed"], ranks[1]["timed"])]
    line["step_ms_bf16"] = {"two_ranks": float(np.median(rank_ms[1:])),
                            "one_process": float(np.median(single_ms[1:])),
                            "steps": DP_TIMED, "first_step_dropped": True,
                            "bucket_allreduce_ms": float(np.median(ranks[0]["allreduce_ms"][1:])),
                            "bucket_floats": ranks[0]["bucket_floats"]}
    # the CLI: one epoch of --data_parallel 2 on the card
    data = os.path.join(work, "data")
    os.makedirs(data)
    rng = np.random.default_rng(1)
    pairs = [gbuffer(rng, i, *DP_HW) for i in range(16 + 4)]
    for split, sl in (("train", slice(0, 16)), ("val", slice(16, None))):
        np.save(os.path.join(data, f"{split}_inputs.npy"), np.stack([p[0] for p in pairs[sl]]))
        np.save(os.path.join(data, f"{split}_labels.npy"), np.stack([p[1] for p in pairs[sl]]))
    ckpt = os.path.join(work, "ckpt")
    t_cli = time.perf_counter()
    _, code = dispatch(["train", "--config", "config.ini", "--allow_random_vgg",
                        "--processed_data_dir", data, "--save_dir", ckpt,
                        "--num_epochs", "1", "--data_parallel", "2",
                        "--device", "cuda:0", "--grad_accum_steps", "1"])
    cli_s = time.perf_counter() - t_cli
    files = sorted(os.listdir(ckpt))
    with open(os.path.join(ckpt, "checkpoints.json")) as f:
        index = json.load(f)
    with open(os.path.join(ckpt, "resolved_config.json")) as f:
        resolved = json.load(f)
    line["cli"] = {"exit": code, "files": files, "checkpoints": index,
                   "data_parallel": resolved["data_parallel"], "seconds": cli_s}
    ok &= (code == 0 and files == ["checkpoints.json", "ckpt_0.pt",
                                   "resolved_config.json"]
           and list(index) == ["0"] and resolved["data_parallel"] == 2)
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if not ok:
        raise AssertionError(f"dp_train: {line}")
    return single["standard"]


SP_HW = (FRAME_H, FRAME_W)      # spatial_train's timed frames
SP_TIMED = 3


def sp_rank_main(rank: int, work: str) -> int:
    """One of the four ranks of ``spatial_train`` (``python3 chip_smoke.py
    --sp-rank R WORK``; the launcher's environment joins them over gloo on
    cuda:0): the float64 group step on the 1×2 grid of ranks 0 and 1 and on
    the 2×2 grid of all four (rank r at cell (r // 2, r % 2)), then the
    timed 1×2 grid (ranks 0 and 1; 2 and 3 wait): config.ini's bf16
    perturbed steps at 2048×1024, the peak allocated memory, and the halo
    exchanges with the bytes of the buffers they all-reduce.  Writes
    ``rank<R>.pkl`` in ``work``."""
    import pickle

    import torch
    import torch.distributed as dist

    from pcss_unet_tpu_torch.parallel.spatial import row_shard
    from pcss_unet_tpu_torch.train.step import rank_rows
    from pcss_unet_tpu_torch.utils import distributed as ud

    ud.initialize_multihost()
    world = dist.group.WORLD
    pair = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
    grid = row_shard(world, 2)
    out = {}
    with no_tf32(), deterministic_cudnn():
        if rank < 2:
            out["1x2"] = dp_run("standard", pair, torch.arange(DP_BATCH),
                                dtype="float64", shard=row_shard(pair, 2))
        out["2x2"] = dp_run("standard", world,
                            torch.from_numpy(rank_rows(DP_BATCH, rank // 2, 2)),
                            dtype="float64", shard=grid)
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank < 2:
        calls = {"n": 0, "bytes": 0}
        swap = ud._HaloExchange._swap

        def counted(group, index, count, first, last, mine):
            calls["n"] += 1
            calls["bytes"] += count * (first.numel() + last.numel()) * first.element_size()
            return swap(group, index, count, first, last, mine)
        ud._HaloExchange._swap = staticmethod(counted)
        r = dp_run("perturb", pair, torch.arange(DP_BATCH), dtype="bfloat16",
                   steps=SP_TIMED, shard=row_shard(pair, 2), hw=SP_HW)
        ud._HaloExchange._swap = staticmethod(swap)
        out["timed"] = {"ms": r["ms"], "peak_gb": r["peak_gb"], "losses": r["losses"],
                        "halo_exchanges": calls["n"], "halo_buffer_bytes": calls["bytes"]}
    dist.barrier()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spatial_train_phase(work: str, data: str, single: dict, card: str) -> None:
    """Row-sharded training on one card (``train --spatial_parallel``):
    four gloo ranks on cuda:0, each a process of its own (``sp_rank_main``).
    Parity: the w64 net, config.ini's adamw, float64, deterministic cuDNN,
    TF32 off, on a global batch of 8 ``DP_HW`` frames, on the 1×2 and the
    2×2 grid against the one-process run of ``dp_train`` (train_parity's
    bars; every rank of a grid holding the same parameters).  Time: the
    1×2 grid against one process at config.ini's reference (batch 8 of
    2048×1024, bf16, perturb, ``SP_TIMED`` steps, the first dropped): ms
    per step (the slower rank's), each rank's peak allocated memory beside
    one process's, halo exchanges per step and the bytes of the buffers
    they all-reduce.  Each parity rank's banded-resize launches (the kernel
    on its row shard's cut matrices, in float64) must not be 0.  Then ``python -m pcss_unet_tpu_torch train
    --spatial_parallel 2 --device cuda:0`` in process for one epoch on
    ``data`` (the chain's packs): one set of checkpoints, by rank 0."""
    import pickle
    import socket

    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="4", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                               "--sp-rank", str(r), work],
                              env=dict(env, RANK=str(r), LOCAL_RANK="0"), cwd=REPO)
             for r in range(4)]
    try:
        for p in procs:
            if p.wait(timeout=900):
                raise AssertionError(f"spatial_train: a rank exited {p.returncode}")
    finally:
        for p in procs:
            p.kill()
    ranks = []
    for r in range(4):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    line = {"phase": "spatial_train", "backend": "gloo", "device": "cuda:0",
            "widths": list(W64), "global_batch": DP_BATCH, "card": card,
            "parity": {"hw": list(DP_HW), "optimizer": "adamw", "dtype": "float64",
                       "cudnn_deterministic": True, "tf32": False,
                       "against": "one process (dp_train's float64 standard run)"}}
    ok = True
    for grid, members in (("1x2", ranks[:2]), ("2x2", ranks)):
        c = dp_compare(members[0][grid], single)
        c["ranks_agree"] = all(np.array_equal(r[grid]["delta"][n], d)
                               for r in members[1:]
                               for n, d in members[0][grid]["delta"].items())
        c["peak_gb_per_rank"] = [r[grid]["peak_gb"] for r in members]
        c["resize_launches_per_rank"] = [r[grid]["resize_launches"] for r in members]
        line["parity"][grid] = c
        ok &= (c["loss_max_rel"] <= 1e-4
               and min(c["delta_worst_cos"], c["bn_stat_change_worst_cos"]) > 0.995
               and max(c["delta_worst_norm_ratio_err"],
                       c["bn_stat_change_worst_norm_ratio_err"]) < 2e-2
               and c["pre_bn_bias_delta_max"] < 1e-3 and c["ranks_agree"]
               and min(c["resize_launches_per_rank"]) > 0)
    one = dp_run("perturb", None, torch.arange(DP_BATCH), dtype="bfloat16",
                 steps=SP_TIMED, hw=SP_HW)
    timed = [r["timed"] for r in ranks[:2]]
    rank_ms = [max(a, b) for a, b in zip(timed[0]["ms"], timed[1]["ms"])]
    line["timed"] = {
        "hw": list(SP_HW), "dtype": "bfloat16", "loss_type": "perturb",
        "steps": SP_TIMED, "first_step_dropped": True,
        "step_ms": {"1x2": float(np.median(rank_ms[1:])),
                    "one_process": float(np.median(one["ms"][1:]))},
        "step_ms_all": {"1x2_rank0": timed[0]["ms"], "1x2_rank1": timed[1]["ms"],
                        "one_process": one["ms"]},
        "peak_gb": {"1x2_per_rank": [t["peak_gb"] for t in timed],
                    "one_process": one["peak_gb"]},
        "halo_exchanges_per_step": timed[0]["halo_exchanges"] / SP_TIMED,
        "halo_buffer_mb_per_step": timed[0]["halo_buffer_bytes"] / SP_TIMED / 1e6,
        "losses": {"1x2": timed[0]["losses"], "one_process": one["losses"]}}
    line["timed"]["step_ratio"] = (line["timed"]["step_ms"]["1x2"]
                                   / line["timed"]["step_ms"]["one_process"])
    ok &= all(np.isfinite(t["losses"]).all() for t in timed)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    # the CLI: one epoch of --spatial_parallel 2 on the card
    ckpt = os.path.join(work, "ckpt")
    t_cli = time.perf_counter()
    _, code = dispatch(["train", "--config", "config.ini", "--allow_random_vgg",
                        "--processed_data_dir", data, "--save_dir", ckpt,
                        "--num_epochs", "1", "--spatial_parallel", "2",
                        "--device", "cuda:0", "--grad_accum_steps", "1"])
    files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    resolved = {}
    if "resolved_config.json" in files:
        with open(os.path.join(ckpt, "resolved_config.json")) as f:
            resolved = json.load(f)
    line["cli"] = {"exit": code, "files": files, "seconds": time.perf_counter() - t_cli,
                   "spatial_parallel": resolved.get("spatial_parallel")}
    ok &= (code == 0 and files == ["checkpoints.json", "ckpt_0.pt",
                                   "resolved_config.json"]
           and resolved.get("spatial_parallel") == 2)
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if not ok:
        raise AssertionError(f"spatial_train: {line}")


def main() -> int:
    import torch

    from pcss_unet_tpu_torch.infer import (InferenceEngine, chw_engine, frame,
                                           load_variables, pad_to_multiple,
                                           tiled)
    from pcss_unet_tpu_torch.io import exr
    from pcss_unet_tpu_torch.models import unet as unet_mod
    from pcss_unet_tpu_torch.models.init import seeded_variables
    from pcss_unet_tpu_torch.ops import resize as resize_mod
    from pcss_unet_tpu_torch.ops.kernels import KERNELS, _build
    from pcss_unet_tpu_torch.ops.kernels import block_int8 as kb8
    from pcss_unet_tpu_torch.ops.kernels import conv3x3_int8 as kc7
    from pcss_unet_tpu_torch.ops.kernels import convblock as kcb
    from pcss_unet_tpu_torch.ops.kernels import convblock128 as kc128
    from pcss_unet_tpu_torch.ops.kernels import deploy
    from pcss_unet_tpu_torch.ops.kernels import fused as kfu
    from pcss_unet_tpu_torch.ops.kernels import resize as kres
    from pcss_unet_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    # the EXR codec (g++) builds beside the kernels (nvcc)
    exr_build = threading.Thread(target=exr._load_native)
    exr_build.start()
    _build.library()
    build_s = time.perf_counter() - t0
    exr_build.join()
    log = _build.build_log()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    sass = sass_counts(str(_build._target()))
    no_ops = {"HMMA": 0, "HGMMA": 0, "IMMA": 0, "IGMMA": 0, "IDP4A": 0}
    bf16_tc = []
    for kernel, src, smem in (
            ("convblock_chw_tc_kernel", "convblock.cu", None),
            ("block128_tc_kernel", "convblock128.cu",
             _build.library().pcss_block128_smem_bytes(128, 64)),
            ("block128_tc_kernel_wgmma", "convblock128_wgmma.cu",
             _build.library().pcss_block128_wgmma_smem_bytes())):
        wgmma = "wgmma" in kernel
        e = next(e for e in ptxas_entries(log, kernel) if ("wgmma" in e["name"]) == wgmma)
        bf16_tc.append({"kernel": f"{src}: {kernel}", "registers": e["registers"],
                        "spill_bytes": e["spill_bytes"], "smem_bytes_per_block": smem,
                        "mma": "HGMMA" if wgmma else "HMMA", **sass.get(e["name"], no_ops)})
    int8 = ptxas_entries(log, "int8_taps_kernel")
    for e, pretty in zip(int8, demangle([e["name"] for e in int8])):
        m = re.search(r"int8_taps_kernel\w*<[^>]*>", pretty)
        src = "block_int8.cu" if "block_int8_cu" in e["name"] else "conv3x3_int8.cu"
        e["kernel"] = f"{src}: {m.group(0) if m else e['name']}"
        e.update(sass.get(e["name"], no_ops))
        # the 3x3 on wgmma (K5's chunked one at four chunks, w64 dec_0), the 1x1
        e["mma"] = "IGMMA" if "wgmma" in e["name"] else "IMMA"
        e["smem_bytes_per_block"] = _build.library().pcss_int8_smem_bytes(
            9 if "wgmma" in e["name"] else 1, 4 if "Lb1E" in e["name"] else 1)
    dp4a = {f: c["IDP4A"] for f, c in sass.items() if c["IDP4A"]}
    own = kernel_names(log)
    emit({"phase": "build", "card": card, "seconds": build_s,
          "exr_codec": "native" if exr._lib is not None else "python",
          "exr_native_error": exr.native_error(),
          "kernel_names": sorted(own),
          "ptxas": ptxas, "bf16_tc_kernels": bf16_tc,
          "int8_kernels": [{k: e[k] for k in ("kernel", "registers", "spill_bytes",
                                              "smem_bytes_per_block", "IMMA", "IGMMA",
                                              "IDP4A")}
                           for e in int8]})
    bad = ([e["kernel"] for e in bf16_tc if e["spill_bytes"] != [0, 0] or not e[e["mma"]]]
           + [e["kernel"] for e in int8 if e["spill_bytes"] != [0, 0] or not e[e["mma"]]])
    if bad or dp4a:
        raise AssertionError(f"tensor-core kernels spilling or without HMMA / HGMMA / IMMA / IGMMA: "
                             f"{bad}; functions with IDP4A: {dp4a}")
    band_copy_phase(log, card, own)

    # every kernel wrapper the forwards call, by the name they call it
    # under, and each one's plain version
    wrappers = {"scrub": (frame, "fused_scrub_standardize"),
                "u8": (frame, "fused_mask_to_u8"),
                "convblock": (chw_engine, "fused_conv_block_chw"),
                "nhwc": (unet_mod, "fused_conv_block_nhwc"),
                "int8": (deploy, "fused_block_int8_nhwc"),
                "kchunked": (deploy, "fused_block_int8_kchunked"),
                "block128": (deploy, "fused_block128_nhwc"),
                "resize": (resize_mod, "banded_resize")}
    # (the resize kernel runs on both sides of w64_vs_plain: it is no TPU
    # kernel's port, and is held to the dense product on its own)
    plain = [(*wrappers["scrub"], kfu.scrub_standardize_plain),
             (*wrappers["u8"], kfu.mask_to_u8_plain),
             (*wrappers["convblock"],
              lambda *a, taps=None, **k: kcb.conv_block_chw_plain(*a, **k)),
             (*wrappers["nhwc"], kcb.conv_block_nhwc_plain),
             (*wrappers["int8"], kb8.block_int8_nhwc_plain),
             (*wrappers["kchunked"], kb8.block_int8_kchunked_plain),
             (*wrappers["block128"], kc128.block128_nhwc_plain)]

    # ------------------------------------------------------------ training
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    train_work = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
    try:
        with torch.inference_mode(False):
            npz, train_stats, train_s = train_phase(train_work, card)
            bench_s = train_bench_phase(card)
            parity_s = train_parity_phase()
            t_bn = time.perf_counter()
            bn_entry = bn_tail_phase(card, own)
            bn_s = time.perf_counter() - t_bn
            t_dp = time.perf_counter()
            os.makedirs(os.path.join(train_work, "dp"))
            dp_single = dp_train_phase(os.path.join(train_work, "dp"), card)
            dp_s = time.perf_counter() - t_dp
        t_serve = time.perf_counter()
        e_trained_nhwc, e_trained_chw, trained_frames, trained_runs = \
            train_to_serve_phase(npz, train_stats, os.path.join(train_work, "data"),
                                 plain, card, own)
        emit({"phase": "train_phases_seconds", "train": train_s, "train_bench": bench_s,
              "train_parity": parity_s, "bn_tail": bn_s, "dp_train": dp_s,
              "train_to_serve": time.perf_counter() - t_serve})
    finally:
        shutil.rmtree(train_work, ignore_errors=True)

    # ------------------------------------- from renders to a trained net
    chain_work = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
    try:
        chain_s, t0 = {}, time.perf_counter()
        with torch.inference_mode(False):
            data_dir, split_dir = data_cli_phase(chain_work, card)
            chain_s["data_cli"] = time.perf_counter() - t0
            ckpt = train_governor_phase(chain_work, data_dir, card)
            chain_s["train_governor"] = time.perf_counter() - t0 - sum(chain_s.values())
            train_cache_phase(chain_work, data_dir, card)
            chain_s["train_cache"] = time.perf_counter() - t0 - sum(chain_s.values())
            grain_phase(chain_work, card)
            chain_s["grain"] = time.perf_counter() - t0 - sum(chain_s.values())
        chain_runs = [temporal_phase(chain_work, card)]
        chain_s["temporal"] = time.perf_counter() - t0 - sum(chain_s.values())
        chain_runs.append(e2e_chain_phase(chain_work, data_dir, split_dir, ckpt, card))
        chain_s["e2e_chain"] = time.perf_counter() - t0 - sum(chain_s.values())
        emit({"phase": "chain_phases_seconds", "card": card, **chain_s,
              "total": time.perf_counter() - t0})
        t_sp = time.perf_counter()
        with torch.inference_mode(False):
            os.makedirs(os.path.join(chain_work, "sp"))
            spatial_train_phase(os.path.join(chain_work, "sp"), data_dir, dp_single, card)
        del dp_single
        emit({"phase": "spatial_train_seconds", "seconds": time.perf_counter() - t_sp})
    finally:
        shutil.rmtree(chain_work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------- engines and inputs
    meta, xv, yv = golden_frames()
    variables = load_variables(os.path.join(REPO, "tests", "golden",
                                            "deploy_w16.npz"))
    stats = dict(means=np.asarray(meta["means"], np.float32),
                 stds=np.asarray(meta["stds"], np.float32))
    kw = dict(fold_bn=True, quantize="int8", dtype=torch.bfloat16,
              device="cuda", **stats)
    engine = InferenceEngine(None, variables, layout="chw", **kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.rand((1, FRAME_H, FRAME_W, 4), generator=gen,
                        device="cuda")
    calls = {"w16_chw": record_calls(lambda: engine.render_u8(frames), [
        (*wrappers[k], k) for k in ("scrub", "convblock", "int8", "u8")])}
    # the tiled CLI's forward: the same frame as 15 tiles of 512 in one batch
    frame_np = frames[0].cpu().numpy()
    calls["w16_tiled"] = record_calls(
        lambda: tiled.infer_tiled(engine, frame_np, tile=TILE, halo=HALO), [
            (*wrappers[k], k) for k in ("scrub", "convblock", "int8")])
    n_tiles = calls["w16_tiled"]["scrub"][0][0][0].shape[0]
    if n_tiles != 15:
        raise AssertionError(f"w16_tiled: K1 saw a batch of {n_tiles} tiles, want 15")

    v64 = seeded_variables(W64, seed=0)
    e64_nhwc = InferenceEngine(None, v64, layout="nhwc", **kw)
    e64_chw = InferenceEngine(None, v64, layout="chw", **kw)
    rng = np.random.default_rng(0)
    f64, _ = pad_to_multiple(rng.random((1, W64_H, W64_W, 4), np.float32),
                             e64_nhwc.pad_multiple)
    frames64 = torch.from_numpy(f64).cuda()
    calls["w64_nhwc"] = record_calls(lambda: e64_nhwc.render_u8(frames64), [
        (*wrappers[k], k) for k in ("scrub", "nhwc", "int8", "kchunked",
                                    "block128", "u8", "resize")])
    calls["w64_chw"] = record_calls(lambda: e64_chw.render_u8(frames64), [
        (*wrappers[k], k) for k in ("scrub", "convblock", "int8", "kchunked",
                                    "u8")])
    # the serving path's batch: 4 distinct 1080p frames through the same
    # NHWC engine, so K1, K2′, K3, K5, K6 and K4 are held at N = 4
    f64_b4, _ = pad_to_multiple(rng.random((SERVE_BATCH, W64_H, W64_W, 4), np.float32),
                                e64_nhwc.pad_multiple)
    calls["w64_serve_b4"] = record_calls(
        lambda: e64_nhwc.render_u8(torch.from_numpy(f64_b4).cuda()), [
            (*wrappers[k], k) for k in ("scrub", "nhwc", "int8", "kchunked",
                                        "block128", "u8")])
    del f64_b4
    # the spatially sharded forward's windows (phase sharded_infer): the
    # NHWC fused+int8 engine on a 1x2 mesh of cuda:0, two windows of 672
    # rows of the frame above (its first 1080 rows; the path pads them)
    raw64 = f64[:, :W64_H]
    calls["w64_sharded"] = record_calls(
        lambda: tiled.infer_sharded(e64_nhwc, raw64, make_mesh(1, 2, devices=["cuda:0"] * 2)),
        [(*wrappers[k], k) for k in ("scrub", "nhwc", "int8", "kchunked", "block128")])
    # the trained w64 net's forwards (phase train_to_serve), one NHWC and
    # one chw frame, as one path: K1, K2, K2', K3, K5, K6, K4
    trained = [record_calls(lambda: e.render_u8(trained_frames), [
        (*wrappers[k], k) for k in keys]) for e, keys in (
            (e_trained_nhwc, ("scrub", "nhwc", "int8", "kchunked", "block128", "u8")),
            (e_trained_chw, ("scrub", "convblock", "int8", "kchunked", "u8")))]
    calls["w64_trained"] = {k: trained[0].get(k, []) + trained[1].get(k, [])
                            for k in wrappers}

    def on(key, *paths):
        """The recorded calls of wrapper ``key`` on each path, headline
        path first; every path that called it must be listed."""
        called = {p for p, c in calls.items() if c.get(key)}
        if called != set(paths):
            raise AssertionError(f"{key}: called on {sorted(called)}, "
                                 f"checked on {sorted(paths)}")
        return [(p, calls[p][key]) for p in paths]

    def first(key, path, i=0):
        return calls[path][key][i]

    # ---------------------------------------------------------- kernels
    all3 = ("w16_chw", "w64_nhwc", "w64_chw")
    all4 = all3 + ("w16_tiled",)
    b4 = "w64_serve_b4"
    tr = "w64_trained"
    sh = "w64_sharded"
    # K1 as each path calls it (entry "chw" / "nhwc", bf16 out), and the
    # reference's own layout (entry None) on the w16 frame; the float32
    # case is the w16 call with float32 out.  Exact: one rounding of the
    # same IEEE steps on both sides.
    scrub_args, scrub_kw = first("scrub", "w16_chw")
    entries = [
        check_kernel("fused_scrub_standardize", kfu.fused_scrub_standardize,
                     kfu.scrub_standardize_plain,
                     on("scrub", *all4, b4, tr, sh) + [("w16_entry_none", [
                         (scrub_args, dict(scrub_kw, entry=None))])],
                     lambda *_: 0.0, scrub_work,
                     (scrub_args, dict(scrub_kw, out_dtype=torch.float32)), own),
        check_kernel("fused_conv_block_chw", kcb.fused_conv_block_chw,
                     kcb.conv_block_chw_plain,
                     on("convblock", "w16_chw", "w64_chw", "w16_tiled", tr), conv_tol,
                     conv_work, f32(first("convblock", "w16_chw", -2)), own),
        # int8 x int8 -> int32 sums are exact in any order, and the kernel
        # takes every float32 step (dequantize, bias, leaky, rounding of h,
        # the band max) as the plain version does: equal, bit for bit
        check_kernel("fused_block_int8_nhwc", kb8.fused_block_int8_nhwc,
                     kb8.block_int8_nhwc_plain, on("int8", *all4, b4, tr, sh),
                     lambda *_: 0.0, int8_work, f32(first("int8", "w16_chw")), own),
        check_kernel("fused_mask_to_u8", kfu.fused_mask_to_u8,
                     kfu.mask_to_u8_plain, on("u8", *all3, b4, tr), lambda *_: 0.0,
                     u8_work, first("u8", "w16_chw"), own),
        # K5: exact as K3, the float32 chunk sums in the same order on both sides
        check_kernel("fused_block_int8_kchunked", kb8.fused_block_int8_kchunked,
                     kb8.block_int8_kchunked_plain,
                     on("kchunked", "w64_nhwc", "w64_chw", b4, tr, sh), lambda *_: 0.0,
                     int8_work, f32(first("kchunked", "w64_nhwc")), own),
        check_kernel("fused_block128_nhwc", kc128.fused_block128_nhwc,
                     kc128.block128_nhwc_plain, on("block128", "w64_nhwc", b4, tr, sh),
                     conv_tol, block128_work, f32(first("block128", "w64_nhwc")), own),
    ]
    xk7 = torch.randn((1, 272, 480, 512), generator=gen, device="cuda").bfloat16()
    wk7 = torch.randint(-127, 127, (9, 512, 512), generator=gen, device="cuda",
                        dtype=torch.int8)
    k_rows, co_tile = kc7.pick_tiles(272, 480, 512, 512)
    k7_call = ((xk7, wk7, torch.full((512,), 1e-3, device="cuda"),
                torch.zeros(512, device="cuda")),
               dict(k_rows=k_rows, co_tile=co_tile, negative_slope=0.2,
                    out_dtype=torch.bfloat16))
    entries += [
        # exact, as K3: the same integers and float32 steps
        check_kernel("conv3x3_int8_nhwc", kc7.conv3x3_int8_nhwc,
                     lambda *a, co_tile=None, **k: kc7.conv3x3_int8_plain(*a, **k),
                     [("w64_dec_1a", [k7_call])], lambda *_: 0.0,
                     conv3x3_int8_work,
                     (f32(k7_call)[0], dict(k7_call[1], out_dtype=torch.float32)), own),
        check_kernel("fused_conv_block_nhwc", kcb.fused_conv_block_nhwc,
                     kcb.conv_block_nhwc_plain, on("nhwc", "w64_nhwc", b4, tr, sh), conv_tol,
                     conv_nhwc_work, f32(first("nhwc", "w64_nhwc", 1)), own),
    ]
    block128_storage(kc128, _build, first("block128", "w64_nhwc"))
    # the banded resize: the w64 frame's eight calls, against the dense
    # product; float32 on the head's W chain
    resize_entry = check_kernel(
        "banded_resize", kres.banded_resize, resize_dense_plain,
        on("resize", "w64_nhwc"), resize_tol, resize_work,
        f32(first("resize", "w64_nhwc", -1)), own)
    del calls
    # a yardstick for K7, not the same function: cuDNN's bf16 conv at its shape
    wbf = wk7.to(torch.bfloat16).permute(2, 1, 0).reshape(512, 512, 3, 3).contiguous()
    xbf = xk7.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    emit({"phase": "kernel_yardstick", "name": "conv3x3_int8_nhwc",
          "bf16_cudnn_conv_ms": cuda_ms(lambda: torch.nn.functional.conv2d(
              xbf, wbf.contiguous(memory_format=torch.channels_last), padding=1))})

    # the constant weight preparation every w64 frame repeats: the int8
    # quantization of the int8 blocks' weights, as deploy.block_nhwc calls it
    int8_blocks = [getattr(e64_nhwc.model, b) for b in ("dec_0", "dec_1")]
    emit({"phase": "weight_prep", "blocks": ["dec_0", "dec_1"],
          "ms_per_frame": cuda_ms(lambda: [deploy.int8_operands(
              b.conv_a.weight.permute(2, 3, 1, 0), b.conv_a.bias,
              b.conv_b.weight.permute(2, 3, 1, 0), b.conv_b.bias)
              for b in int8_blocks])})

    # the w64 forward through the kernels against every kernel's plain version
    for engine64 in (e64_nhwc, e64_chw):
        vs_plain_phase(engine64, frames64, plain, KERNELS)
    for layout, quantize in (("nhwc", "int8"), ("chw", "int8"),
                             ("nhwc", "none")):
        vs_plain_phase(InferenceEngine(
            None, v64, layout=layout, **dict(kw, dtype=torch.float32,
                                             quantize=quantize)),
            frames64, plain, KERNELS)

    sources = {
        "fused_scrub_standardize": ("pcss_unet_tpu_torch/csrc/fused.cu",
                                    "pcss_unet_tpu/ops/pallas/fused.py:57"),
        "fused_conv_block_chw": ("pcss_unet_tpu_torch/csrc/convblock.cu",
                                 "pcss_unet_tpu/ops/pallas/convblock.py:280"),
        "fused_block_int8_nhwc": ("pcss_unet_tpu_torch/csrc/block_int8.cu",
                                  "pcss_unet_tpu/ops/pallas/block_int8.py:112"),
        "fused_mask_to_u8": ("pcss_unet_tpu_torch/csrc/fused.cu",
                             "pcss_unet_tpu/ops/pallas/fused.py:97"),
        "fused_block_int8_kchunked": ("pcss_unet_tpu_torch/csrc/block_int8.cu",
                                      "pcss_unet_tpu/ops/pallas/block_int8.py:241"),
        "fused_block128_nhwc": ("pcss_unet_tpu_torch/csrc/convblock128.cu",
                                "pcss_unet_tpu/ops/pallas/convblock128.py:91"),
        "conv3x3_int8_nhwc": ("pcss_unet_tpu_torch/csrc/conv3x3_int8.cu",
                              "pcss_unet_tpu/ops/pallas/conv3x3_int8.py:116"),
        "fused_conv_block_nhwc": ("pcss_unet_tpu_torch/csrc/convblock.cu",
                                  "pcss_unet_tpu/ops/pallas/convblock.py:428"),
    }

    # ------------------------------------------------ golden, main paths
    golden_phase("golden", variables, meta, xv, yv, "chw")
    runs = [main_path("main_path", engine, frames, MAIN_FRAMES, {
        "fused_scrub_standardize": 1, "fused_conv_block_chw": 6,
        "fused_block_int8_nhwc": 1, "fused_mask_to_u8": 1}, card, own)]
    golden_phase("golden_nhwc", variables, meta, xv, yv, "nhwc")
    runs.append(main_path("main_path_w64_nhwc", e64_nhwc, frames64, W64_FRAMES,
                          W64_NHWC_WANT, card, own))
    runs.append(main_path("main_path_w64_chw", e64_chw, frames64, W64_FRAMES,
                          W64_CHW_WANT, card, own))

    # the spatially sharded forward on 1x2 and 1x4 meshes of this card
    with no_tf32():
        e64_plain = InferenceEngine(None, v64, dtype=torch.float32, device="cuda", **stats)
        runs += sharded_infer_phase(
            [("w64_plain_float32_tf32_off", e64_plain, raw64, 5e-7, {})], card)
    del e64_plain
    e64_fused = InferenceEngine(None, v64, layout="nhwc", **dict(kw, quantize="none"))
    runs += sharded_infer_phase([
        ("w64_nhwc_fused_int8", e64_nhwc, raw64, None, W64_SHARDED_WANT),
        ("w64_chw_int8", e64_chw, raw64, None, W64_SHARDED_WANT),
        ("w64_nhwc_fused_bf16", e64_fused, raw64, 0.0, W64_FUSED_SHARDED_WANT),
        ("w16_chw_int8", engine, frame_np[None], None, None)], card)
    del e64_fused

    runs += trained_runs + chain_runs

    # the user's command: EXR in, PNG out, untiled and tiled; then validate
    work = tempfile.mkdtemp(dir=os.path.join(REPO, "build"))
    try:
        launches, engine_cli, x_cli, mask_cli = cli_infer_phase(
            work, frame_np, stats, card)
        runs.append(launches)
        runs.append(cli_tiled_phase(work, engine_cli, x_cli, mask_cli, card))
        cli_validate_phase(work, xv[0], stats)
        # serving: the streaming server, its CLI, the export of the plain graph
        serve_runs, (dwaa_sources, dwaa_frames) = serve_phase(e64_nhwc, work, card)
        runs += serve_runs
        runs.append(serve_cli_phase(os.path.join(work, "serve_cli"), e64_nhwc, v64,
                                    stats, dwaa_sources, dwaa_frames, card))
        export_phase(v64, kw, frames64, e64_nhwc, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the bench of the postures, inspect, the reference's torch ground truth
    t0 = time.perf_counter()
    runs.append(bench_phase(card))
    inspect_phase(card)
    parity_ref_phase(card)
    emit({"phase": "bench_inspect_parity_seconds", "seconds": time.perf_counter() - t0})

    for e in entries:
        e["route"] = "cuda"
        e["source"], e["replaces"] = sources[e["name"]]
        e["launches"] = sum(r[e["name"]] for r in runs)
    emit({"library_ms_null_because": NO_LIBRARY})
    emit({"resize_kernel": dict(resize_entry, route="cuda",
                                source="pcss_unet_tpu_torch/csrc/resize.cu",
                                replaces="none (the dense apply_matrix product)")})
    emit({"bn_tail_kernel": bn_entry})
    emit({"kernels": [{k: e[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for e in entries]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:      # a rank of phase dp_train
        sys.exit(dp_rank_main(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--sp-rank"]:      # a rank of phase spatial_train
        sys.exit(sp_rank_main(int(sys.argv[2]), sys.argv[3]))
    import torch

    with torch.inference_mode():
        sys.exit(main())
