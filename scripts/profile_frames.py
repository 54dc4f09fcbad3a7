#!/usr/bin/env python3
"""Count and time the device work of a frame on each main path of the
PyTorch/CUDA port, to compare two checkouts of it on one card.

    python3 scripts/profile_frames.py                 # this checkout
    python3 scripts/profile_frames.py --repo DIR      # the checkout at DIR

Imports ``pcss_unet_tpu_torch`` from DIR (its kernels are built there at
first use), builds the three main-path engines as ``chip_smoke.py`` does
(the committed w16 net through chw+int8 at 2048×1024; the w64 net
``(64, 128, 512, 1024)`` with seeded weights through NHWC and chw fused+int8
at 1920×1080 padded to 1088 rows; bf16, the same seeded frames), warms each
up, and prints one JSON line per path: ms per frame on the host clock over
``--frames`` frames, then for each of ``--profiles`` frames under
torch.profiler the device events (kernels, copies, memsets) it launched,
the device busy ms with and without the host-to-device copies (whose time
follows the host), and the events counted by name.  The last line is the
card's name and power limit.  Run it on both checkouts in one call, in
turns (parent, change, change, parent).  Needs a CUDA device; exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# this checkout's chip_smoke.py for the profiling helpers, imported before
# --repo goes on the path (the other checkout may have its own)
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import card_line, dev_ms, device_events  # noqa: E402


def profile_path(name, engine, frames, n_frames: int, n_profiles: int) -> dict:
    import torch

    for _ in range(2):
        engine.render_u8(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        engine.render_u8(frames)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / n_frames * 1e3
    profiles = []
    for _ in range(n_profiles):
        events, _ = device_events(lambda: engine.render_u8(frames), ("scrub_",))
        by_name = {}
        for e in events:    # names cut to 100 characters, their events summed
            count, ms = by_name.get(e.key[:100], (0, 0.0))
            by_name[e.key[:100]] = (count + e.count, ms + dev_ms(e))
        profiles.append({
            "device_launches": sum(e.count for e in events),
            "device_busy_ms": sum(dev_ms(e) for e in events),
            "device_busy_ms_without_htod": sum(dev_ms(e) for e in events
                                               if "HtoD" not in e.key),
            "by_name": by_name})
    return {"path": name, "frame_ms": frame_ms, "profiles": profiles}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE, help="checkout whose port to run")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--profiles", type=int, default=3)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import torch

    if not torch.cuda.is_available():
        print("profile_frames: no CUDA device", file=sys.stderr)
        return 2
    from pcss_unet_tpu_torch.infer import (InferenceEngine, load_variables,
                                           pad_to_multiple)
    from pcss_unet_tpu_torch.models.init import seeded_variables

    with open(os.path.join(repo, "tests", "golden", "deploy_w16.json")) as f:
        meta = json.load(f)
    kw = dict(fold_bn=True, quantize="int8", dtype=torch.bfloat16, device="cuda",
              means=np.asarray(meta["means"], np.float32),
              stds=np.asarray(meta["stds"], np.float32))
    w16 = load_variables(os.path.join(repo, "tests", "golden", "deploy_w16.npz"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.rand((1, 1024, 2048, 4), generator=gen, device="cuda")
    v64 = seeded_variables((64, 128, 512, 1024), seed=0)
    f64, _ = pad_to_multiple(np.random.default_rng(0).random((1, 1080, 1920, 4),
                                                             np.float32), 16)
    frames64 = torch.from_numpy(f64).cuda()
    with torch.inference_mode():
        for name, variables, layout, x in (("w16_chw", w16, "chw", frames),
                                           ("w64_nhwc", v64, "nhwc", frames64),
                                           ("w64_chw", v64, "chw", frames64)):
            engine = InferenceEngine(None, variables, layout=layout, **kw)
            line = profile_path(name, engine, x, args.frames, args.profiles)
            print(json.dumps({"repo": repo, **line}), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
