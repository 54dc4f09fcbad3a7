"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size (not run by the benchmark's runs):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 [--program]

For each seed, the control: the reference computed one precision below the
configuration's (float8 e4m3 for bfloat16 stored values and convolutions,
int4 in the int8 blocks), compared with the reference as a run compares
the program; and each fault the cell can have, planted in the program's
timed path (a render cell: an answer altered where it is produced; the
training cell: a step that leaves its state unchanged, and half of the
batch left out).  ``--program`` adds a short run of the cell itself per
seed (its readings are the lower ones).  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness, inputs  # noqa: E402
from benchmark.drivers import render, train  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.reference import unet as ref_unet  # noqa: E402


def altered(render_fn):
    """Fault: every mask's top eighth of rows inverted where it is made."""
    def fn(x):
        out = render_fn(x)
        rows = out.shape[1] // 8
        return torch.cat([255 - out[:, :rows], out[:, rows:]], dim=1)
    return fn


def unchanged(step):
    """Fault: the step computes, and its state comes back as it was."""
    def fn(state, x, y, gen):
        keep = [p.detach().clone() for p in state.params]
        opt = {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
               for k, v in state.opt_state.items()}
        m = step(state, x, y, gen)
        with torch.no_grad():
            for p, q in zip(state.params, keep):
                p.copy_(q)
            for k, v in opt.items():
                if isinstance(v, list):
                    for a, b in zip(state.opt_state[k], v):
                        a.copy_(b)
                else:
                    state.opt_state[k].copy_(v)
        return m
    return fn


def half_batch(step):
    """Fault: half of the batch left out, the mean taken over the rest."""
    def fn(state, x, y, gen):
        b = x.shape[0] // 2
        return step(state, x[:b], y[:b], gen)
    return fn


def render_control(wl, cfg, seed, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    widths = tuple(cfg["encoder_widths"])
    weights = inputs.unet_weights(widths, gen, dev, style="deploy")
    ring, means, stds = render._ring(wl, gen, dev)
    int8 = cfg["inference"]["quantize"] == "int8"
    h = wl["frame_h"]
    worst = dict.fromkeys(("mask_mad_codes", "mask_far_share", "floor_mad_codes",
                           "mask_mad_ratio", "fp8_int8_mad_codes"), 0.0)

    def u8(slot, **kw):
        return ref_unet.to_u8(ref_unet.mask(weights, ring[slot], means, stds,
                                            int8=int8, **kw))[:, :h]

    def mad(a, b):
        return (a.to(torch.int16) - b.to(torch.int16)).abs().float().reshape(a.shape[0], -1)

    with harness.no_tf32():
        for slot in range(min(len(ring), 3)):
            r = u8(slot)
            d = mad(u8(slot, precision="fp8", qmax=7), r)
            floor = mad(u8(slot, precision="fp32"), r).mean(1)
            ratio = d.mean(1) / torch.clamp(floor, min=0.01)
            for k, v in (("mask_mad_codes", d.mean(1).max()),
                         ("mask_far_share", (d > 8).float().mean(1).max()),
                         ("floor_mad_codes", floor.max()), ("mask_mad_ratio", ratio.max()),
                         ("fp8_int8_mad_codes",
                          mad(u8(slot, precision="fp8"), r).mean(1).max())):
                worst[k] = max(worst[k], float(v))
    return worst


def train_control(wl, cfg, seed, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    tc = cfg["train"]
    widths = tuple(cfg["encoder_widths"])
    weights = inputs.unet_weights(widths, gen, dev, style="train")
    vgg = inputs.vgg_weights(gen, dev, train.VGG_CONVS)
    x_all, y_all = inputs.gbuffer_frames(wl["cache_frames"], tc["image_height"],
                                         tc["image_width"], gen, dev)
    means, stds = inputs.channel_stats(x_all)
    from pcss_unet_tpu_torch.data.pipeline import Loader

    class Count:            # the Loader's plan needs the dataset's length only
        def __len__(self):
            return wl["cache_frames"]
    loader = Loader(Count(), tc["batch_size"], shuffle=True, seed=seed)
    spe = loader.batches_per_epoch()
    plan = np.concatenate([loader.epoch_indices(e) for e in range(2)])[:wl["check_steps"]]
    batches = [(x_all[torch.as_tensor(i, device=dev)], y_all[torch.as_tensor(i, device=dev)])
               for i in plan]
    seeds = [ref_train.step_seed(seed, i) for i in range(wl["check_steps"])]
    with harness.no_tf32():
        r = ref_train.run_steps(weights, vgg, batches, seeds, means, stds, tc, spe)
        c = ref_train.run_steps(weights, vgg, batches, seeds, means, stds, tc, spe,
                                precision="fp8")
    return train.readings(c, r)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    drv = harness.driver(wl["driver"])
    dev = torch.device("cuda")
    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed}
        t = time.perf_counter()
        if wl["driver"] == "render":
            line["control"] = render_control(wl, cfg, seed, dev)
            faults = {"altered": dict(render_fault=altered)}
        else:
            line["control"] = train_control(wl, cfg, seed, dev)
            faults = {"unchanged": dict(fault_of=unchanged), "half_batch": dict(fault_of=half_batch)}
        torch.cuda.empty_cache()
        for name, kw in faults.items():
            out = drv.run(wl, cfg, seed=seed, seconds=args.seconds, trace=False,
                          device=dev, t_start=time.perf_counter(), **kw)
            line[name] = out["readings"]
            torch.cuda.empty_cache()
        if args.program:
            out = drv.run(wl, cfg, seed=seed, seconds=args.seconds, trace=False,
                          device=dev, t_start=time.perf_counter())
            line["program"] = out["readings"]
            torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
