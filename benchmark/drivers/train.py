"""The reference training step over batches from the device cache.

The traffic (``workloads/<cell>.json``): ``cache_frames`` seeded G-buffer
frames of ``frame_h`` x ``frame_w`` and their shadows, uploaded once into
the program's device cache (``data/device_cache.py``), batches of the
configuration's ``batch_size`` drawn by the program's seeded ``Loader``
plan epoch after epoch (``train``'s path when the packs fit on the card),
each through ``train/step.py::build_train_step`` with the configuration's
settings and a generator seeded per step.  Set-up builds the one train
state, drives it through its first ``check_steps`` steps (which also warm
up every shape), and hands it to the window; ``trace_steps`` steps make the
traced segment.

End-to-end: ``train_step_ms``, the window over its steps (the window ends
once the device has finished them); ``train_peak_gb``, the most memory
allocated during the window (``max_memory_allocated`` after a reset at its
start, in 1e9 bytes); ``setup_s``.

``correct``: the reference (``reference/train.py``) follows the first
``check_steps`` steps from the same weights, batches and step seeds.
Read: each step's loss (the worst step's relative gap), the norm of the
first step's gradient as the optimizer received it (from its first moment
after one step), and the norm of each parameter's change after the last of
them, each leaf's gap taken against the reference's norm of that leaf or of
the median leaf, whichever is larger: the worst leaf's gradient gap, and
the worst and the median leaf's change gap.  Leaves whose reference
gradient is under a thousandth of the median leaf's move under Adam by
round-off alone; their change is left out.  The workload's ``limits`` name
the numbers compared (the median leaf's change: the worst leaf is a
pre-BatchNorm conv bias, whose gradient is rounding noise, on some seeds).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from benchmark import flops, harness, inputs, peaks
from benchmark import trace as tracing
from benchmark.reference import train as ref

VGG_CONVS = [(i, cin, cout) for i, cin, cout, _ in flops.VGG_TO_30]


class _Frames:
    """The cache's source: frames made on the card, copied to the host
    once (the device cache uploads from the host, as ``train`` does)."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor):
        both = torch.cat([x, y], dim=-1).cpu().numpy()
        self.inputs, self.labels = both[..., :4], both[..., 4:]
        self.sample_hw = tuple(x.shape[1:3])

    def __len__(self):
        return len(self.inputs)

    def gather(self, idx):
        return self.inputs[idx], self.labels[idx]


def _program(cfg, wl, weights, vgg, frames, means, stds, seed, device):
    """The program's train state, step and batch stream."""
    from pcss_unet_tpu_torch.config import Config
    from pcss_unet_tpu_torch.data.device_cache import DeviceCache
    from pcss_unet_tpu_torch.data.pipeline import Loader
    from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
    from pcss_unet_tpu_torch.models.unet import UNet
    from pcss_unet_tpu_torch.train.state import create_train_state
    from pcss_unet_tpu_torch.train.step import build_train_step

    tc = cfg["train"]
    pc = Config(**tc)
    with torch.device("meta"):
        model = UNet(encoder_widths=tuple(cfg["encoder_widths"]),
                     dropout_rate=tc["dropout_rate"], activation=tc["activation"],
                     normalization=tc["normalization"],
                     dtype=getattr(torch, tc["compute_dtype"]))
    model = model.to_empty(device=device)
    sd = {k: weights[k] if k in weights else torch.zeros_like(v)
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    model.train()
    loader = Loader(frames, tc["batch_size"], shuffle=True, seed=seed)
    spe = loader.batches_per_epoch()
    cache = DeviceCache(frames, device=device)
    host_vgg = {k: {"kernel": v["weight"].permute(2, 3, 1, 0).cpu().numpy(),
                    "bias": v["bias"].cpu().numpy()} for k, v in vgg.items()}
    bundle = LossBundle(perceptual=PerceptualLoss(params=host_vgg, grad=tc["vgg_grad"],
                                                  device=device),
                        alpha=tc["alpha"], perturb_weight=tc["perturb_weight"],
                        perturbation_count=tc["perturbation_count"])
    state = create_train_state(model, pc, spe)
    step = build_train_step(pc, bundle, means, stds, spe)

    def stream():
        for epoch in itertools.count():
            plan = loader.epoch_indices(epoch)
            for b, (x, y) in enumerate(cache.batches(loader, epoch)):
                yield plan[b], x, y
    return state, step, stream(), spe


def _gaps(prog: dict, refv: dict, keep) -> list[float]:
    """Each leaf's |program norm - reference norm| / max(reference norm,
    median reference norm), over the leaves in ``keep``."""
    med = float(np.median([refv[k] for k in keep]))
    return [abs(prog[k] - refv[k]) / max(refv[k], med) for k in keep]


def readings(prog: dict, refr: dict) -> dict:
    """The numbers compared, from the program's and the reference's first
    steps (``losses``, ``grad1``, ``change``): the worst step's relative
    loss gap, the worst leaf's gap of the first gradient, and the worst and
    the median leaf's gap of the change."""
    names = list(refr["grad1"])
    med = float(np.median([refr["grad1"][k] for k in names]))
    moved = [k for k in names if refr["grad1"][k] >= 1e-3 * med]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], refr["losses"]))
    change = _gaps(prog["change"], refr["change"], moved)
    worst = moved[int(np.argmax(change))]
    return {"loss_gap": loss, "grad1_gap": max(_gaps(prog["grad1"], refr["grad1"], names)),
            "change_gap": max(change), "change_gap_median": float(np.median(change)),
            # which leaf the worst change is, and its gradient against the median's
            "change_worst_leaf": worst,
            "change_worst_grad_share": refr["grad1"][worst] / med}


def first_steps(state, step, stream, n, seed, device):
    """The first ``n`` steps through the window's own call and feed, with
    what the comparison needs: → (losses, first gradient's leaf norms,
    leaf norms of the change, batch indices, step seeds)."""
    names = [k for k, _ in state.model.named_parameters()]
    p0 = [p.detach().clone() for p in state.params]
    losses, batches, seeds = [], [], []
    grad1 = None
    for i in range(n):
        idx, x, y = next(stream)
        s = ref.step_seed(seed, i)
        gen = torch.Generator(device=device).manual_seed(s)
        m = step(state, x, y, gen)
        losses.append(m["total_loss"])
        batches.append(torch.as_tensor(idx, device=x.device))
        seeds.append(s)
        if i == 0:
            grad1 = [t.norm() / (1 - ref.B1) for t in state.opt_state["mu"]]
    change = [(p.detach() - q).norm() for p, q in zip(state.params, p0)]
    host = torch.stack([*(t.float() for t in losses), *grad1, *change]).cpu().tolist()
    k = len(names)
    prog = {"losses": host[:n], "grad1": dict(zip(names, host[n:n + k])),
            "change": dict(zip(names, host[n + k:]))}
    return prog, batches, seeds



def run(wl: dict, cfg: dict, *, seed: int, seconds: float, trace: bool,
        device, t_start: float, fault_of=None) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tc = cfg["train"]
    widths = tuple(cfg["encoder_widths"])
    weights = inputs.unet_weights(widths, gen, dev, style="train")
    vgg = inputs.vgg_weights(gen, dev, VGG_CONVS)
    x_all, y_all = inputs.gbuffer_frames(wl["cache_frames"], tc["image_height"],
                                         tc["image_width"], gen, dev)
    means, stds = inputs.channel_stats(x_all)
    frames = _Frames(x_all, y_all)
    phases = {"start_and_inputs": harness.clock() - t_start}
    state, step, stream, spe = _program(cfg, wl, weights, vgg, frames, means,
                                        stds, seed, dev)
    if fault_of is not None:            # the tests' and calibration's faults
        step = fault_of(step)
    phases["state"] = harness.clock() - t_start - sum(phases.values())
    prog, batches, seeds = first_steps(state, step, stream, wl["check_steps"],
                                       seed, dev)
    harness.synchronize(dev)
    setup_s = harness.clock() - t_start
    phases["first_steps"] = setup_s - sum(phases.values())
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n0 = wl["check_steps"]
    waits, n = [], 0
    t0 = harness.clock()
    while harness.clock() - t0 < seconds:
        tw = harness.clock()
        _, x, y = next(stream)
        waits.append(harness.clock() - tw)
        g = torch.Generator(device=dev).manual_seed(ref.step_seed(seed, n0 + n))
        step(state, x, y, g)
        n += 1
    harness.synchronize(dev)
    elapsed = harness.clock() - t0
    window_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    b, h, w = tc["batch_size"], tc["image_height"], tc["image_width"]
    unet = flops.unet_macs(widths, h, w) * b
    step_flop = 2.0 * (unet * (3 + tc["perturbation_count"]) + flops.vgg_macs(h, w) * 2 * b)
    step_ms = elapsed * 1e3 / n
    record = {"setup_s": setup_s, "setup_phases": phases, "train_step_ms": step_ms,
              "train_peak_gb": window_peak / 1e9,
              "data_wait_ms": float(np.mean(waits)) * 1e3,
              "mfu": 100.0 * step_flop / (step_ms * 1e-3) / peaks.BF16_FLOPS}
    trace_rec = breakdown = None
    if trace:
        k = wl["trace_steps"]

        def steps():
            for i in range(k):
                with tracing.span("next_batch"):
                    _, x, y = next(stream)
                g = torch.Generator(device=dev).manual_seed(ref.step_seed(seed, n0 + n + i))
                with tracing.span("train_step"):
                    step(state, x, y, g)
        trace_rec = tracing.segment(steps, k, {})
        n += 2 * k
        record["trace"] = trace_rec
        breakdown = trace_rec["breakdown"]
    info = harness.device_info(dev, trace_rec)
    info["memory_peak_bytes"] = int(max(setup_peak, window_peak, info["memory_peak_bytes"]))

    del state, step, stream
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = harness.clock()
    with harness.no_tf32():
        refr = ref.run_steps(weights, vgg, [(x_all[idx], y_all[idx]) for idx in batches],
                             seeds, means, stds, tc, spe)
    got = readings(prog, refr)
    got["check_s"] = harness.clock() - t_check
    checks, correct = harness.judge(got, wl["limits"])
    return {"record": record, "checks": checks, "readings": got,
            "correct": correct, "attempted": n0 + n, "failed": 0,
            "device": info, "breakdown": breakdown}
