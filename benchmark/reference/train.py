"""Plain reference of the shadow U-Net's training step (PCSS-Unet's
``main.py`` and ``pert_loss.py`` as the configuration runs them), in plain
PyTorch; it imports nothing of the program under test.

One step on a batch (x raw NHWC [B, H, W, 4], y [B, H, W, 1]):

- standardize: ``(x - mean) / (std + 1e-8)``;
- the train-mode U-Net: every conv in the working precision
  (``compute_dtype``, bfloat16),
  BatchNorm on the batch's statistics in float32 (mean, biased variance,
  eps 1e-5), LeakyReLU 0.2, Dropout2d (``where(mask, x / keep, 0)``, rate
  0.2, half that in ``dec_final``), 2x2 average pools, align-corners 2x
  upsamples as products with the interpolation matrix, additive skips, the
  head's up-and-back resize pair as one matrix per axis, pixel shuffle,
  sigmoid;
- the loss ``0.9 L1 + 0.1 VGG + 0.1 perturbation``: the VGG term is L1
  between VGG-19 features (conv1_2, conv2_2, conv3_2, conv4_2, conv5_2,
  weights 0.25, 0.25, 0.3, 0.1, 0.1) of the scrubbed, clipped, 3-channel,
  ImageNet-normalized mask and target, without gradient (the original's
  branch is gradient-dead); the perturbation term is the mean |output -
  output of a noisy copy| over 3 copies run without gradient, each with
  its own batch statistics and the step's second set of dropout masks,
  noise ``N(0, 1) * 0.01 * channel std`` (Bessel-corrected);
- the gradient, clipped to global norm 1 (``min(1, 1 / (norm + 1e-6))``)
  for the first half of training;
- AdamW (0.9, 0.999, eps 1e-8, decoupled weight decay 1e-3) with a linear
  warm-up of the learning rate over ``warmup_epochs`` epochs, then cosine
  decay.

Randomness: the step draws from a ``torch.Generator`` on the batch's device
seeded with the step's seed, in the order the configuration's step defines:
a uniform [B, C, 1, 1] per ConvBlock with dropout (block order) for the
masks, the same again for the perturbed copies' masks, then the noise
[3, B, H, W, 4].  Given the same seed, it draws the same numbers.

``precision="fp8"`` runs every conv's input and kernel through float8 e4m3
(one scale per tensor, straight-through gradient): the control.  Blocks are
checkpointed (recomputed in the backward pass) so that the reference fits
beside what the run keeps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.unet import chain, fp8, interp_matrix, leaky, widths_of

B1, B2, EPS = 0.9, 0.999, 1e-8
BN_EPS = 1e-5
VGG_TAPS = (2, 7, 12, 21, 30)
VGG_TAP_WEIGHTS = (0.25, 0.25, 0.3, 0.1, 0.1)
VGG_POOLS = (4, 9, 18, 27)
CHUNK_PIXELS = 1 << 22


def _ste(q):
    """``q`` in the forward pass, identity in the backward pass."""
    return lambda t: t + (q(t) - t).detach()


class Net:
    """The train-mode U-Net over a dict of float32 parameters."""

    def __init__(self, params: dict, dropout: float, precision: str,
                 dtype: torch.dtype = torch.bfloat16):
        self.p = params
        self.dtype = dtype
        self.widths = widths_of(params)
        self.dropout = dropout
        self.q = _ste(fp8) if precision == "fp8" else (lambda t: t)

    def blocks(self):
        d = len(self.widths)
        return ([f"enc_{i}" for i in range(d)] + [f"dec_{i}" for i in range(d - 1)]
                + ["dec_final"])

    def rate(self, name):
        return self.dropout / 2 if name == "dec_final" else self.dropout

    def masks(self, batch, gen, device):
        out = {}
        for name in self.blocks():
            cin = self.p[f"{name}.conv_a.weight"].shape[1]
            u = torch.rand((batch, cin, 1, 1), generator=gen, device=device)
            out[name] = u < 1.0 - self.rate(name)
        return out

    def conv(self, x, name, padding):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        return F.conv2d(self.q(x.float()).to(self.dtype),
                        self.q(w).to(self.dtype), b.to(self.dtype),
                        padding=padding)

    def bn(self, x, name):
        x = x.float()
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.p[f"{name}.weight"]
        return (x - mean[:, None, None]) * mul[:, None, None] + self.p[f"{name}.bias"][:, None, None]

    def block(self, x, name, mask):
        x = leaky(self.bn(self.conv(x, f"{name}.conv_a", 1), f"{name}.norm_a")).to(self.dtype)
        keep = 1.0 - self.rate(name)
        x = torch.where(mask, x / keep, torch.zeros_like(x))
        x = leaky(self.bn(self.conv(x, f"{name}.conv_b", 0), f"{name}.norm_b"))
        return x.to(self.dtype)

    def resize(self, x, mh, mw):
        th = torch.as_tensor(mh, dtype=torch.float32, device=x.device).to(self.dtype).float()
        tw = torch.as_tensor(mw, dtype=torch.float32, device=x.device).to(self.dtype).float()
        x = torch.einsum("oh,nchw->ncow", th, x.float()).to(self.dtype)
        return torch.einsum("ow,nchw->ncho", tw, x.float()).to(self.dtype)

    def forward(self, x, masks, remat: bool):
        """Standardized NHWC frames -> the float32 sigmoid mask NHWC."""
        n, h, w, c = x.shape
        x = x.to(self.dtype).reshape(n, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 5, 2, 4, 1, 3).reshape(n, c * 4, h // 2, w // 2)

        def run(name, t):
            if remat:
                return checkpoint(self.block, t, name, masks[name], use_reentrant=False)
            return self.block(t, name, masks[name])

        d = len(self.widths)
        skips = []
        for i in range(d - 1):
            x = run(f"enc_{i}", x)
            skips.append(x)
            n_, c_, hh, ww = x.shape
            x = x.reshape(n_, c_, hh // 2, 2, ww // 2, 2).mean(dim=(3, 5))
        x = run(f"enc_{d - 1}", x)
        for i, skip in enumerate(reversed(skips)):
            hh, ww = x.shape[2:]
            x = self.resize(x, interp_matrix(hh, 2 * hh), interp_matrix(ww, 2 * ww))
            x = run(f"dec_{i}", x) + skip
        hh, ww = x.shape[2:]
        x = self.resize(x, chain((hh, 2 * hh, hh)), chain((ww, 2 * ww, ww)))
        x = run("dec_final", x)
        x = self.conv(x, "head", 0)
        n_, c4, hh, ww = x.shape
        x = x.reshape(n_, c4 // 4, 2, 2, hh, ww).permute(0, 4, 2, 5, 3, 1)
        return torch.sigmoid(x.reshape(n_, hh * 2, ww * 2, c4 // 4).float())


def vgg_loss(out, tgt, vgg: dict) -> torch.Tensor:
    """The perceptual term (no gradient), in float32."""
    def scrub(t):
        return torch.clamp(torch.nan_to_num(t.float(), nan=0.5, posinf=1.0, neginf=0.0), 0.0, 1.0)

    out, tgt = scrub(out), scrub(tgt)
    n, h, w = out.shape[:3]
    per = max(1, CHUNK_PIXELS // (h * w))
    sums = [0.0] * len(VGG_TAPS)
    counts = [0] * len(VGG_TAPS)
    with torch.no_grad():
        for i in range(0, n, per):
            both = torch.cat([out[i:i + per], tgt[i:i + per]])
            k = both.shape[0] // 2
            f = (both.permute(0, 3, 1, 2).repeat(1, 3, 1, 1) - 0.485) / (0.229 + 1e-8)
            j = 0
            for idx in range(max(VGG_TAPS) + 1):
                if f"conv_{idx}" in vgg:
                    f = F.conv2d(f, vgg[f"conv_{idx}"]["weight"], vgg[f"conv_{idx}"]["bias"], padding=1)
                elif idx in VGG_POOLS:
                    f = F.max_pool2d(f, 2, 2)
                else:
                    f = F.relu(f)
                if idx in VGG_TAPS:
                    t = torch.nan_to_num(f, nan=0.0, posinf=1.0, neginf=-1.0)
                    sums[j] = sums[j] + torch.sum(torch.abs(t[:k] - t[k:]))
                    counts[j] += t[:k].numel()
                    j += 1
    total = torch.zeros((), device=out.device)
    wsum = sum(VGG_TAP_WEIGHTS)
    for wt, s, c in zip(VGG_TAP_WEIGHTS, sums, counts):
        total = total + (wt / wsum) * (s / c)
    return total


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's generator: a function of (run seed, step)."""
    return (seed + 1) * 1_000_003 + step


def learning_rate(step: int, steps_per_epoch: int, tc: dict) -> float:
    """Linear warm-up over ``warmup_epochs`` epochs, then cosine decay to
    1 % of the base rate at ``num_epochs``."""
    warm = max(1, tc["warmup_epochs"] * steps_per_epoch)
    total = max(warm + 1, tc["num_epochs"] * steps_per_epoch)
    if step < warm:
        return tc["learning_rate"] * step / warm
    progress = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return tc["learning_rate"] * max(0.5 * (1 + math.cos(math.pi * progress)),
                                     tc["lr_floor_fraction"])


def clip_norm(step: int, steps_per_epoch: int, tc: dict) -> float:
    """Global-norm clip: 1 for the first half of training, then
    ``max(0.1, 1 - epoch / num_epochs)``."""
    ratio = step / steps_per_epoch / max(1, tc["num_epochs"])
    if ratio < 0.5 or not tc["grad_clip_decay"]:
        return tc["grad_clip_norm"]
    return max(0.1, 1.0 - ratio)


def run_steps(params0: dict, vgg: dict, batches, seeds, means, stds, tc: dict,
              steps_per_epoch: int, precision: str = "bf16") -> dict:
    """``len(batches)`` reference steps from ``params0`` (name -> float32
    tensor; BatchNorm running statistics ignored: the train-mode forward
    does not read them).  -> {"losses": [...], "grad1": {name: norm of the
    first step's clipped gradient}, "change": {name: norm of the change
    after the last step}}."""
    names = [k for k in params0 if "running_" not in k]
    p = {k: params0[k].detach().clone().float().requires_grad_(True) for k in names}
    net = Net(p, tc["dropout_rate"], precision, getattr(torch, tc["compute_dtype"]))
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    dev = next(iter(p.values())).device
    m = torch.as_tensor(np.asarray(means), dtype=torch.float32, device=dev)
    s = torch.as_tensor(np.asarray(stds), dtype=torch.float32, device=dev)
    losses, grad1 = [], None
    gen = torch.Generator(device=dev)
    for count, ((x_raw, y), seed) in enumerate(zip(batches, seeds)):
        gen.manual_seed(seed)
        x = (x_raw.float() - m) / (s + 1e-8)
        y = y.float()
        b = x.shape[0]
        masks = net.masks(b, gen, dev)
        pmasks = net.masks(b, gen, dev)
        out = net.forward(x, masks, remat=True)
        l1 = torch.mean(torch.abs(out - y))
        vl = vgg_loss(out, y, vgg)
        with torch.no_grad():
            noise = torch.randn((tc["perturbation_count"], *x.shape), generator=gen,
                                device=dev, dtype=torch.float32)
            std = torch.std(x, dim=(0, 1, 2), correction=1)
            outs = torch.stack([net.forward(x + noise[i] * std * 0.01, pmasks, remat=False)
                                for i in range(noise.shape[0])])
        pert = torch.mean(torch.abs(out[None] - outs))
        a = tc["alpha"]
        total = a * l1 + (1 - a) * vl + tc["perturb_weight"] * pert
        g = torch.autograd.grad(total, [p[k] for k in names])
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in g))
            scale = torch.clamp(clip_norm(count, steps_per_epoch, tc) / (gnorm + 1e-6), max=1.0)
            g = [t * scale for t in g]
            g = [torch.where(torch.isnan(t), torch.zeros_like(t), t) for t in g]
            if grad1 is None:
                grad1 = {k: float(t.norm()) for k, t in zip(names, g)}
            lr = learning_rate(count, steps_per_epoch, tc)
            c = count + 1
            for k, t in zip(names, g):
                mu[k] = B1 * mu[k] + (1 - B1) * t
                nu[k] = B2 * nu[k] + (1 - B2) * t * t
                u = (mu[k] / (1 - B1 ** c)) / (torch.sqrt(nu[k] / (1 - B2 ** c)) + EPS)
                u = u + tc["weight_decay_adamw"] * p[k]
                p[k] -= lr * u
        losses.append(float(total.detach()))
        del out, outs, g
    change = {k: float((p[k].detach() - params0[k].float()).norm()) for k in names}
    return {"losses": losses, "grad1": grad1, "change": change}
