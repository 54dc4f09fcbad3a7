"""Torch-side VGG-19 feature tower + weight conversion (parity harness;
the port's copy of ``pcss_unet_tpu/parity/vgg_torch.py``).

The reference's perceptual loss taps torchvision ``vgg19.features`` at
layer indices 2/7/12/21/30 (customLoss.py:8, 20-31).  torchvision is not
installed on this image, but torch is — so this module builds the public
``vgg19.features`` layer sequence in raw torch (Conv2d 3x3 pad 1 / ReLU /
MaxPool2d 2x2, VGG configuration "E") with indices identical to
torchvision's, which lets us:

- validate the OIHW→HWIO conversion pipeline end-to-end against a live
  torch forward (tests/test_vgg_convert.py), and
- convert any vgg19.features-shaped state dict (including the real
  IMAGENET1K_V1 one, via scripts/convert_vgg_weights.py on a dev machine).

The layer table is the port's tower's (``models/vgg.py``), so the index
contract cannot drift between the two implementations.
"""

from __future__ import annotations

import numpy as np

from pcss_unet_tpu_torch.models.vgg import VGG19_CONVS, VGG19_POOLS

# torchvision vgg19.features has indices 0..36 (last ReLU at 35, pool at 36)
N_FEATURE_LAYERS = 37


def build_vgg19_features_torch():
    """→ ``torch.nn.Sequential`` with torchvision's exact vgg19.features
    layer order and indices (randomly initialized)."""
    import torch.nn as nn

    convs = dict(VGG19_CONVS)
    layers = []
    in_ch = 3
    for idx in range(N_FEATURE_LAYERS):
        if idx in convs:
            layers.append(nn.Conv2d(in_ch, convs[idx], kernel_size=3,
                                    padding=1))
            in_ch = convs[idx]
        elif idx in VGG19_POOLS:
            layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
        else:
            layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


def convert_features_module(seq) -> dict[str, np.ndarray]:
    """Convert a vgg19.features-shaped ``nn.Sequential`` to the .npz key
    layout ``models.vgg.load_vgg_params`` consumes: ``conv_{idx}_kernel``
    (HWIO) / ``conv_{idx}_bias`` per conv layer."""
    out: dict[str, np.ndarray] = {}
    for idx, layer in enumerate(seq):
        w = getattr(layer, "weight", None)
        if w is None or w.dim() != 4:
            continue
        w = w.detach().cpu().numpy()                     # OIHW
        out[f"conv_{idx}_kernel"] = np.ascontiguousarray(
            np.transpose(w, (2, 3, 1, 0)))               # → HWIO
        out[f"conv_{idx}_bias"] = layer.bias.detach().cpu().numpy()
    return out


def load_features_npz_into_torch(seq, npz) -> None:
    """Inverse of ``convert_features_module``: load ``conv_{idx}_kernel``
    (HWIO) / ``conv_{idx}_bias`` arrays into the torch tower's convs.
    Convs beyond the npz's deepest key keep their init (the npz may be
    truncated at ``max(taps)``)."""
    import torch

    with torch.no_grad():
        for idx, layer in enumerate(seq):
            key = f"conv_{idx}_kernel"
            if getattr(layer, "weight", None) is None or key not in npz:
                continue
            w = np.transpose(np.asarray(npz[key]), (3, 2, 0, 1))  # HWIO→OIHW
            layer.weight.copy_(torch.as_tensor(np.ascontiguousarray(w)))
            layer.bias.copy_(
                torch.as_tensor(np.asarray(npz[f"conv_{idx}_bias"])))


def reference_vgg_loss_torch(seq, output_nhwc, target_nhwc,
                             taps=(2, 7, 12, 21, 30),
                             tap_weights=(0.25, 0.25, 0.3, 0.1, 0.1)) -> float:
    """The reference ``MultiLayerVGGLoss`` semantics (customLoss.py:7-90),
    written against the raw-torch tower: scrub non-finite (nan→0.5, +inf→1,
    −inf→0), clamp to [0,1], repeat gray→3ch, normalize (x−0.485)/(0.229+1e-8),
    per-tap L1 on features, blend with the weights normalized to sum 1.
    Ground truth for loss-VALUE parity of losses/vgg.py."""
    import torch

    def prep(x_nhwc):
        x = torch.as_tensor(np.asarray(x_nhwc, np.float32)).permute(0, 3, 1, 2)
        x = torch.nan_to_num(x, nan=0.5, posinf=1.0, neginf=0.0)
        x = torch.clamp(x, 0.0, 1.0)
        x = x.repeat(1, 3, 1, 1)                         # customLoss.py:55-56
        return (x - 0.485) / (0.229 + 1e-8)              # customLoss.py:39-40

    w = np.asarray(tap_weights, np.float64)
    w = w / w.sum()                                      # customLoss.py:34-36
    total = 0.0
    with torch.no_grad():
        ho, ht = prep(output_nhwc), prep(target_nhwc)
        for idx, layer in enumerate(seq):
            ho, ht = layer(ho.clone()), layer(ht.clone())
            if idx in set(taps):
                t = sorted(taps).index(idx)
                total += float(w[t]) * float(
                    torch.mean(torch.abs(ho - ht)))
            if idx >= max(taps):
                break
    return total


def torch_tap_activations(seq, x_nchw, taps) -> list[np.ndarray]:
    """Run the torch tower, returning activations at the tap indices as
    NHWC numpy arrays (the Flax tower's output layout)."""
    import torch

    taps = set(taps)
    outs: dict[int, np.ndarray] = {}
    with torch.no_grad():
        h = torch.as_tensor(x_nchw)
        for idx, layer in enumerate(seq):
            h = layer(h)
            if idx in taps:
                # .clone(): the next layer may be ReLU(inplace=True), which
                # would retroactively mutate a shared-memory .numpy() view
                outs[idx] = h.clone().numpy().transpose(0, 2, 3, 1)
            if idx >= max(taps):
                break
    return [outs[i] for i in sorted(taps)]
