"""Torch implementation of the reference U-Net (parity ground truth; the
port's own copy of ``pcss_unet_tpu/parity/unet_torch.py``).

Built *generatively* from the documented architecture (SURVEY.md §2 "U-Net
model" row; Unetmodel.py:17-149) purely as test/validation ground truth:
the port's ``models/unet.py`` is held against it, never runs it.
State-dict names match the reference exactly (``conv{k}.conv.{idx}.*``),
so checkpoints exported by ``models.torch_import.export_to_torch_state_dict``
load into this model with ``strict=True``, and its state dict converts with
``convert_torch_state_dict``.

Widths are parameterizable (default = the reference's 64/128/512/1024
ladder) so small instances can drive fast full-cycle tests; the depth is
fixed at 4 blocks to match the reference naming scheme the ``.pth``
converter speaks (models/torch_import.py REFERENCE_BLOCK_MAP).
"""

from __future__ import annotations

DEFAULT_WIDTHS = (64, 128, 512, 1024)


def make_torch_reference(widths=DEFAULT_WIDTHS, dropout: float = 0.2,
                         in_ch: int = 4, out_ch: int = 1):
    """→ torch.nn.Module replicating Unetmodel.py's ``Unet`` with the given
    encoder widths (must be 4 levels for reference state-dict naming)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    if len(widths) != 4:
        raise ValueError("reference naming (conv2..conv10) is depth-4; got "
                         f"{len(widths)} widths")
    unshuffled = in_ch * 4

    class Block(nn.Module):
        # attribute named ``conv`` so state-dict keys match the reference's
        # ``conv{k}.conv.{idx}`` layout (Unetmodel.py:20-30)
        def __init__(self, cin, cout, p):
            super().__init__()
            self.conv = nn.Sequential(
                nn.Conv2d(cin, cin, 3, padding=1),
                nn.BatchNorm2d(cin),
                nn.LeakyReLU(0.2),
                nn.Dropout2d(p),
                nn.Conv2d(cin, cout, 1),
                nn.BatchNorm2d(cout),
                nn.LeakyReLU(0.2),
            )

        def forward(self, x):
            return self.conv(x)

    class TorchShadowUNet(nn.Module):
        def __init__(self, p=dropout):
            super().__init__()
            w0, w1, w2, w3 = widths
            enc = [(unshuffled, w0), (w0, w1), (w1, w2), (w2, w3)]
            for i, (cin, cout) in enumerate(enc, start=2):
                setattr(self, f"conv{i}", Block(cin, cout, p))
            dec = [(w3, w2), (w2, w1), (w1, w0)]
            for i, (cin, cout) in enumerate(dec, start=6):
                setattr(self, f"conv{i}", Block(cin, cout, p))
            self.conv9 = Block(w0, unshuffled, p / 2)
            self.conv10 = nn.Conv2d(unshuffled, out_ch * 4, 1)

        def up2(self, x):
            return F.interpolate(x, scale_factor=2, mode="bilinear",
                                 align_corners=True)

        def forward(self, x):
            x = F.pixel_unshuffle(x, 2)
            c2 = self.conv2(x)
            c3 = self.conv3(F.avg_pool2d(c2, 2))
            c4 = self.conv4(F.avg_pool2d(c3, 2))
            c5 = self.conv5(F.avg_pool2d(c4, 2))
            u = self.conv6(self.up2(c5)) + c4
            u = self.conv7(self.up2(u)) + c3
            u = self.conv8(self.up2(u)) + c2
            u = self.up2(u)
            # reference re-matches the head back to the unshuffled size
            # (Unetmodel.py:140-141)
            u = F.interpolate(u, size=x.shape[2:], mode="bilinear",
                              align_corners=True)
            u = self.conv9(u)
            out = F.pixel_shuffle(self.conv10(u), 2)
            return torch.sigmoid(out)

    return TorchShadowUNet()
