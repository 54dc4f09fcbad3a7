"""Batched full-frame inference (port of ``pcss_unet_tpu/infer/frame.py``).

One engine for the reference's inference paths: frames are reflection-padded
to ``pad_multiple``, NaN/Inf-scrubbed and standardized by the K1 kernel,
which writes the forward's first input (pixel-unshuffled, in the working
dtype, in the posture's layout) in the same pass, run through the network,
scrubbed and clipped to [0, 1]; ``render_u8`` quantizes the forward's mask
with the K4 kernel, which scrubs and clips by itself.

``layout="chw"`` runs the channels-major engine (``infer.chw_engine``);
``layout="nhwc"`` runs the module forward (``models.unet.UNet``).  With
``fold_bn`` either one is a deployment posture: the module gets the
reference's ``fused_inference`` switch (and ``int8_inference`` with
``quantize="int8"``), so its blocks take the same kernels the reference's
gates pick.  The engine runs on the card (``device="cuda"``, the default)
or, with ``device="cpu"``, on the plain versions of the kernels, with the
same routing.  The reference's ``use_pallas`` and ``pallas_interpret``
switches have no counterpart: the device decides.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pcss_unet_tpu_torch.infer.chw_engine import (chw_forward,
                                                  chw_forward_entered)
from pcss_unet_tpu_torch.models.fold_bn import fold_batchnorm
from pcss_unet_tpu_torch.models.torch_import import \
    load_variables as _load_reference
from pcss_unet_tpu_torch.models.unet import (UNet, unet_for_variables,
                                             widths_from_params)
from pcss_unet_tpu_torch.ops.kernels.fused import (fused_mask_to_u8,
                                                   fused_scrub_standardize)

__all__ = ["InferenceEngine", "load_variables", "pad_to_multiple"]


def load_variables(path: str, ema: bool = False) -> dict:
    """Load model variables from a reference ``.pth`` (both formats) or a
    reference-named ``.npz`` export (infer.py:36-41).  Orbax checkpoint
    directories need JAX to read and are refused with a ``ValueError`` that
    names the converter.  ``ema=True`` asks for the EMA parameters, which
    only Orbax checkpoints carry: on a ``.pth`` or ``.npz`` it raises the
    reference's ``ValueError``."""
    if ema and not os.path.isdir(path):
        raise ValueError("--ema requires an Orbax checkpoint directory "
                         "(reference .pth/.npz exports carry no EMA)")
    return _load_reference(path)


def pad_to_multiple(x: np.ndarray, multiple: int) -> tuple[np.ndarray, tuple]:
    """Reflection-pad NHWC to the next multiple; returns (padded, (h, w))
    for cropping back.  Frames too small to reflect pad by edge
    replication."""
    _, h, w, _ = x.shape
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph or pw:
        mode = "reflect" if (ph < h and pw < w) else "edge"
        x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode=mode)
    return x, (h, w)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, torch.float32)
    return torch.tensor(np.asarray(tree, np.float32), device=device)


class InferenceEngine:
    """Holds the variables and runs the forward.

    ``engine(frames)`` with frames [B, H, W, 4] float32 (numpy) → masks
    [B, H, W, 1] float32 in [0, 1].  ``model`` is the port's ``UNet`` or
    None (architecture read from the variables); its ``normalization``
    says whether ``variables`` (JAX layout, HWIO kernels) are already
    BN-folded."""

    def __init__(self, model: UNet | None, variables: dict, *, means=None,
                 stds=None, dtype: torch.dtype = torch.bfloat16,
                 pad_multiple: int = 16, fold_bn: bool = False,
                 quantize: str = "none", layout: str = "nhwc",
                 taps: str | dict = "stack",
                 device: str | torch.device = "cuda"):
        if quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize mode: {quantize}")
        if layout not in ("nhwc", "chw"):
            raise ValueError(f"unknown layout: {layout}")
        widths, _, _ = widths_from_params(variables["params"])
        if model is not None and tuple(model.encoder_widths) != widths:
            raise ValueError(f"model widths {model.encoder_widths} do not "
                             f"match the variables' {widths}")
        normalization = (model.normalization if model is not None else
                         "batch_norm" if "norm_a" in variables["params"]["enc_0"]
                         else "none")
        if layout == "chw" and not (fold_bn or normalization == "none"):
            raise ValueError("layout='chw' requires fold_bn=True or an "
                             "already-folded (normalization='none') model")
        if fold_bn and normalization != "batch_norm":
            raise ValueError("fold_bn requires a batch_norm model")
        if quantize == "int8" and not fold_bn and layout != "chw":
            raise ValueError("quantize='int8' requires fold_bn=True "
                             "(the int8 path runs on folded-BN blocks)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the engine runs on the card "
                               "unless device='cpu' is passed")
        if fold_bn:
            variables = fold_batchnorm(variables)
        self.layout = layout
        self.taps = taps
        self.quantize = quantize
        self._chw_kw = dict(dtype=dtype, int8=quantize == "int8", taps=taps)
        self._dtype = dtype
        self.variables = {"params": _tree_to(variables["params"], self.device)}
        self.means = (None if means is None else
                      torch.as_tensor(np.asarray(means, np.float32), device=self.device))
        self.stds = (None if stds is None else
                     torch.as_tensor(np.asarray(stds, np.float32), device=self.device))
        if layout == "chw":
            # chw_forward needs H, W divisible by 2^depth
            pad_multiple = max(pad_multiple, 2 ** len(widths))
            self.model = None
        else:
            self.model = unet_for_variables(
                variables, dtype=dtype, device=self.device,
                fused_inference=fold_bn,
                int8_inference=fold_bn and quantize == "int8")
        self.pad_multiple = pad_multiple

    def _forward(self, frames) -> torch.Tensor:
        """Frames → the forward's float32 sigmoid mask, not yet scrubbed or
        clipped.  With stats, one K1 pass scrubs and standardizes the frame
        and writes it in the working dtype and the posture's entry layout,
        the forward's first input; without, the frame is scrubbed and the
        forward starts from it (as it does for an odd-size NHWC frame, which
        the model resizes first)."""
        x = torch.as_tensor(frames, device=self.device).float()
        _, h, w, _ = x.shape
        if self.means is not None and not (h % 2 or w % 2):
            xe = fused_scrub_standardize(x, self.means, self.stds,
                                         out_dtype=self._dtype, entry=self.layout)
            if self.layout == "chw":
                return chw_forward_entered(self.variables, xe, w, **self._chw_kw)
            return self.model.forward_entered(xe)
        if self.means is not None:
            x = fused_scrub_standardize(x, self.means, self.stds,
                                        out_dtype=torch.float32)
        else:
            x = torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=0.0)
        if self.layout == "chw":
            return chw_forward(self.variables, x, **self._chw_kw)
        return self.model(x)

    @staticmethod
    def _postprocess(out: torch.Tensor) -> torch.Tensor:
        out = torch.nan_to_num(out.float(), nan=0.0, posinf=1.0, neginf=0.0)
        return torch.clamp(out, 0.0, 1.0)

    @torch.inference_mode()
    def run_padded(self, frames: torch.Tensor) -> torch.Tensor:
        """Forward on already-aligned frames [B, H, W, C] (a tensor on any
        device; moved to the engine's) → masks on the engine's device,
        scrubbed and clipped to [0, 1]."""
        return self._postprocess(self._forward(frames))

    @torch.inference_mode()
    def render_u8(self, frames: torch.Tensor) -> torch.Tensor:
        """Serving path: forward + ×255 uint8 quantization (K4) on the
        engine's device.  K4 scrubs and clips by itself, so it takes the
        forward's mask as it comes (the same codes as after
        ``_postprocess``)."""
        return fused_mask_to_u8(self._forward(frames))

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, np.float32)
        squeeze = frames.ndim == 3
        if squeeze:
            frames = frames[None]
        padded, (h, w) = pad_to_multiple(frames, self.pad_multiple)
        out = self.run_padded(torch.from_numpy(padded))
        out = out.cpu().numpy()[:, :h, :w, :]
        return out[0] if squeeze else out
