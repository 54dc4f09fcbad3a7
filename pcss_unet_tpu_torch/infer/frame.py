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

``plain_model`` is the reference's plain graph: the (BN-folded) NHWC module
without the deployment switches, whatever the layout; ``run_padded(...,
plain=True)`` runs it after the plain scrub and standardization, so it
reaches no kernel (``infer.export`` traces it).  On the card, nothing in
the forward reads the device from the host, and ``render_u8`` (the serving
path) sends host frames up through pinned buffers, so it returns as soon as
its work is queued.

``build_sharded_forward`` is the reference's spatially sharded forward that
keeps the kernels: each spatial index of a mesh runs the whole kernel
posture on an aligned window of the frame (the model's window mode) on its
own device, and gives back its rows (``infer.tiled.infer_sharded_halo``).
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from pcss_unet_tpu_torch.infer.chw_engine import (chw_forward,
                                                  chw_forward_entered)
from pcss_unet_tpu_torch.infer.staging import PinnedRing
from pcss_unet_tpu_torch.models.fold_bn import fold_batchnorm
from pcss_unet_tpu_torch.models.torch_import import \
    load_variables as _load_reference
from pcss_unet_tpu_torch.models.unet import (UNet, spatial_align,
                                             unet_for_variables,
                                             widths_from_params)
from pcss_unet_tpu_torch.ops.kernels.fused import (fused_mask_to_u8,
                                                   fused_scrub_standardize)

__all__ = ["InferenceEngine", "load_variables", "pad_to_multiple",
           "preprocess_plain"]


def load_variables(path: str, ema: bool = False) -> dict:
    """Load model variables from a reference ``.pth`` (both formats), a
    reference-named ``.npz`` export (infer.py:36-41), or this package's own
    checkpoint directory (``train --save_dir``: the best checkpoint by its
    saved metric, else the latest, as the JAX package resolves its Orbax
    directories).  Orbax checkpoint directories need JAX to read and are
    refused with a ``ValueError`` that names the converter.  ``ema=True``
    asks for the EMA parameters, which only checkpoint directories carry
    (and only from ``ema_decay > 0`` runs); on a ``.pth`` or ``.npz`` it
    raises the reference's ``ValueError``."""
    if os.path.isfile(os.path.join(path, "checkpoints.json")):
        return _load_own_checkpoint(path, ema)
    if ema and not os.path.isdir(path):
        raise ValueError("--ema requires an Orbax checkpoint directory "
                         "(reference .pth/.npz exports carry no EMA)")
    return _load_reference(path)


def _load_own_checkpoint(directory: str, ema: bool) -> dict:
    from pcss_unet_tpu_torch.models.torch_import import to_flax_variables
    from pcss_unet_tpu_torch.train.checkpoint import CheckpointManager

    manager = CheckpointManager(directory)
    epoch = manager.best_epoch()
    payload = manager.load(epoch)        # None: the latest epoch
    params = payload["params"]
    if ema:
        if payload.get("ema_params") is None:
            raise ValueError(f"--ema: the checkpoint in {directory} has no "
                             "EMA parameters (train with ema_decay > 0)")
        params = dict(zip(params, payload["ema_params"]))
    return to_flax_variables({**params, **payload["batch_stats"]})


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


def preprocess_plain(x: torch.Tensor, means: torch.Tensor | None,
                     stds: torch.Tensor | None) -> torch.Tensor:
    """The reference's plain scrub and standardization in float32:
    ``nan_to_num`` (NaN→0, +Inf→1, −Inf→0), then ``(x − means) / (stds +
    1e-8)`` where stats are given."""
    x = torch.nan_to_num(x.float(), nan=0.0, posinf=1.0, neginf=0.0)
    if means is not None:
        x = (x - means) / (stds + 1e-8)
    return x


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
    None (architecture read from the variables, LeakyReLU without
    dilation); its ``normalization`` says whether ``variables`` (JAX
    layout, HWIO kernels) are already BN-folded, and the engine's forward
    takes its ``activation``, ``normalization`` and ``apply_dilation``.
    The channels-major layout computes LeakyReLU blocks without dilation
    only and refuses other models."""

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
        opts = dict(activation=getattr(model, "activation", "leaky_relu"),
                    apply_dilation=getattr(model, "apply_dilation", False))
        if layout == "chw" and not (fold_bn or normalization == "none"):
            raise ValueError("layout='chw' requires fold_bn=True or an "
                             "already-folded (normalization='none') model")
        if layout == "chw" and opts != dict(activation="leaky_relu",
                                            apply_dilation=False):
            raise ValueError(f"layout='chw' computes LeakyReLU blocks without "
                             f"dilation only; this model has {opts}")
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
            normalization = "none"
        self.layout = layout
        self.taps = taps
        self.quantize = quantize
        self._fold_bn = fold_bn
        self._nhwc_kernel_model = None
        self._window_models: dict = {}
        self._sharded_cache: dict = {}
        self._chw_kw = dict(dtype=dtype, int8=quantize == "int8", taps=taps)
        self._dtype = dtype
        self._staging = PinnedRing()
        self.variables = {"params": _tree_to(variables["params"], self.device)}
        self.means = (None if means is None else
                      torch.as_tensor(np.asarray(means, np.float32), device=self.device))
        self.stds = (None if stds is None else
                     torch.as_tensor(np.asarray(stds, np.float32), device=self.device))
        plain_kw = dict(dtype=dtype, device=self.device,
                        normalization=normalization, **opts)
        self.plain_model = unet_for_variables(variables, **plain_kw)
        if layout == "chw":
            # chw_forward needs H, W divisible by 2^depth
            pad_multiple = max(pad_multiple, 2 ** len(widths))
            self.model = None
        elif fold_bn:
            self.model = unet_for_variables(
                variables, fused_inference=True,
                int8_inference=quantize == "int8", **plain_kw)
        else:
            self.model = self.plain_model
        self.pad_multiple = pad_multiple

    def _upload(self, frames, staged: bool = False) -> torch.Tensor:
        """Frames (numpy or a tensor) on the engine's device.  ``staged``
        (the serving path): host frames go to a card through a pinned
        buffer and a copy that does not wait, since a copy from pageable
        memory waits for all the work queued before it.  Otherwise a plain
        copy: the caller reads the result at once, and pinning a buffer of
        a new shape costs more than the wait."""
        if torch.is_tensor(frames) and frames.device.type != "cpu":
            return frames.to(self.device)
        host = torch.as_tensor(frames)
        if not staged or self.device.type != "cuda":
            return host.to(self.device)
        slot = self._staging.take(host.shape, host.dtype)
        slot.buf.copy_(host)
        x = slot.buf.to(self.device, non_blocking=True)
        slot.fence()
        self._staging.release(slot)
        return x

    def _preprocess(self, x: torch.Tensor, fused: bool) -> torch.Tensor:
        """Input scrub + standardization in float32, [N, H, W, C]
        (inference.py:171-173): K1 where ``fused`` and stats are given,
        else the reference's plain graph, ``nan_to_num`` then
        ``(x − means) / (stds + 1e-8)``, which reaches no kernel."""
        if fused and self.means is not None:
            return fused_scrub_standardize(x.float(), self.means, self.stds,
                                           out_dtype=torch.float32)
        return preprocess_plain(x, self.means, self.stds)

    def _forward(self, frames, plain: bool = False,
                 staged: bool = False) -> torch.Tensor:
        """Frames → the forward's float32 sigmoid mask, not yet scrubbed or
        clipped.  ``plain``: the plain graph (``plain_model`` after the
        plain preprocessing), which reaches no kernel.  Otherwise, with
        stats, one K1 pass scrubs and standardizes the frame and writes it
        in the working dtype and the posture's entry layout, the forward's
        first input; without, the frame is scrubbed and the forward starts
        from it (as it does for an odd-size NHWC frame, which the model
        resizes first).  ``staged``: upload as ``_upload`` says."""
        x = self._upload(frames, staged).float()
        if plain:
            return self.plain_model(self._preprocess(x, fused=False))
        _, h, w, _ = x.shape
        if self.means is not None and not (h % 2 or w % 2):
            xe = fused_scrub_standardize(x, self.means, self.stds,
                                         out_dtype=self._dtype, entry=self.layout)
            if self.layout == "chw":
                return chw_forward_entered(self.variables, xe, w, **self._chw_kw)
            return self.model.forward_entered(xe)
        x = self._preprocess(x, fused=True)
        if self.layout == "chw":
            return chw_forward(self.variables, x, **self._chw_kw)
        return self.model(x)

    @staticmethod
    def _postprocess(out: torch.Tensor) -> torch.Tensor:
        out = torch.nan_to_num(out.float(), nan=0.0, posinf=1.0, neginf=0.0)
        return torch.clamp(out, 0.0, 1.0)

    def sharding_model(self) -> UNet:
        """The NHWC model the sharded paths run: ``model``, or for the chw
        layout the NHWC model the reference's engine holds beside its
        channels-major forward (the deployment switches where ``fold_bn``,
        else the plain graph), built at first use."""
        if self.model is not None:
            return self.model
        if self._nhwc_kernel_model is None:
            model = self.plain_model
            if self._fold_bn:
                with torch.inference_mode(False):
                    model = copy.deepcopy(model)
                for name in model.blocks():
                    block = getattr(model, name)
                    block.fused_inference = True
                    block.int8_inference = self.quantize == "int8"
            self._nhwc_kernel_model = model
        return self._nhwc_kernel_model

    def _window_model(self, device: torch.device, plain: bool):
        """(model, means, stds) on ``device`` for the sharded forward: the
        sharded paths' model itself on the engine's device, a copy made
        once on any other."""
        key = (device, plain)
        if key not in self._window_models:
            model = self.plain_model if plain else self.sharding_model()
            if next(model.parameters()).device != device:
                with torch.inference_mode(False):
                    model = copy.deepcopy(model).to(device)
            stats = [None if t is None else t.to(device)
                     for t in (self.means, self.stds)]
            self._window_models[key] = (model, *stats)
        return self._window_models[key]

    def build_sharded_forward(self, mesh, halo: int, shard_batch: bool,
                              plain: bool = False):
        """A spatially sharded forward that keeps the engine's kernel
        posture (``frame.py:257-318`` of the reference).  Spatial index i
        of ``mesh`` takes the aligned window of rows [s, s + ext) of the
        frame, ext = min(H, H / n_spatial + 2·halo) and s = clip(i·H /
        n_spatial − halo, 0, H − ext); on its device it runs the K1
        preprocessing (float32 out) and the model in window mode, and
        keeps its own H / n_spatial rows.  With halo ≥ ``spatial_halo``
        the rows equal the unsharded forward's on the same frame, up to
        what a kernel does differently on a window (an int8 block bands
        the window's rows, not the frame's).  ``plain``: the plain graph
        and preprocessing, which reach no kernel.

        → ``fn(x)`` with x [B, H, W, C] (numpy or a tensor): float32 masks
        [B, H, W, 1] on the engine's device.  Every window is queued before
        any result is gathered, so windows on different cards overlap.  H
        must divide by n_spatial · align and W by align (align: the larger
        of ``pad_multiple`` and ``spatial_align``); ``halo`` is rounded up
        to align.  ``shard_batch``: the batch is split over the data axis
        (each data index's windows on its row of the mesh), else row 0
        runs it all.  Cached per (mesh, halo, shard_batch, plain)."""
        model = self.plain_model if plain else self.sharding_model()
        align = max(self.pad_multiple, spatial_align(model))
        halo = -(-halo // align) * align
        key = (mesh, halo, shard_batch, plain)
        if key in self._sharded_cache:
            return self._sharded_cache[key]
        n_sp = mesh.shape["spatial"]
        rows = mesh.devices if shard_batch else mesh.devices[:1]

        @torch.inference_mode()
        def fwd(frames) -> torch.Tensor:
            x = self._upload(frames)
            b, h, w, _ = x.shape
            if h % (n_sp * align) or w % align:
                raise ValueError(
                    f"sharded forward needs H divisible by n_spatial·align "
                    f"({n_sp}·{align}) and W by {align}; got H={h}, W={w} "
                    f"(pad first — infer_sharded_halo does this)")
            shard_h = h // n_sp
            ext = min(h, shard_h + 2 * halo)
            parts = []
            for xb, row in zip(x.chunk(len(rows)), rows):
                for i, dev in enumerate(row):
                    m, means, stds = self._window_model(dev, plain)
                    start = i * shard_h
                    s = min(max(start - halo, 0), h - ext)
                    win = xb[:, s:s + ext].to(dev).float()
                    if plain or means is None:
                        win = preprocess_plain(win, means, stds)
                    else:
                        win = fused_scrub_standardize(win, means, stds,
                                                      out_dtype=torch.float32)
                    out = self._postprocess(m(win, window=(h, s)))
                    parts.append(out[:, start - s:start - s + shard_h])
            # gathered only after every window is queued
            parts = [p.to(self.device) for p in parts]
            return torch.cat([torch.cat(parts[r * n_sp:(r + 1) * n_sp], dim=1)
                              for r in range(len(rows))])

        self._sharded_cache[key] = fwd
        return fwd

    @torch.inference_mode()
    def run_padded(self, frames, plain: bool = False) -> torch.Tensor:
        """Forward on already-aligned frames [B, H, W, C] (numpy, or a
        tensor on any device; moved to the engine's) → masks on the
        engine's device, scrubbed and clipped to [0, 1].  ``plain=True``
        runs the plain graph, which reaches no kernel."""
        return self._postprocess(self._forward(frames, plain))

    @torch.inference_mode()
    def render_u8(self, frames) -> torch.Tensor:
        """Serving path: forward + ×255 uint8 quantization (K4) on the
        engine's device.  K4 scrubs and clips by itself, so it takes the
        forward's mask as it comes (the same codes as after
        ``_postprocess``).  On the card it returns once the work is
        queued: host frames go up through pinned buffers."""
        return fused_mask_to_u8(self._forward(frames, staged=True))

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, np.float32)
        squeeze = frames.ndim == 3
        if squeeze:
            frames = frames[None]
        padded, (h, w) = pad_to_multiple(frames, self.pad_multiple)
        out = self.run_padded(padded)
        out = out.cpu().numpy()[:, :h, :w, :]
        return out[0] if squeeze else out
