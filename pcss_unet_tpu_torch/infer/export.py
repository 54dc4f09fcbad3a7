"""Portable deployment artifacts: the inference function serialized with
``torch.export`` (port of ``pcss_unet_tpu/infer/export.py``, which writes
StableHLO through ``jax.export``).

The whole forward, standardization, scrub and clip included, exports to one
self-contained blob that ``torch.export.load`` runs with torch alone,
without this package or its model code.  The exported graph is the engine's
plain graph (``InferenceEngine.plain_model``): the kernels are ctypes calls
into a library built on the card, which no export can hold, so the blob
stays portable, as the reference's does by leaving out its Pallas calls.
"""

from __future__ import annotations

import copy
import io

import torch

from pcss_unet_tpu_torch.infer.frame import InferenceEngine, preprocess_plain

__all__ = ["export_inference", "load_exported", "save_exported"]


class _PlainGraph(torch.nn.Module):
    """The engine's plain forward on ``device``, on a copy of its weights
    made outside inference mode (an engine built under
    ``torch.inference_mode`` holds tensors that tracing cannot use)."""

    def __init__(self, engine: InferenceEngine, device: torch.device):
        super().__init__()
        self.model = copy.deepcopy(engine.plain_model).to(device)
        self.means, self.stds = (None if t is None else t.clone().to(device)
                                 for t in (engine.means, engine.stds))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        out = self.model(preprocess_plain(frames, self.means, self.stds))
        return InferenceEngine._postprocess(out)


def export_inference(engine: InferenceEngine, height: int, width: int,
                     batch: int = 1,
                     device: str | torch.device | None = None) -> bytes:
    """Serialize ``engine``'s padded forward for a fixed frame shape on
    ``device`` (default: the engine's).

    The exported callable maps [batch, height, width, 4] float32 →
    [batch, height, width, 1] float32 in [0, 1]; height/width must be
    multiples of the engine's pad_multiple (pad on the host first).  A
    graph that does not export raises: there is no fallback."""
    if height % engine.pad_multiple or width % engine.pad_multiple:
        raise ValueError(f"export shape must be ×{engine.pad_multiple}-aligned")
    device = engine.device if device is None else torch.device(device)
    with torch.inference_mode(False):
        spec = torch.zeros((batch, height, width, 4), dtype=torch.float32,
                           device=device)
        exported = torch.export.export(_PlainGraph(engine, device), (spec,))
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_exported(blob: bytes):
    """→ callable(frames) from a serialized artifact."""
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(frames: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return module(frames)
    return call


def save_exported(engine: InferenceEngine, path: str, height: int, width: int,
                  batch: int = 1, device: str | torch.device | None = None) -> int:
    blob = export_inference(engine, height, width, batch, device)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)
