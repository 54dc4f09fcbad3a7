"""Output-consistency harness (port of
``pcss_unet_tpu/parity/consistency.py``).

Plays the role of the reference's validate_consistency.py: run the same
checkpoint through two pathways and verify they agree.  Verdict thresholds
match validate_consistency.py:186-191: MSE < 1e-6 → "exact", PSNR > 50 dB →
"pass", else "fail".

Pathways compared here:
- training-visualization pathway: the port's ``UNet`` eval forward in
  float32, unfolded and unscrubbed, on the standardized frame
  (validate_consistency.py:40-59's role)
- inference pathway: the ``InferenceEngine`` with padding/scrub/clip, in the
  posture the keyword arguments ask for (validate_consistency.py:61-70's
  role)

Both run on the engine's device.  On the card the training pathway's
float32 convolutions are cuDNN's, which use TF32 while
``torch.backends.cudnn.allow_tf32`` is set (PyTorch's default).
"""

from __future__ import annotations

import numpy as np
import torch


def compare_outputs(a: np.ndarray, b: np.ndarray,
                    mse_exact: float = 1e-6, psnr_pass: float = 50.0) -> dict:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    mse = float(np.mean((a - b) ** 2))
    psnr = float(10.0 * np.log10(1.0 / mse)) if mse > 0 else float("inf")
    verdict = "exact" if mse < mse_exact else ("pass" if psnr > psnr_pass
                                               else "fail")
    return {"mse": mse, "psnr": psnr, "max_abs": float(np.max(np.abs(a - b))),
            "verdict": verdict}


def validate_train_infer_consistency(model, variables: dict,
                                     frame: np.ndarray, *, means=None,
                                     stds=None, pad_multiple: int = 16,
                                     **engine_kwargs) -> dict:
    """Run ``frame`` [H, W, 4] through the training-visualization pathway and
    the inference pathway; → comparison dict + both outputs.

    ``model`` is the port's ``UNet`` for ``variables`` (or None); the
    engine checks it against them.  ``engine_kwargs`` (e.g.
    ``fold_bn=True``, ``quantize='int8'``, ``dtype=torch.bfloat16``,
    ``device='cpu'``) select the inference pathway's posture and device;
    int8/bf16 postures won't be EXACT, and the reference's PSNR > 50 dB is
    the pass bar (validate_consistency.py:186-191)."""
    from pcss_unet_tpu_torch.infer.frame import InferenceEngine, pad_to_multiple
    from pcss_unet_tpu_torch.models.unet import unet_for_variables

    frame = np.asarray(frame, np.float32)

    # pathway B: the inference engine (fp32 unless the posture overrides)
    engine_kwargs.setdefault("dtype", torch.float32)
    engine = InferenceEngine(model, variables, means=means, stds=stds,
                             pad_multiple=pad_multiple, **engine_kwargs)
    out_b = engine(frame)

    # pathway A: as the train loop's validation logs it (fp32, no scrub)
    padded, (h, w) = pad_to_multiple(frame[None], pad_multiple)
    xs = torch.from_numpy(padded).to(engine.device)
    if means is not None:       # train/step.py::standardize
        xs = ((xs - torch.as_tensor(means, dtype=torch.float32, device=xs.device))
              / (torch.as_tensor(stds, dtype=torch.float32, device=xs.device)
                 + 1e-8))
    opts = {} if model is None else {
        k: getattr(model, k) for k in ("activation", "normalization",
                                       "apply_dilation")}
    plain = unet_for_variables(variables, dtype=torch.float32,
                               device=engine.device, **opts)
    with torch.inference_mode():
        out_a = plain(xs).cpu().numpy()[:, :h, :w, :][0]

    result = compare_outputs(out_a, out_b)
    result["train_pathway"] = out_a
    result["infer_pathway"] = out_b
    return result
