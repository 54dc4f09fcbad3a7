"""Checkpoint conversion between the reference's state dicts, the JAX
package's variable trees and this port's modules (port of
``pcss_unet_tpu/models/torch_import.py``).

The reference saves ``{'epoch', 'model_state_dict', 'optimizer_state_dict',
'loss'}`` dicts or raw state dicts.  Its names follow ``Unetmodel.py``:

    conv2..conv5   encoder DoubleConv blocks     → enc_0..enc_3
    conv6..conv8   decoder DoubleConv blocks     → dec_0..dec_2
    conv9          final half-dropout block      → dec_final
    conv10         1×1 output conv               → head

and inside each DoubleConv: ``.conv.0`` 3×3 conv → conv_a, ``.conv.1`` BN →
norm_a, ``.conv.4`` 1×1 conv → conv_b, ``.conv.5`` BN → norm_b.

A *variables* tree is the JAX package's ``{'params', 'batch_stats'}`` layout
with numpy leaves and HWIO conv kernels; the channels-major engine reads it
directly.  ``from_flax_variables`` turns one into a state dict for this
port's ``models.unet.UNet`` (OIHW ``nn.Conv2d`` weights, ``BatchNorm2d``
buffers).
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

# reference module name → block name (default depth-4 network)
REFERENCE_BLOCK_MAP = {
    "conv2": "enc_0",
    "conv3": "enc_1",
    "conv4": "enc_2",
    "conv5": "enc_3",
    "conv6": "dec_0",
    "conv7": "dec_1",
    "conv8": "dec_2",
    "conv9": "dec_final",
}


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """OIHW (torch Conv2d) → HWIO (flax Conv)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _oihw(k: np.ndarray) -> np.ndarray:
    """HWIO → OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def convert_torch_state_dict(state: Mapping[str, np.ndarray]) -> dict:
    """Reference state dict (numpy values) → {'params', 'batch_stats'}."""
    params: dict = {}
    batch_stats: dict = {}
    for tname, fname in REFERENCE_BLOCK_MAP.items():
        block_p: dict = {}
        block_s: dict = {}
        for torch_idx, our in (("0", "a"), ("4", "b")):
            block_p[f"conv_{our}"] = {
                "kernel": _conv_kernel(np.asarray(state[f"{tname}.conv.{torch_idx}.weight"])),
                "bias": np.asarray(state[f"{tname}.conv.{torch_idx}.bias"]),
            }
        for torch_idx, our in (("1", "a"), ("5", "b")):
            block_p[f"norm_{our}"] = {
                "scale": np.asarray(state[f"{tname}.conv.{torch_idx}.weight"]),
                "bias": np.asarray(state[f"{tname}.conv.{torch_idx}.bias"]),
            }
            block_s[f"norm_{our}"] = {
                "mean": np.asarray(state[f"{tname}.conv.{torch_idx}.running_mean"]),
                "var": np.asarray(state[f"{tname}.conv.{torch_idx}.running_var"]),
            }
        params[fname] = block_p
        batch_stats[fname] = block_s
    params["head"] = {
        "kernel": _conv_kernel(np.asarray(state["conv10.weight"])),
        "bias": np.asarray(state["conv10.bias"]),
    }
    return {"params": params, "batch_stats": batch_stats}


def export_to_torch_state_dict(variables: Mapping) -> dict:
    """Inverse conversion: variables → reference-named numpy state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}
    for tname, fname in REFERENCE_BLOCK_MAP.items():
        bp, bs = params[fname], stats.get(fname, {})
        for torch_idx, our in (("0", "a"), ("4", "b")):
            out[f"{tname}.conv.{torch_idx}.weight"] = _oihw(bp[f"conv_{our}"]["kernel"])
            out[f"{tname}.conv.{torch_idx}.bias"] = np.asarray(bp[f"conv_{our}"]["bias"])
        for torch_idx, our in (("1", "a"), ("5", "b")):
            out[f"{tname}.conv.{torch_idx}.weight"] = np.asarray(bp[f"norm_{our}"]["scale"])
            out[f"{tname}.conv.{torch_idx}.bias"] = np.asarray(bp[f"norm_{our}"]["bias"])
            ns = bs.get(f"norm_{our}", {})
            out[f"{tname}.conv.{torch_idx}.running_mean"] = np.asarray(
                ns.get("mean", np.zeros_like(bp[f"norm_{our}"]["scale"])))
            out[f"{tname}.conv.{torch_idx}.running_var"] = np.asarray(
                ns.get("var", np.ones_like(bp[f"norm_{our}"]["scale"])))
            out[f"{tname}.conv.{torch_idx}.num_batches_tracked"] = np.asarray(0)
    out["conv10.weight"] = _oihw(params["head"]["kernel"])
    out["conv10.bias"] = np.asarray(params["head"]["bias"])
    return out


def from_flax_variables(variables: Mapping,
                        dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """JAX-layout variables (numpy leaves) → state dict of this port's
    ``UNet`` in ``dtype``: HWIO kernels become OIHW ``nn.Conv2d`` weights,
    BatchNorm scale/bias/mean/var become ``BatchNorm2d`` weight/bias/running
    stats.  Works for folded (no ``norm_*``) and unfolded trees of any
    depth."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, np.float64)).to(dtype)

    for name, block in params.items():
        if "conv_a" not in block:          # a plain conv (the head)
            out[f"{name}.weight"] = t(_oihw(block["kernel"]))
            out[f"{name}.bias"] = t(block["bias"])
            continue
        for conv in ("conv_a", "conv_b"):
            out[f"{name}.{conv}.weight"] = t(_oihw(block[conv]["kernel"]))
            out[f"{name}.{conv}.bias"] = t(block[conv]["bias"])
        for norm in ("norm_a", "norm_b"):
            if norm not in block:
                continue
            out[f"{name}.{norm}.weight"] = t(block[norm]["scale"])
            out[f"{name}.{norm}.bias"] = t(block[norm]["bias"])
            s = stats.get(name, {}).get(norm)
            if s is None:                  # GroupNorm: scale and bias only
                continue
            out[f"{name}.{norm}.running_mean"] = t(s["mean"])
            out[f"{name}.{norm}.running_var"] = t(s["var"])
            out[f"{name}.{norm}.num_batches_tracked"] = torch.tensor(0)
    return out


def to_flax_variables(model: torch.nn.Module | dict) -> dict:
    """The inverse of ``from_flax_variables``: this port's ``UNet`` (or its
    state dict) → JAX-layout variables (numpy leaves in the module's
    dtypes, HWIO kernels, BatchNorm weight/bias → scale/bias, running
    statistics → ``batch_stats`` mean/var)."""
    params: dict = {}
    stats: dict = {}
    leaf = {"weight": "kernel", "bias": "bias"}
    norm_leaf = {"weight": "scale", "bias": "bias",
                 "running_mean": "mean", "running_var": "var"}
    state = model if isinstance(model, dict) else model.state_dict()
    for key, t in state.items():
        a = t.detach().cpu().numpy()
        parts = key.split(".")
        if len(parts) == 2:                            # the head
            params.setdefault(parts[0], {})[leaf[parts[1]]] = (
                np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
                if parts[1] == "weight" else a)
            continue
        block, layer, name = parts
        if name == "num_batches_tracked":
            continue
        if layer.startswith("conv"):
            params.setdefault(block, {}).setdefault(layer, {})[leaf[name]] = (
                np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
                if name == "weight" else a)
        elif name.startswith("running_"):
            stats.setdefault(block, {}).setdefault(layer, {})[norm_leaf[name]] = a
        else:
            params.setdefault(block, {}).setdefault(layer, {})[norm_leaf[name]] = a
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str) -> dict:
    """Load a reference ``.pth`` (dict-with-model_state_dict or raw state
    dict) and convert to variables.  Loads tensors only
    (``weights_only=True``): no pickled code runs."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    np_state = {k: v.detach().cpu().numpy() for k, v in state.items()
                if hasattr(v, "detach")}
    return convert_torch_state_dict(np_state)


def load_variables(path: str) -> dict:
    """Load variables from a reference ``.pth`` (both formats) or a
    reference-named ``.npz`` export.  Orbax checkpoint directories need
    JAX to read and are refused."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an Orbax checkpoint?): this package "
            "cannot read Orbax without JAX.  Convert it with the JAX package "
            "first (python scripts/export_torch_checkpoint.py --checkpoint "
            f"{path} --out model.pth) and load the .pth it writes")
    if path.endswith(".npz"):
        with np.load(path) as data:
            return convert_torch_state_dict({k: data[k] for k in data.files})
    return load_torch_checkpoint(path)
