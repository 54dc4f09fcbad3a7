"""Checkpoints with best-metric retention and resume (port of
``pcss_unet_tpu/train/checkpoint.py``).

The reference only ever *saves*: ``{'epoch', 'model_state_dict',
'optimizer_state_dict', 'loss'}`` for the best validation loss
(main.py:539-544; best-train fallback at 548-561) and has no resume path.
The JAX package writes Orbax checkpoints, which cannot be read without JAX,
so the port has its own format with the JAX wrapper's semantics:

- one file per save, ``ckpt_{key}.pt`` (``torch.save`` of tensors only:
  the model's parameters and BatchNorm statistics, the optimizer's state,
  step, skip counter, EMA, the mid-epoch cursor and the metrics), written
  to a temporary file and moved into place with ``os.replace``, so a crash
  leaves either the old file or the new one;
- keyed by epoch: a save for epoch E is key ``E * 1000 + sub``, where
  ``sub`` counts re-saves of the epoch (a mid-epoch preemption save, then
  the end-of-epoch save); a superseded save is deleted only after its
  replacement is in place;
- best retention (Orbax's ``BestN``): with more than ``max_to_keep`` saves,
  keep the ``max_to_keep`` best by ``val_loss`` (else ``train_loss``) and
  every metric-less save (the mid-epoch ones, whose partial-epoch losses
  are not comparable);
- ``export_reference_checkpoint`` / ``load_reference_checkpoint``: the
  reference-named ``.npz`` (``conv2.conv.0.weight`` …) both packages read.

Resuming into a directory that holds Orbax checkpoints raises a
``ValueError`` that says so.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any

import numpy as np
import torch

from pcss_unet_tpu_torch.train.state import TrainState

# Config keys that shape the checkpointed state: the parameters (depth,
# width, channels, normalization) and the optimizer state.  A resume across
# a change in any of these cannot restore, so it is refused up front.
RESUME_STRUCTURE_KEYS = ("model_depth", "base_width", "input_channels",
                         "output_channels", "normalization",
                         "optimizer_type")

_FILE = re.compile(r"ckpt_(\d+)\.pt$")


def has_orbax_checkpoints(directory: str) -> bool:
    """True if ``directory`` holds an Orbax step directory (the JAX
    package's checkpoints)."""
    try:
        return any(e.isdigit() and os.path.isdir(os.path.join(directory, e))
                   for e in os.listdir(directory))
    except OSError:
        return False


def has_checkpoints(directory: str) -> bool:
    """True if ``directory`` holds at least one checkpoint of the port's."""
    try:
        return any(_FILE.match(e) for e in os.listdir(directory))
    except OSError:
        return False


def _refuse_orbax(directory: str) -> None:
    if has_orbax_checkpoints(directory):
        raise ValueError(
            f"{directory} holds Orbax checkpoints (the JAX package's), which "
            "this package cannot read without JAX. Resume them with "
            "python -m pcss_unet_tpu train, or export the weights "
            "(scripts/export_torch_checkpoint.py) and start a fresh save_dir")


def check_resume_compat(cfg, directory: str) -> None:
    """Fail fast when resuming into a ``save_dir`` whose checkpoints were
    written by a structurally different run (different model variant or
    optimizer), or by the JAX package.  Reads the ``resolved_config.json``
    the training CLI leaves next to the checkpoints — call this BEFORE
    overwriting that file with the current run's config."""
    _refuse_orbax(directory)
    path = os.path.join(directory, "resolved_config.json")
    if not os.path.exists(path) or not has_checkpoints(directory):
        return
    try:
        with open(path) as f:
            prev = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return  # unreadable provenance file — let restore() decide
    diffs = [(k, prev[k], getattr(cfg, k)) for k in RESUME_STRUCTURE_KEYS
             if k in prev and prev[k] != getattr(cfg, k)]
    if diffs:
        detail = "; ".join(f"{k}: checkpoint={a!r}, current={b!r}"
                           for k, a, b in diffs)
        raise ValueError(
            f"resume mismatch: the checkpoints under {directory} were "
            f"written by a run with a different model/optimizer structure "
            f"({detail}). Pass --no_resume (resume=false) to train from "
            f"scratch in place, or point save_dir at a fresh directory.")


def _cpu(t):
    if isinstance(t, list):
        return [x.detach().cpu().clone() for x in t]
    return t.detach().cpu().clone()


class CheckpointManager:
    """Epoch-keyed checkpoints of a ``TrainState`` in ``directory``."""

    _SUBKEYS = 1000  # max re-saves of one epoch

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._metrics = self._read_index()

    # ---------------------------------------------------------------- index
    def _path(self, key: int) -> str:
        return os.path.join(self.directory, f"ckpt_{key}.pt")

    def _index_path(self) -> str:
        return os.path.join(self.directory, "checkpoints.json")

    def _read_index(self) -> dict[int, dict | None]:
        """key → metrics (None: metric-less) for every checkpoint on disk;
        a file the index does not know (a crash between the two writes)
        counts as metric-less."""
        index = {}
        try:
            with open(self._index_path()) as f:
                index = {int(k): v for k, v in json.load(f).items()}
        except (OSError, ValueError):
            pass
        on_disk = sorted(int(m.group(1)) for m in
                         map(_FILE.match, os.listdir(self.directory)) if m)
        return {k: index.get(k) for k in on_disk}

    def _write_atomic(self, path: str, write) -> None:
        tmp = f"{path}.tmp"
        write(tmp)
        os.replace(tmp, path)

    def _write_index(self) -> None:
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in self._metrics.items()}, f)
        self._write_atomic(self._index_path(), write)

    def _delete(self, key: int) -> None:
        self._metrics.pop(key, None)
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def all_steps(self) -> list[int]:
        return sorted(self._metrics)

    def _steps_for_epoch(self, epoch: int) -> list[int]:
        return [s for s in self.all_steps() if s // self._SUBKEYS == epoch]

    @staticmethod
    def _metric(m: dict) -> float:
        return m.get("val_loss", m.get("train_loss", 1e30))

    def _retain(self) -> None:
        """Orbax's ``BestN`` with ``keep_checkpoints_without_metrics``."""
        keys = self.all_steps()
        if len(keys) <= self.max_to_keep:
            return
        ranked = sorted((k for k in keys if self._metrics[k] is not None),
                        key=lambda k: self._metric(self._metrics[k]),
                        reverse=True)
        keep = set(ranked[-self.max_to_keep:] if self.max_to_keep else [])
        keep |= {k for k in keys if self._metrics[k] is None}
        for k in keys:
            if k not in keep:
                self._delete(k)

    # ------------------------------------------------------------ save/load
    def save(self, state: TrainState, metrics: dict[str, float],
             epoch: int, cursor_batch: int | None = None) -> None:
        """``cursor_batch``: data-order cursor for mid-epoch saves — the
        number of batches of ``epoch`` already consumed, so resume can pick
        up at the next batch.  None/-1 means the epoch completed; a
        mid-epoch save carries no metrics."""
        mid_epoch = cursor_batch is not None and cursor_batch >= 0
        stale = self._steps_for_epoch(epoch)
        used = {s % self._SUBKEYS for s in stale}
        sub = (stale[-1] % self._SUBKEYS + 1) if stale else 0
        if sub >= self._SUBKEYS:
            # the epoch's sub-key counter wrapped: reuse the lowest free one
            # (never spill into epoch+1's range); all taken → free the oldest
            sub = next((i for i in range(self._SUBKEYS) if i not in used), None)
            if sub is None:
                self._delete(stale[0])
                sub, stale = stale[0] % self._SUBKEYS, stale[1:]
        key = epoch * self._SUBKEYS + sub
        model = state.model
        payload = {
            "params": {n: _cpu(p) for n, p in model.named_parameters()},
            "batch_stats": {n: _cpu(b) for n, b in model.named_buffers()},
            "opt_state": {k: _cpu(v) for k, v in state.opt_state.items()},
            "step": _cpu(state.step),
            "skipped_steps": _cpu(state.skipped_steps),
            "cursor_batch": cursor_batch if mid_epoch else -1,
            "metrics": None if mid_epoch else {k: float(v) for k, v in metrics.items()},
        }
        if state.ema_params is not None:
            payload["ema_params"] = _cpu(state.ema_params)
        self._write_atomic(self._path(key), lambda tmp: torch.save(payload, tmp))
        self._metrics[key] = payload["metrics"]
        self._retain()       # as Orbax does after each save, then
        for s in stale:      # superseded saves of this epoch, after the new one
            self._delete(s)
        self._write_index()

    def latest_epoch(self) -> int | None:
        keys = self.all_steps()
        return keys[-1] // self._SUBKEYS if keys else None

    def best_epoch(self) -> int | None:
        ranked = [k for k in self.all_steps() if self._metrics[k] is not None]
        if not ranked:
            return None
        return min(ranked, key=lambda k: self._metric(self._metrics[k])) // self._SUBKEYS

    def load(self, epoch: int | None = None) -> dict[str, Any]:
        """The raw payload of the latest save of ``epoch`` (latest epoch by
        default)."""
        epoch = self.latest_epoch() if epoch is None else epoch
        steps = [] if epoch is None else self._steps_for_epoch(epoch)
        if not steps:
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} under "
                                    f"{self.directory}")
        return torch.load(self._path(steps[-1]), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState,
                epoch: int | None = None) -> tuple[TrainState, int]:
        """Restore into ``state`` (in place, on its device); latest epoch by
        default.  → (state, cursor_batch): -1 when the checkpointed epoch
        completed (resume at the next epoch), else the number of batches
        already consumed.  EMA on a checkpoint without one seeds from the
        restored parameters; a checkpoint's EMA is dropped where EMA is off."""
        _refuse_orbax(self.directory)
        data = self.load(epoch)
        model = state.model
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(data["params"][n])
            for n, b in model.named_buffers():
                b.copy_(data["batch_stats"][n])
            for k, v in state.opt_state.items():
                if isinstance(v, list):
                    for o, s in zip(v, data["opt_state"][k]):
                        o.copy_(s)
                else:
                    v.copy_(data["opt_state"][k])
            state.step.copy_(data["step"])
            state.skipped_steps.copy_(data["skipped_steps"])
            if state.ema_params is not None:
                src = data.get("ema_params")
                if src is None:
                    logging.info("checkpoint has no ema_params; seeding EMA "
                                 "from the restored parameters")
                    src = [p for p in model.parameters()]
                for e, s in zip(state.ema_params, src):
                    e.copy_(s)
        return state, int(data["cursor_batch"])


def export_reference_checkpoint(state: TrainState, path: str) -> None:
    """Write an ``.npz`` with reference-named arrays (conv2.conv.0.weight …)
    that ``load_reference_checkpoint`` here and in the JAX package read,
    and ``infer.load_variables`` deploys."""
    from pcss_unet_tpu_torch.models.torch_import import (
        export_to_torch_state_dict, to_flax_variables)

    flat = export_to_torch_state_dict(to_flax_variables(state.model))
    np.savez(path, **flat)
    logging.info("exported reference-format checkpoint to %s", path)


def load_reference_checkpoint(path: str) -> dict[str, Any]:
    """Load a reference checkpoint: ``.pth`` (torch pickles, both the
    dict-with-model_state_dict and raw formats — infer.py:36-41) or ``.npz``
    (the export).  → JAX-layout variables {'params','batch_stats'}."""
    from pcss_unet_tpu_torch.models.torch_import import load_variables

    return load_variables(path)
