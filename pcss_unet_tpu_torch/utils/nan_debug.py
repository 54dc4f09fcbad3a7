"""Numerical-sanitizer utilities (port of
``pcss_unet_tpu/utils/nan_debug.py``), the reference's anomaly machinery
(SURVEY.md §5 "Race detection / sanitizers"):

- ``detect_anomalies()``: ``torch.autograd.set_detect_anomaly(True)``
  while inside (the reference turns it on for good, main.py:148; here it
  is a debug mode, not a production default), the previous state restored
  on exit.
- ``checked_sigmoid_range``: the invariant that model outputs are in
  [0, 1], which the reference asserts inside its loss (customLoss.py:131,
  pert_loss.py:131), as a deferred check: the device holds the verdict
  until ``err.throw()`` reads it.
- ``find_nonfinite``: which leaves of a nested structure of tensors or
  arrays hold NaN/Inf (the role of the reference's per-parameter gradient
  scan, main.py:294-320), named as ``jax.tree_util.keystr`` names them.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any

import numpy as np
import torch


@contextlib.contextmanager
def detect_anomalies():
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)


class RangeError:
    """The verdict of one ``checked_sigmoid_range`` call: ``ok`` is a 0-d
    bool tensor on the output's device; ``throw()`` reads it (the only sync)
    and raises ``ValueError`` if the output left [0, 1]."""

    def __init__(self, ok: torch.Tensor):
        self.ok = ok

    def throw(self) -> None:
        if not bool(self.ok):
            raise ValueError("model output escaped [0,1] — sigmoid missing?")


def checked_sigmoid_range(fn):
    """Wrap ``fn`` so that it returns ``(err, out)``, ``err`` a
    ``RangeError`` on whether every value of ``out`` is in [0, 1] (NaN is
    not); call ``err.throw()`` to surface a violation."""
    def inner(*args, **kwargs):
        out = fn(*args, **kwargs)
        out_t = torch.as_tensor(out)
        return RangeError(((out_t >= 0) & (out_t <= 1)).all()), out

    return inner


def _leaves(tree, path=""):
    """(keystr path, leaf) pairs in ``jax.tree_util`` order: a dict by
    sorted key, an ``OrderedDict`` (a ``state_dict``) in its own order,
    lists and tuples by index; None is an empty node."""
    if isinstance(tree, dict):
        keys = tree.keys() if isinstance(tree, OrderedDict) else sorted(tree)
        for k in keys:
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def find_nonfinite(tree: Any) -> dict[str, dict]:
    """→ {path: {'nan': count, 'inf': count}} for offending leaves only."""
    report = {}
    for path, leaf in _leaves(tree):
        leaf = leaf.detach() if torch.is_tensor(leaf) else torch.as_tensor(np.asarray(leaf))
        if not (leaf.is_floating_point() or leaf.is_complex()):
            continue
        n_nan = int(torch.isnan(leaf).sum())
        n_inf = int(torch.isinf(leaf).sum())
        if n_nan or n_inf:
            report[path] = {"nan": n_nan, "inf": n_inf}
    return report
