"""The port's sanitizer and graph utilities (``pcss_unet_tpu_torch.utils.
nan_debug`` and ``visualize``) against the JAX package's, on the CPU, as
``tests/test_utils.py`` holds those: ``find_nonfinite`` names and counts
the same leaves as JAX's on the same tree; ``checked_sigmoid_range``
passes and throws; ``detect_anomalies`` restores its state; the graph of
``tanh(x) @ x.T`` as text and as DOT, with the reference's DOT layout."""

from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcss_unet_tpu.utils import nan_debug as jnan
from pcss_unet_tpu.utils import visualize as jvis
from pcss_unet_tpu_torch.utils.nan_debug import (checked_sigmoid_range,
                                                 detect_anomalies,
                                                 find_nonfinite)
from pcss_unet_tpu_torch.utils.visualize import (device_ops_text, graph_dot,
                                                 graph_text)

BAD = np.asarray([1.0, np.nan, np.inf, -np.inf], np.float32)


def _tree(as_leaf):
    """A nested tree with offending leaves at several depths and kinds of
    node; ``as_leaf`` makes each leaf a tensor or a JAX array."""
    return {"good": as_leaf(np.ones(4, np.float32)), "bad": as_leaf(BAD),
            "z": {"b": [as_leaf(np.ones(2, np.float32)), as_leaf(BAD[1:2])],
                  "a": (as_leaf(BAD[2:]),), "none": None},
            "state": OrderedDict([("w.weight", as_leaf(BAD[:2])),
                                  ("a.bias", as_leaf(np.zeros(3, np.float32)))])}


def test_find_nonfinite_matches_the_reference():
    got = find_nonfinite(_tree(torch.from_numpy))
    want = jnan.find_nonfinite(_tree(jnp.asarray))
    assert got == want
    assert list(got) == list(want)
    assert got["['bad']"] == {"nan": 1, "inf": 2}


def test_find_nonfinite_takes_a_state_dict():
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.bias[1] = float("nan")
    assert find_nonfinite(model.state_dict()) == {"['bias']": {"nan": 1, "inf": 0}}


def test_checked_sigmoid_range():
    checked = checked_sigmoid_range(lambda x: x)
    err, out = checked(torch.tensor([0.2, 0.8]))
    err.throw()  # no violation
    assert torch.equal(out, torch.tensor([0.2, 0.8]))
    for bad in ([0.2, 1.8], [-0.1, 0.5], [float("nan"), 0.5]):
        err, _ = checked(torch.tensor(bad))
        with pytest.raises(Exception, match="sigmoid"):
            err.throw()


def test_detect_anomalies_restores_its_state():
    assert not torch.is_anomaly_enabled()
    with detect_anomalies():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            x = torch.tensor([-1.0], requires_grad=True)
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()


def _f(x):
    return x.tanh() @ x.T


def test_graph_text_and_dot():
    x = torch.ones((4, 8))
    assert "tanh" in graph_text(_f, x)
    dot = graph_dot(_f, x)
    want = jvis.jaxpr_dot(lambda a: jnp.tanh(a) @ a.T, jnp.ones((4, 8)))
    assert dot.startswith("digraph") and "tanh" in dot
    assert dot.splitlines()[1:3] == want.splitlines()[1:3]      # layout
    # the same nodes and edges; only the ops' names differ
    names = {"numpy_T": "transpose", "matmul": "dot_general",
             "graph_module": "jaxpr"}
    for ours, theirs in names.items():
        dot = dot.replace(ours, theirs)
    assert dot == want
    cut = graph_dot(_f, x, max_nodes=1)
    assert 'truncated [label="... 2 more eqns"' in cut
    assert 'truncated [label="... 2 more eqns"' in jvis.jaxpr_dot(
        lambda a: jnp.tanh(a) @ a.T, jnp.ones((4, 8)), max_nodes=1)


def test_device_ops_text_lists_what_runs():
    ops = device_ops_text(_f, torch.ones((4, 8))).splitlines()
    assert ops[0].startswith("aten::tanh") and any("matmul" in o for o in ops)
