"""The port's profiling utilities (``pcss_unet_tpu_torch.utils.profiling``)
against the JAX package's (``tests/test_profiling.py``), on the CPU: the
per-layer latency report has the JAX report's stages, order, block input
shapes (N, H, W, C) and output widths; ``compiled_flops`` counts a matmul
as 2·m·n·k, as XLA's cost analysis does; ``trace`` writes a Chrome
trace with the program's spans."""

import json
import os

import jax.numpy as jnp
import torch

from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.utils import profiling as jprof
from pcss_unet_tpu_torch.models.unet import UNet
from pcss_unet_tpu_torch.utils.profiling import (compiled_flops,
                                                 layer_latency_report, span,
                                                 trace)


def test_layer_latency_report_matches_the_reference(monkeypatch):
    # the reference's structure without its timings or cost analysis (each
    # would compile every block; the full model's variables go unused)
    monkeypatch.setattr(jprof, "_timed", lambda fn, *args, **kw: 1.0)
    monkeypatch.setattr(jprof, "compiled_flops", lambda fn, *args: None)
    jmodel = JUNet(encoder_widths=(8, 16), dtype=jnp.float32, dropout_rate=0.0)
    want = jprof.layer_latency_report(jmodel, {}, input_shape=(1, 32, 32, 4))
    model = UNet(encoder_widths=(8, 16), dropout_rate=0.0).eval()
    got = layer_latency_report(model, model.state_dict(), input_shape=(1, 32, 32, 4))
    assert [r["stage"] for r in got] == [r["stage"] for r in want]
    assert [r["stage"] for r in got] == ["enc_0", "enc_1", "dec_0", "dec_final",
                                         "full_model"]
    for g, w in zip(got[:-1], want[:-1]):
        assert tuple(g["shape"]) == tuple(w["shape"]) and g["out_ch"] == w["out_ch"]
    assert all(r["seconds"] > 0 for r in got)
    assert got[-1]["flops"] > 0 and got[-1]["tf32"] is False


def test_compiled_flops_counts_a_matmul():
    got = compiled_flops(lambda a, b: a @ b, torch.ones(64, 64), torch.ones(64, 64))
    assert got == 2 * 64 ** 3
    want = jprof.compiled_flops(lambda a, b: a @ b, jnp.ones((64, 64)), jnp.ones((64, 64)))
    if want is not None and want == want:        # backend-optional, NaN if absent
        assert got == want
    assert compiled_flops(torch.tanh, torch.ones(4)) is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        with span("unet.head"):         # the program's spans are on inside
            torch.tanh(torch.ones(8)) @ torch.ones(8)
    assert span("unet.head") is span("step")        # and off again after
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("tanh" in e.get("name", "") for e in events)
    assert any(e.get("name") == "pcss.unet.head" for e in events)
