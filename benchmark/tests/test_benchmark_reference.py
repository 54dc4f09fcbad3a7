"""The plain reference against the program at a tiny size, and the
comparisons that decide ``correct``: sound runs pass, the control (the
reference one precision lower) and every fault a cell can have fail."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import calibrate, harness, inputs
from benchmark.drivers import render, train
from benchmark.reference import unet as ref
from benchmark.tests.conftest import tiny

RENDER = ("w16-2k.render", "w64-ref.render", "w64-ref.render-b4")


def _render(cell, seed, **kw):
    wl, cfg = tiny(cell)
    return render.run(wl, cfg, seed=seed, seconds=0.2, trace=False, device="cpu",
                      t_start=harness.clock(), **kw)


def _train(seed, **kw):
    wl, cfg = tiny("w64-ref.train")
    return train.run(wl, cfg, seed=seed, seconds=0.2, trace=False, device="cpu",
                     t_start=harness.clock(), **kw)


@pytest.mark.parametrize("layout", ["nhwc", "chw"])
def test_reference_forward_equals_the_programs_float32_forward(layout):
    from pcss_unet_tpu_torch.infer.frame import InferenceEngine

    gen = torch.Generator().manual_seed(3)
    widths = (16, 32, 64, 128)
    weights = inputs.unet_weights(widths, gen, "cpu", style="deploy")
    frames, _ = inputs.gbuffer_frames(2, 32, 64, gen, "cpu")
    means, stds = inputs.channel_stats(frames)
    engine = InferenceEngine(None, inputs.engine_variables(weights, widths), means=means,
                             stds=stds, dtype=torch.float32, fold_bn=True, layout=layout,
                             device="cpu")
    got = engine.run_padded(frames)
    want = ref.mask(weights, frames, means, stds, int8=False, precision="fp32")
    assert float((got - want).abs().max()) < 2e-5


@pytest.mark.parametrize("cell", RENDER)
def test_render_cells_pass_on_sound_runs(cell):
    out = _render(cell, 2 ** 31 + 11)
    assert out["correct"], out["readings"]


def test_train_cell_passes_on_a_sound_run():
    out = _train(2 ** 31 + 12)
    assert out["correct"], out["readings"]


@pytest.mark.parametrize("cell", RENDER)
def test_an_altered_answer_fails(cell):
    out = _render(cell, 2 ** 31 + 13, render_fault=calibrate.altered)
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("fault", [calibrate.unchanged, calibrate.half_batch])
def test_a_faulty_train_step_fails(fault):
    out = _train(2 ** 31 + 14, fault_of=fault)
    assert not out["correct"], out["readings"]


@pytest.mark.parametrize("cell", ["w16-2k.render", "w64-ref.render"])
def test_the_render_control_fails(cell):
    wl, cfg = tiny(cell)
    got = calibrate.render_control(wl, cfg, 2 ** 31 + 15, torch.device("cpu"))
    assert any(got[k] > lim for k, lim in wl["limits"].items()), got


def test_the_train_control_fails():
    wl, cfg = tiny("w64-ref.train")
    got = calibrate.train_control(wl, cfg, 2 ** 31 + 16, torch.device("cpu"))
    assert any(got[k] > lim for k, lim in wl["limits"].items()), got


def test_the_int8_scheme_bands_as_published():
    # the reference's own pickers: K3's band for w64 dec_1, K5's for dec_0
    r = ref.route(512, 128, 272, 480, True)
    assert r[0] == "int8" and r[2] == 512 and r[3]
    r = ref.route(1024, 512, 136, 240, True)
    assert r[0] == "int8" and r[2] in (128, 256) and not r[3]
    assert ref.route(128, 512, 136, 240, True) == ("float",)
    assert ref.route(512, 1024, 68, 120, True) == ("float",)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.linspace(-3, 3, 1001)
    e16 = float((ref.bf16(x) - x).abs().max())
    e8 = float((ref.fp8(x) - x).abs().max())
    assert 0 < e16 < e8
    assert np.isclose(float(ref.fp8(torch.tensor([448.0, 1.0]))[0]), 448.0)
