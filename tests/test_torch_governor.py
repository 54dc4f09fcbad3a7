"""The port's memory governor (``utils/memory.py``, ``train/governor.py``)
against the JAX package's: the analytic functions over a grid of shapes and
budgets, ``param_count``, and the candidate walk with an injected probe in
each case of ``tests/test_governor.py``.  On the CPU the measured probe
returns None, and its step leaves the run's model, buffers and random
state untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcss_unet_tpu.utils.memory as jmem
from pcss_unet_tpu.config import Config as JConfig
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.train.governor import \
    find_accum_steps_compiled as j_walk
from pcss_unet_tpu_torch.config import Config
from pcss_unet_tpu_torch.models.unet import unet_from_config
from pcss_unet_tpu_torch.train.governor import (find_accum_steps_compiled,
                                                probe_step_memory,
                                                run_probe_step)
from pcss_unet_tpu_torch.utils import memory as pmem

MEANS = np.zeros(4, np.float32)
STDS = np.ones(4, np.float32)
SHAPES = [(256, 256), (1088, 1920), (1024, 2048), (512, 512)]
PARAMS = [1_000_000, 15_700_000, 31_042_369]


@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd"])
@pytest.mark.parametrize("hbm", [16 << 30, 32 << 30, 85_520_809_984])
def test_analytic_functions_equal_jax(optimizer, hbm):
    for n in PARAMS:
        for h, w in SHAPES:
            for batch in (1, 2, 8, 16):
                assert pmem.estimate_memory_usage(
                    n, batch, h, w, optimizer=optimizer) == \
                    jmem.estimate_memory_usage(n, batch, h, w,
                                               optimizer=optimizer)
                assert pmem.check_memory(n, batch, h, w, optimizer,
                                         hbm_bytes=hbm) == \
                    jmem.check_memory(n, batch, h, w, optimizer, hbm_bytes=hbm)
                assert pmem.find_accum_steps(n, batch, h, w, optimizer,
                                             hbm_bytes=hbm) == \
                    jmem.find_accum_steps(n, batch, h, w, optimizer,
                                          hbm_bytes=hbm)
            assert pmem.find_optimal_batch_size(n, h, w, optimizer,
                                                hbm_bytes=hbm) == \
                jmem.find_optimal_batch_size(n, h, w, optimizer, hbm_bytes=hbm)


def test_estimator_calibration_pins():
    """tests/test_utils.py's pins hold for the port's copy."""
    small = pmem.estimate_memory_usage(15_700_000, 1, 256, 256)
    big = pmem.estimate_memory_usage(15_700_000, 8, 1024, 2048)
    assert big["activations"] >= small["activations"] * 8 * 4 * 8
    assert pmem.check_memory(15_700_000, 1, 1088, 1920, hbm_bytes=16 << 30)
    assert not pmem.check_memory(15_700_000, 8, 1088, 1920, hbm_bytes=16 << 30)
    b16 = pmem.find_optimal_batch_size(15_700_000, 1088, 1920,
                                       hbm_bytes=16 << 30)
    b32 = pmem.find_optimal_batch_size(15_700_000, 1088, 1920,
                                       hbm_bytes=32 << 30)
    assert 1 <= b16 <= b32 and (b16 & (b16 - 1)) == 0


def test_budget_without_a_card_is_the_default():
    assert pmem.device_memory_stats("cpu") is None
    assert pmem.device_budget("cpu") == pmem.HBM_BYTES_DEFAULT == \
        jmem.HBM_BYTES_DEFAULT
    if not torch.cuda.is_available():
        assert pmem.device_memory_stats() is None
        assert pmem.device_budget() == pmem.HBM_BYTES_DEFAULT


@pytest.mark.parametrize("base_width", [16, 64], ids=["w16", "w64"])
def test_param_count_equals_jax(base_width):
    """The module's parameters (BatchNorm running statistics are buffers)
    count as JAX's ``params`` tree; a flax tree counts the same in both."""
    model = unet_from_config(Config(base_width=base_width), device="cpu")
    widths = tuple(base_width * m for m in (1, 2, 8, 16))
    jmodel = JUNet(encoder_widths=widths, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 32, 32, 4)), True))
    want = jmem.param_count(variables["params"])
    assert pmem.param_count(model) == want
    assert pmem.param_count(dict(model.named_parameters())) == want
    assert pmem.param_count(variables["params"]) == want     # a flax tree
    n_buffers = sum(b.numel() for b in model.buffers())
    assert n_buffers > 0 and pmem.param_count(model.state_dict()) > want


def _walk_both(cfg_kw, batch, probe, **kw):
    """The port's walk and JAX's, each with the same fake probe → their
    answers and the accumulation steps each probed, in order."""
    out = []
    for walk, cfg in ((find_accum_steps_compiled, Config(**cfg_kw)),
                      (j_walk, JConfig(**cfg_kw))):
        calls = []

        def recording(c, *a, **k):
            calls.append(c.grad_accum_steps)
            return probe(c, *a, **k)

        out.append((walk(cfg, None, MEANS, STDS, batch, 64, 64,
                         probe=recording, **kw), calls))
    return out


def _fake_probe(cfg, model, means, stds, batch, h, w):
    # plan shrinks with accumulation: microbatch activations dominate
    mb = batch // cfg.grad_accum_steps
    total = mb * (1 << 30)
    return {"total": total, "args": 1 << 28, "temp": total - (1 << 28),
            "out": 0}


@pytest.mark.parametrize("kw,want", [
    # microbatch 8 → 8 GiB·1.15 = 9.2 ≤ 16 → accum 1 fits immediately
    (dict(hbm_bytes=16 << 30, reserve_bytes=0), (1, [1])),
    # budget 4 GiB → microbatch must be ≤ 3.47 GiB → accum 4 (mb 2)
    (dict(hbm_bytes=8 << 30, reserve_bytes=4 << 30), (4, [1, 2, 4])),
    # start skips candidates
    (dict(hbm_bytes=8 << 30, start=4), (4, [4])),
    # nothing fits: the last probed, loudly
    (dict(hbm_bytes=1 << 29), (8, [1, 2, 4, 8])),
], ids=["fits_at_1", "cache_reserve", "start", "none_fit"])
def test_walk_picks_what_jax_picks(kw, want):
    (mine, theirs) = _walk_both(dict(grad_accum_steps=0), 8, _fake_probe,
                                safety=1.15, **kw)
    assert mine == theirs == want


def test_walk_handles_probe_failure_and_oom():
    """All probes failing → None (the analytic answer stands); an
    out-of-memory plan (``inf``) does not fit, and the walk goes on."""
    (mine, theirs) = _walk_both(dict(grad_accum_steps=0), 4,
                                lambda *a, **k: None, hbm_bytes=16 << 30)
    assert mine == theirs == (None, [1, 2, 4])

    def oom_then_fit(cfg, *a):
        if cfg.grad_accum_steps == 1:
            return {"total": float("inf"), "args": 0, "temp": float("inf"),
                    "out": 0, "oom": True}
        return _fake_probe(cfg, *a)

    (mine, theirs) = _walk_both(dict(grad_accum_steps=0), 4, oom_then_fit,
                                hbm_bytes=3 << 30)
    assert mine == theirs == (2, [1, 2])
    huge = {"total": 64 << 30, "args": 1 << 30, "temp": 63 << 30, "out": 0}
    (mine, theirs) = _walk_both(dict(grad_accum_steps=0), 4,
                                lambda *a, **k: dict(huge), hbm_bytes=16 << 30)
    assert mine[0] == theirs[0] == 4


def _tiny_model():
    cfg = Config(base_width=4, model_depth=3, num_epochs=4, warmup_epochs=1,
                 dropout_rate=0.2, alpha=0.9, loss_type="perturb",
                 perturbation_count=2, grad_accum_steps=2, seed=3)
    torch.manual_seed(0)
    return cfg, unet_from_config(cfg, device="cpu").train()


def test_cpu_probe_returns_none_and_touches_nothing():
    cfg, model = _tiny_model()
    params = {k: v.clone() for k, v in model.state_dict().items()}
    rng_state = torch.random.get_rng_state()
    np_state = np.random.get_state()[1].copy()
    assert probe_step_memory(cfg, model, MEANS, STDS, 4, 32, 32) is None
    # the probe's step itself, run on the CPU: a real step on a copy
    metrics = run_probe_step(cfg, model, MEANS, STDS, 4, 32, 32)
    assert np.isfinite(float(metrics["total_loss"]))
    assert float(metrics["perturbation_loss"]) >= 0.0
    for k, v in model.state_dict().items():     # parameters and buffers
        assert torch.equal(v, params[k]), k
    assert model.training
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    assert np.array_equal(np.random.get_state()[1], np_state)
    assert all(p.grad is None for p in model.parameters())
