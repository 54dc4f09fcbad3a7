"""The port's export (``pcss_unet_tpu_torch.infer.export``, torch.export)
against the JAX package's (``jax.export``, StableHLO), on the CPU: the
engine of ``tests/test_export.py`` (the (8, 16) float32 net with stats).
A round trip reproduces the engine's plain forward within 1e-6 (the JAX
suite's tolerance); the port's blob matches the JAX blob within 1e-4 (the
port's float32 forward tolerance); the blob loads in a process that never
imports this package; an unaligned shape is refused."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcss_unet_tpu.infer import InferenceEngine as JEngine
from pcss_unet_tpu.infer.export import export_inference as j_export
from pcss_unet_tpu.infer.export import load_exported as j_load
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu_torch.infer import (InferenceEngine, export_inference,
                                       load_exported, save_exported)

MEANS = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
STDS = np.array([1.0, 0.5, 2.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def engines():
    model = JUNet(encoder_widths=(8, 16), dtype=jnp.float32, dropout_rate=0.0)
    key = jax.random.PRNGKey(0)
    # jitted: the same tree as the eager init, a fraction of its time
    v = jax.jit(lambda k: model.init({"params": k, "dropout": k},
                                     jnp.zeros((1, 32, 32, 4)), True))(key)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), dict(v))
    kw = dict(means=MEANS, stds=STDS)
    return (JEngine(model, v, dtype=jnp.float32, **kw),
            InferenceEngine(None, v, dtype=torch.float32, device="cpu", **kw))


def _frames(rng, shape=(1, 32, 48, 4)):
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:3] = [np.nan, np.inf, -np.inf]     # the scrub is in the graph
    return x


def test_export_roundtrip(engines, rng, tmp_path):
    _, engine = engines
    blob = export_inference(engine, 32, 48, batch=1)
    assert len(blob) > 1000
    fn = load_exported(blob)
    x = _frames(rng)
    got = fn(torch.from_numpy(x)).numpy()
    ref = engine.run_padded(x, plain=True).numpy()
    assert got.shape == (1, 32, 48, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # file round trip
    path = str(tmp_path / "model.pt2")
    n = save_exported(engine, path, 32, 48)
    with open(path, "rb") as f:
        data = f.read()
    assert n == len(data)
    np.testing.assert_allclose(load_exported(data)(torch.from_numpy(x)).numpy(),
                               got, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("batch", [1, 2])
def test_export_matches_jax_export(engines, rng, batch):
    jengine, engine = engines
    x = _frames(rng, (batch, 32, 48, 4))
    want = np.asarray(j_load(j_export(jengine, 32, 48, batch=batch,
                                      platforms=("cpu",)))(jnp.asarray(x)))
    got = load_exported(export_inference(engine, 32, 48, batch=batch))(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_plain_run_matches_jax_plain(engines, rng):
    """``run_padded(plain=True)`` is the JAX engine's plain graph."""
    jengine, engine = engines
    x = _frames(rng)
    want = np.asarray(jengine.run_padded(jnp.asarray(x), plain=True))
    np.testing.assert_allclose(engine.run_padded(x, plain=True).numpy(), want,
                               rtol=1e-4, atol=1e-4)


def test_export_loads_without_the_package(engines, rng, tmp_path):
    """A process that imports torch alone loads and runs the blob; its
    ``sys.modules`` never holds ``pcss_unet_tpu_torch``."""
    _, engine = engines
    path = tmp_path / "model.pt2"
    save_exported(engine, str(path), 32, 48)
    x = _frames(rng)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        f"ep = torch.export.load({str(path)!r})\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))\n"
        "with torch.no_grad():\n"
        "    out = ep.module()(x)\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "bad = [m for m in sys.modules if m.startswith(('pcss_unet_tpu', 'jax'))]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                   check=True, timeout=300)
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"),
                               engine.run_padded(x, plain=True).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw", [(30, 48), (32, 40)])
def test_export_rejects_unaligned(engines, hw):
    _, engine = engines
    with pytest.raises(ValueError, match="aligned"):
        export_inference(engine, *hw)


def test_plain_graph_reaches_no_kernel(engines, rng, monkeypatch):
    """The plain graph of a deployment engine (fold_bn, int8, either
    layout) calls no kernel wrapper: each is replaced by one that raises."""
    from pcss_unet_tpu_torch.infer import chw_engine, frame
    from pcss_unet_tpu_torch.models import unet as unet_mod
    from pcss_unet_tpu_torch.ops.kernels import deploy

    jengine, _ = engines
    v = {"params": jax.tree.map(np.asarray, jengine.params),
         "batch_stats": jax.tree.map(np.asarray, jengine.batch_stats)}
    x = _frames(rng)
    for layout in ("nhwc", "chw"):
        engine = InferenceEngine(None, v, dtype=torch.float32, device="cpu",
                                 fold_bn=True, quantize="int8", layout=layout,
                                 means=MEANS, stds=STDS)
        want = engine.run_padded(x, plain=True)

        def boom(*a, **k):
            raise AssertionError("a kernel wrapper was called")
        for mod, name in ((frame, "fused_scrub_standardize"),
                          (frame, "fused_mask_to_u8"),
                          (chw_engine, "fused_conv_block_chw"),
                          (unet_mod, "fused_conv_block_nhwc"),
                          (deploy, "fused_block_int8_nhwc"),
                          (deploy, "fused_block_int8_kchunked"),
                          (deploy, "fused_block128_nhwc")):
            monkeypatch.setattr(mod, name, boom)
        got = engine.run_padded(x, plain=True)
        blob = export_inference(engine, 32, 48)
        monkeypatch.undo()
        assert torch.equal(got, want)
        np.testing.assert_allclose(load_exported(blob)(torch.from_numpy(x)).numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-6)
