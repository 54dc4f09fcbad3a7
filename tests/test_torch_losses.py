"""The port's losses (``pcss_unet_tpu_torch.losses``) against the JAX
package's on the same inputs, at the tolerances of ``tests/test_losses.py``
and ``tests/test_ssim.py`` (image-space terms 1e-6 / 1e-5, SSIM 1e-4).  The
perceptual term runs on the JAX package's seeded VGG parameters, carried
across (HWIO → OIHW); the perturbation term on noise drawn by the JAX
package and handed to both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcss_unet_tpu import losses as J
from pcss_unet_tpu.losses.perturbation import perturb_inputs as j_perturb_inputs
from pcss_unet_tpu_torch import losses as P
from pcss_unet_tpu_torch.losses.perturbation import perturb_inputs


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    out = rng.random((2, 32, 32, 1)).astype(np.float32)
    tgt = rng.random((2, 32, 32, 1)).astype(np.float32)
    return out, tgt


@pytest.fixture(scope="module")
def vgg():
    """(JAX PerceptualLoss, port PerceptualLoss) on the same parameters."""
    j = J.PerceptualLoss(None)
    params = jax.tree.map(np.asarray, jax.device_get(j.params))
    return j, P.PerceptualLoss(params=params)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name,tol", [("high_freq_loss", 1e-6),
                                      ("penumbra_weighted_l1", 1e-5),
                                      ("sobel_gradient_loss", 1e-5)])
def test_image_terms_match_jax(imgs, name, tol):
    out, tgt = imgs
    want = float(getattr(J, name)(jnp.asarray(out), jnp.asarray(tgt)))
    got = float(getattr(P, name)(t(out), t(tgt)))
    assert abs(got - want) < tol, (got, want)


def test_sobel_target_side_has_no_gradient(imgs):
    out, tgt = imgs
    tg = t(tgt).requires_grad_(True)
    P.sobel_gradient_loss(t(out).requires_grad_(True), tg).backward()
    assert tg.grad is None or float(tg.grad.abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.random((2, 40, 36, 1)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    want = float(J.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(P.ssim(t(a), t(b)))
    assert abs(got - want) < 1e-4
    assert abs(float(P.ssim_loss(t(a), t(b))) - (1 - want)) < 1e-4


def test_ssim_constant_shift():
    a = torch.full((1, 32, 32, 1), 0.4)
    b = torch.full((1, 32, 32, 1), 0.6)
    c1 = 0.01 ** 2
    expect = (2 * 0.4 * 0.6 + c1) / (0.4 ** 2 + 0.6 ** 2 + c1)
    assert abs(float(P.ssim(a, b)) - expect) < 1e-4


def test_perceptual_matches_jax(vgg, imgs):
    """The VGG tower (taps 2, 7, 12, 21, 30) on the JAX package's seeded
    parameters: the loss agrees to float32 conv noise (rel 1e-4)."""
    j, p = vgg
    out, tgt = imgs
    want = float(j(jnp.asarray(out), jnp.asarray(tgt)))
    got = float(p(t(out), t(tgt)))
    assert want > 0
    assert abs(got - want) <= 1e-4 * want, (got, want)


def test_perceptual_scrubs_like_jax(vgg, imgs):
    j, p = vgg
    out, tgt = imgs
    bad = out.copy()
    bad[0, :3, 0, 0] = [np.nan, np.inf, -np.inf]
    bad[1, 0, :2, 0] = [1.7, -0.3]
    want = float(j(jnp.asarray(bad), jnp.asarray(tgt)))
    got = float(p(t(bad), t(tgt)))
    assert np.isfinite(got) and abs(got - want) <= 1e-4 * want


def test_vgg_gradient_dead_by_default(vgg, imgs):
    """Reference parity: the VGG branch contributes no gradient
    (customLoss.py:69-71, 90) — the towers run under no_grad."""
    _, dead = vgg
    out, tgt = imgs
    o = t(out).requires_grad_(True)
    assert not dead(o, t(tgt)).requires_grad
    live = P.PerceptualLoss(params={k: dict(v) for k, v in
                                    _vgg_params(dead).items()}, grad=True)
    o2 = t(out).requires_grad_(True)
    live(o2, t(tgt)).backward()
    assert float(o2.grad.abs().max()) > 0.0


def _vgg_params(p):
    return {name: {"kernel": m.weight.detach().permute(2, 3, 1, 0).numpy(),
                   "bias": m.bias.detach().numpy()}
            for name, m in p.model.named_children()}


def test_vgg_npz_loads_like_jax(tmp_path, vgg):
    """``load_vgg_params`` reads the JAX package's ``.npz`` layout."""
    from pcss_unet_tpu.models.vgg import load_vgg_params as j_load
    from pcss_unet_tpu_torch.models.vgg import load_vgg_params

    j, _ = vgg
    flat = {}
    for name, leaf in jax.device_get(j.params).items():
        flat[f"{name}_kernel"] = np.asarray(leaf["kernel"])
        flat[f"{name}_bias"] = np.asarray(leaf["bias"])
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **flat)
    got, want = load_vgg_params(path), j_load(path)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k]["kernel"], np.asarray(want[k]["kernel"]))


@pytest.mark.parametrize("loss", ["standard", "ssim"])
def test_standard_loss_matches_jax(vgg, imgs, loss):
    j, p = vgg
    out, tgt = imgs
    w = dict(ssim_weight=0.2, high_freq_weight=0.3, penumbra_weight=0.1,
             sobel_weight=0.05) if loss == "ssim" else {}
    jt, jterms = J.standard_loss(J.LossBundle(perceptual=j, **w),
                                 jnp.asarray(out), jnp.asarray(tgt))
    pt, pterms = P.standard_loss(P.LossBundle(perceptual=p, **w), t(out), t(tgt))
    assert set(pterms) == set(jterms)
    for k in jterms:
        assert abs(float(pterms[k]) - float(jterms[k])) <= 1e-4 * abs(float(jterms[k])) + 1e-6, k
    expect = 0.9 * pterms["l1_loss"] + 0.1 * pterms["vgg_loss"]
    if loss == "standard":
        assert abs(float(pt) - float(expect)) < 1e-6


def test_perturb_inputs_stats(rng):
    x = torch.from_numpy(rng.standard_normal((4, 16, 16, 4)).astype(np.float32)
                         * np.array([1, 2, 3, 4], np.float32))
    p = perturb_inputs(x, count=3, std_factor=0.01,
                       generator=torch.Generator().manual_seed(0))
    assert p.shape == (3, 4, 16, 16, 4)
    noise = (p - x[None]).numpy()
    ch_std = np.std(x.numpy(), axis=(0, 1, 2), ddof=1)
    np.testing.assert_allclose(noise.std(axis=(0, 1, 2, 3)), ch_std * 0.01, rtol=0.15)


@pytest.mark.parametrize("mode", ["channel_std", "fixed_eps"])
def test_perturb_inputs_match_jax_on_shared_noise(mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * 3
    key = jax.random.PRNGKey(5)
    want = np.asarray(j_perturb_inputs(key, jnp.asarray(x), 3, noise_mode=mode))
    noise = np.asarray(jax.random.normal(key, (3, *x.shape), jnp.float32))
    got = perturb_inputs(t(x), 3, noise_mode=mode, noise=t(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["l1", "mse"])
def test_perturbation_loss_matches_jax(imgs, metric):
    """The same noise on both sides (drawn by the JAX package), the same
    model: the drift matches, and only the original output has a
    gradient."""
    out, _ = imgs
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 4)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = float(J.perturbation_loss(
        lambda z: jnp.mean(jax.nn.sigmoid(z), axis=-1, keepdims=True),
        key, jnp.asarray(x), jnp.asarray(out), 3, metric=metric))
    noise = t(np.asarray(jax.random.normal(key, (3, *x.shape), jnp.float32)))
    o = t(out).requires_grad_(True)
    got = P.perturbation_loss(
        lambda z: torch.sigmoid(z).mean(dim=-1, keepdim=True), t(x), o, 3,
        metric=metric, noise=noise)
    assert abs(float(got) - want) < 1e-6
    got.backward()
    assert torch.isfinite(o.grad).all()


def test_enhanced_loss_matches_jax(vgg, imgs):
    j, p = vgg
    out, tgt = imgs
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 4)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jt, jterms = J.enhanced_loss(
        J.LossBundle(perceptual=j), lambda z: jnp.mean(jax.nn.sigmoid(z), axis=-1,
                                                       keepdims=True),
        key, jnp.asarray(x), jnp.asarray(out), jnp.asarray(tgt))
    noise = t(np.asarray(jax.random.normal(key, (3, *x.shape), jnp.float32)))
    bundle = P.LossBundle(perceptual=p)
    fake = lambda z: torch.sigmoid(z).mean(dim=-1, keepdim=True)  # noqa: E731
    pt, pterms = P.enhanced_loss(bundle, fake, t(x), t(out), t(tgt), noise=noise)
    assert set(pterms) == set(jterms) >= {"l1_loss", "vgg_loss",
                                          "perturbation_loss", "total_loss"}
    for k in jterms:
        assert abs(float(pterms[k]) - float(jterms[k])) <= 1e-4 * abs(float(jterms[k])) + 1e-6, k
    expect = (0.9 * pterms["l1_loss"] + 0.1 * pterms["vgg_loss"]
              + 0.1 * pterms["perturbation_loss"])
    assert abs(float(pt) - float(expect)) < 1e-6
    _, terms_eval = P.enhanced_loss(bundle, fake, t(x), t(out), t(tgt),
                                    training=False)
    assert float(terms_eval["perturbation_loss"]) == 0.0


def test_temporal_instability_matches_jax():
    rng = np.random.default_rng(0)
    frames = rng.random((3, 2, 16, 16, 1)).astype(np.float32)
    mv = (rng.standard_normal((2, 2, 16, 16, 2)) * 2).astype(np.float32)
    for motion in (None, mv):
        want = float(J.measure_temporal_instability(
            jnp.asarray(frames), None if motion is None else jnp.asarray(motion), 3.0))
        got = float(P.measure_temporal_instability(
            t(frames), None if motion is None else t(motion), 3.0))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (motion is None, got, want)
    assert float(P.measure_temporal_instability(t(frames[:1]))) == 0.0


def test_perceptual_chunks_match_whole_batch(vgg, imgs, monkeypatch):
    """One image per tower run (``CHUNK_PIXELS``, as at 2048×1024) gives the
    whole batch's loss up to float32 summation order."""
    from pcss_unet_tpu_torch.losses import vgg as pvgg

    _, p = vgg
    out, tgt = imgs
    whole = float(p(t(out), t(tgt)))
    monkeypatch.setattr(pvgg, "CHUNK_PIXELS", 32 * 32)
    assert abs(float(p(t(out), t(tgt))) - whole) <= 1e-6 * whole
