"""Port channels-major engine and InferenceEngine (pcss_unet_tpu_torch/infer)
≡ the JAX package's, on the CPU at float32 with the reference's Pallas
kernels in interpret mode and the port's kernels on their plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcss_unet_tpu.infer import InferenceEngine as JEngine
from pcss_unet_tpu.infer.chw_engine import chw_forward as j_chw_forward
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.models.fold_bn import fold_batchnorm as j_fold
from pcss_unet_tpu_torch.infer import InferenceEngine
from pcss_unet_tpu_torch.infer.chw_engine import chw_forward
from pcss_unet_tpu_torch.ops.kernels import (fused_block_int8_nhwc,
                                             fused_conv_block_chw,
                                             reset_launch_counts)


@functools.lru_cache(maxsize=None)
def _variables(widths, seed=1):
    """(unfolded, folded) numpy variables of a JAX UNet.init; cached, not
    to be modified."""
    model = JUNet(encoder_widths=widths, dtype=jnp.float32, dropout_rate=0.0)
    key = jax.random.PRNGKey(seed)
    # jitted: the same tree as the eager init, a fraction of its time
    v = jax.jit(lambda k: model.init({"params": k, "dropout": k},
                                     jnp.zeros((1, 64, 64, 4)), True))(key)
    v = jax.tree.map(lambda a: np.array(a, np.float32),
                     {"params": v["params"], "batch_stats": v["batch_stats"]})
    return v, jax.tree.map(np.asarray, j_fold(v))


def _run_both(widths, x, **kw):
    _, folded = _variables(widths)
    want = np.asarray(j_chw_forward(folded, jnp.asarray(x), dtype=jnp.float32,
                                    interpret=True, **kw))
    got = chw_forward(folded, torch.from_numpy(x), dtype=torch.float32, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("widths,h,w", [
    ((16, 32), 48, 64),                 # every stage on K2
    ((16, 32, 128, 256), 64, 160),      # the w16 structure: K2 + wide stages
])
def test_chw_forward_matches_jax(rng, widths, h, w):
    """float32, rtol/atol 2e-4 (the reference's chw-vs-plain tolerance)."""
    x = rng.standard_normal((1, h, w, 4)).astype(np.float32)
    got, want = _run_both(widths, x)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_chw_forward_int8_matches_jax(rng):
    """int8 on the w16 structure (dec_0 256→128 takes K3).  Both sides
    quantize the same float32 values with the same scales, so the sigmoid
    masks agree to float noise unless a float32 rounding flips an int8
    tie; the bound is 2e-4 (measured below 1e-6 here)."""
    x = rng.standard_normal((1, 64, 160, 4)).astype(np.float32)
    reset_launch_counts()
    got, want = _run_both((16, 32, 128, 256), x, int8=True)
    d = float(np.abs(got - want).max())
    print(f"chw int8 forward: max |d| = {d:.3g}")
    assert d <= 2e-4, d
    # the CPU path runs the plain versions: no kernel launched
    assert fused_block_int8_nhwc.launches == 0


@pytest.mark.parametrize("taps", [
    "loop", "acc_shift", "rowpack",
    {"dec_final": "chunk128", "enc_0": "acc_shift", "*": "stack"},
])
def test_chw_forward_taps(rng, taps):
    x = rng.standard_normal((2, 32, 48, 4)).astype(np.float32)
    got, want = _run_both((16, 32), x, taps=taps)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kw", [dict(wide="einsum"), dict(wide="nhwc"),
                                dict(movers="xla"), dict(use128_chw=False)])
def test_chw_forward_routing_options(rng, kw):
    """Every routing option computes the same function (2e-4)."""
    x = rng.standard_normal((1, 32, 112, 4)).astype(np.float32)
    got, want = _run_both((16, 32, 128, 256), x, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_chw_forward_guards(rng):
    _, folded = _variables((16, 32))
    x = torch.zeros(1, 30, 64, 4)
    with pytest.raises(ValueError, match="divisible"):
        chw_forward(folded, x, dtype=torch.float32)
    x = torch.zeros(1, 32, 64, 4)
    with pytest.raises(ValueError, match="movers"):
        chw_forward(folded, x, movers="nope")
    with pytest.raises(ValueError, match="wide"):
        chw_forward(folded, x, wide="nope")
    with pytest.raises(ValueError, match="tap strategy"):
        chw_forward(folded, x, dtype=torch.float32, taps="nope")


def test_unported_stages_raise(rng):
    """The stages that raised before K5 and K6 were ported now run them and
    match the reference (2e-4, as test_chw_forward_int8_matches_jax): the
    128-channel NHWC kernel (use128_chw=False, wide='nhwc', dec_0 128 → 64)
    and the k-chunked int8 kernel (dec_0 1024 → 64)."""
    x = rng.standard_normal((1, 32, 64, 4)).astype(np.float32)
    got, want = _run_both((16, 64, 128), x, use128_chw=False, wide="nhwc")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    x = rng.standard_normal((1, 16, 64, 4)).astype(np.float32)
    got, want = _run_both((64, 1024), x, int8=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _engines(kw_jax, kw_port, widths=(16, 32, 128, 256), seed=7):
    v, _ = _variables(widths, seed)
    jmodel = JUNet(encoder_widths=widths, dtype=jnp.float32, dropout_rate=0.0)
    return (JEngine(jmodel, v, pallas_interpret=True, **kw_jax),
            InferenceEngine(None, v, device="cpu", **kw_port))


def test_engine_chw_int8_matches_jax(rng):
    """Scrub + standardize (K1), fold, chw + int8 forward, clip: the port
    ≡ the reference engine with a NaN and an Inf planted in the frame
    (2e-4, as test_chw_forward_int8_matches_jax)."""
    means = rng.standard_normal(4).astype(np.float32)
    stds = (np.abs(rng.standard_normal(4)) + 0.5).astype(np.float32)
    kw = dict(means=means, stds=stds, fold_bn=True, quantize="int8",
              layout="chw")
    jeng, eng = _engines(dict(dtype=jnp.float32, **kw),
                         dict(dtype=torch.float32, **kw))
    x = rng.standard_normal((1, 60, 150, 4)).astype(np.float32)
    x[0, 3, 5, 2] = np.nan
    x[0, 7, 9, 1] = np.inf
    want, got = jeng(x), eng(x)
    assert got.shape == want.shape == (1, 60, 150, 1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # serving output: uint8 within one code of the reference's
    frames = rng.standard_normal((1, 64, 160, 4)).astype(np.float32)
    u8 = eng.render_u8(torch.from_numpy(frames)).numpy()
    ref = np.asarray(jeng.render_u8(jnp.asarray(frames)))
    assert u8.dtype == np.uint8
    assert np.abs(u8.astype(int) - ref.astype(int)).max() <= 1


def test_engine_nhwc_matches_jax(rng):
    """layout='nhwc' runs the plain module forward on the CPU, folded or
    not (rtol/atol 1e-4)."""
    for fold in (False, True):
        jeng, eng = _engines(dict(dtype=jnp.float32, fold_bn=fold),
                             dict(dtype=torch.float32, fold_bn=fold),
                             widths=(16, 32))
        x = rng.standard_normal((30, 40, 4)).astype(np.float32)
        np.testing.assert_allclose(eng(x), jeng(x), rtol=1e-4, atol=1e-4)


def test_engine_guards():
    v, folded = _variables((16, 32))
    with pytest.raises(ValueError, match="fold_bn"):
        InferenceEngine(None, v, layout="chw", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        InferenceEngine(None, v, layout="nchw", device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        InferenceEngine(None, v, quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        InferenceEngine(None, v, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="batch_norm"):
        InferenceEngine(None, folded, fold_bn=True, device="cpu")


def test_engine_defaults_to_the_card():
    """Built without ``device`` the engine targets CUDA; on a machine with
    no card that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, folded = _variables((16, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(None, folded, layout="chw")


def test_kernel_wrappers_count_no_cpu_launches(rng):
    """On CPU tensors the wrappers run their plain versions and count no
    kernel launch."""
    reset_launch_counts()
    _, folded = _variables((16, 32))
    chw_forward(folded, torch.zeros(1, 32, 64, 4), dtype=torch.float32)
    assert fused_conv_block_chw.launches == 0
