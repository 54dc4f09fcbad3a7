"""The port's NHWC deployment posture, ``InferenceEngine(layout="nhwc",
fold_bn=True, quantize="int8")``, ≡ the JAX package's, on the CPU at
float32: the reference's Pallas kernels in interpret mode, the port's
kernels on their plain versions.  Also the committed deploy_w16 net through
the port's posture, and the seeded variables the w64 runs use."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcss_unet_tpu.infer import InferenceEngine as JEngine
from pcss_unet_tpu.losses.temporal import measure_temporal_instability
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu_torch.infer import InferenceEngine, load_variables
from pcss_unet_tpu_torch.models.fold_bn import fold_batchnorm
from pcss_unet_tpu_torch.models.init import seeded_variables
from pcss_unet_tpu_torch.ops.kernels import KERNELS, reset_launch_counts

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")

# (16, 64, 128, 1024) at 64×128: dec_0 (1024 → 128 at 8×16) takes K5 with
# pick_kchunked (4, 256), dec_1 (128 → 64 at 16×32) K6 with k_rows 8, the
# ≤64-channel stages K2′, enc_3 (128 → 1024) the plain convolutions.
WIDTHS = (16, 64, 128, 1024)
ROUTES_INT8 = {"enc_0": "fused_conv_block_nhwc", "enc_1": "fused_conv_block_nhwc",
               "enc_2": "fused_conv_block_nhwc", "enc_3": "plain",
               "dec_0": "fused_block_int8_kchunked", "dec_1": "fused_block128_nhwc",
               "dec_2": "fused_conv_block_nhwc", "dec_final": "fused_conv_block_nhwc"}


@functools.lru_cache(maxsize=None)
def _variables(widths, seed=5):
    return seeded_variables(widths, seed=seed)


def _engines(quantize, widths=WIDTHS):
    v = _variables(widths)
    stats = dict(means=np.array([0.1, -0.2, 0.3, 0.0], np.float32),
                 stds=np.array([1.5, 0.8, 1.0, 2.0], np.float32))
    jmodel = JUNet(encoder_widths=widths, dtype=jnp.float32, dropout_rate=0.0)
    jeng = JEngine(jmodel, v, dtype=jnp.float32, fold_bn=True,
                   quantize=quantize, pallas_interpret=True, **stats)
    eng = InferenceEngine(None, v, dtype=torch.float32, fold_bn=True,
                          quantize=quantize, device="cpu", **stats)
    return jeng, eng


@pytest.mark.parametrize("quantize,routes", [
    ("int8", ROUTES_INT8),
    ("none", dict(ROUTES_INT8, dec_0="plain")),
])
def test_nhwc_posture_matches_jax(rng, quantize, routes):
    """Whole engine, float32, at the JAX suite's chw tolerance (rtol/atol
    2e-4; measured ≤ 2.4e-6): both sides quantize the same float32 values
    with the same scales, so only float32 sum order differs.  The JAX
    engine runs op by op (``jax.disable_jit``): jitted, XLA rounds the
    standardization's division differently in the last bit (4.8e-7 here),
    which moves one int8 rounding tie and its mask by 2.1e-3 against its own
    op-by-op result on this input (the port's float32 ulps can do the same;
    dynamic int8 scales are not continuous in their inputs)."""
    jeng, eng = _engines(quantize)
    x = rng.standard_normal((1, 64, 128, 4)).astype(np.float32)
    reset_launch_counts()
    with jax.disable_jit():
        want = np.asarray(jeng(x))
    got = eng(x)
    assert eng.model.routes() == routes
    assert got.shape == want.shape == (1, 64, 128, 1)
    d = float(np.abs(got - want).max())
    print(f"nhwc {quantize} engine: max |d| = {d:.3g}")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # the CPU runs the plain versions: no kernel launched
    assert all(k.launches == 0 for k in KERNELS)


def test_nhwc_posture_render_u8(rng):
    """Serving output: uint8 within one code of the reference's jitted
    engine."""
    jeng, eng = _engines("int8")
    frames = rng.standard_normal((1, 64, 128, 4)).astype(np.float32)
    u8 = eng.render_u8(torch.from_numpy(frames)).numpy()
    ref = np.asarray(jeng.render_u8(jnp.asarray(frames)))
    assert u8.dtype == np.uint8 and u8.shape == ref.shape
    assert np.abs(u8.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("cin,cout,hw,int8,block128,route", [
    (256, 128, (8, 16), True, False, "fused_block_int8_nhwc"),
    (1024, 64, (8, 16), True, False, "fused_block_int8_kchunked"),
    (128, 64, (16, 32), False, True, "fused_block128_nhwc"),
    (256, 32, (8, 16), True, True, None),      # Cout % 64: no pick fits
])
def test_block_kernel_nhwc_routes(rng, cin, cout, hw, int8, block128, route):
    """The shared dispatch of both forwards: the route its picks choose, and
    an output equal (exactly: the same operands, the same plain versions on
    the CPU) to the wrapper called on operands packed by the reference's
    host-side ``pack_block_int8_params`` / ``pack_block128_params``."""
    from pcss_unet_tpu_torch.ops.kernels import block_int8 as kb8
    from pcss_unet_tpu_torch.ops.kernels import convblock128 as kc128
    from pcss_unet_tpu_torch.ops.kernels.deploy import block_kernel_nhwc

    p = {"conv_a": {"kernel": 0.05 * rng.standard_normal((3, 3, cin, cin)),
                    "bias": 0.1 * rng.standard_normal(cin)},
         "conv_b": {"kernel": 0.05 * rng.standard_normal((1, 1, cin, cout)),
                    "bias": 0.1 * rng.standard_normal(cout)}}
    p = {k: {n: v.astype(np.float32) for n, v in d.items()} for k, d in p.items()}
    x = torch.from_numpy(rng.standard_normal((1, *hw, cin)).astype(np.float32))
    t = {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in p.items()}
    hit = block_kernel_nhwc(x, t["conv_a"]["kernel"], t["conv_a"]["bias"],
                            t["conv_b"]["kernel"], t["conv_b"]["bias"],
                            dtype=torch.float32, int8=int8, block128=block128)
    if route is None:
        assert hit is None
        return
    assert hit[0] == route
    if route == "fused_block128_nhwc":
        want = kc128.fused_block128_nhwc(
            x, *kc128.pack_block128_params(p, dtype=torch.float32))
    elif route == "fused_block_int8_nhwc":
        k = kb8.pick_k_rows_int8(*hw, cin, cout)
        want = kb8.fused_block_int8_nhwc(x, *kb8.pack_block_int8_params(p),
                                         k_rows=k)
    else:
        k, cc = kb8.pick_kchunked(*hw, cin, cout)
        want = kb8.fused_block_int8_kchunked(
            x, *kb8.pack_block_int8_params(p), k_rows=k, c_chunk=cc)
    torch.testing.assert_close(hit[1], want, rtol=0, atol=0)


# ------------------------------------------------------------ deploy_w16


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(GOLDEN, "deploy_w16.json")) as f:
        meta = json.load(f)
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
    import make_deployment_golden

    engine = InferenceEngine(
        None, load_variables(os.path.join(GOLDEN, "deploy_w16.npz")),
        means=np.asarray(meta["means"], np.float32),
        stds=np.asarray(meta["stds"], np.float32), dtype=torch.float32,
        fold_bn=True, quantize="int8", device="cpu")
    return meta, make_deployment_golden, engine


def test_deploy_w16_nhwc_psnr(golden):
    """The committed net through the NHWC posture reaches the committed
    quality (the JAX suite's 0.5 dB slack), with the reference's routing:
    K2′ on the ≤64-channel stages, K3 on dec_0, plain convolutions on enc_3
    and on dec_1 (K6 needs Cout % 64 == 0)."""
    meta, scripts, engine = golden
    xv, yv = scripts.make_frames(meta["seed_val"], meta["n_val"])
    psnrs = []
    for x, y in zip(xv, yv):
        mse = float(np.mean((engine(x)[..., 0] - y[..., 0]) ** 2))
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-12)))
    assert engine.model.routes() == {
        "enc_0": "fused_conv_block_nhwc", "enc_1": "fused_conv_block_nhwc",
        "enc_2": "fused_conv_block_nhwc", "enc_3": "plain",
        "dec_0": "fused_block_int8_nhwc", "dec_1": "plain",
        "dec_2": "fused_conv_block_nhwc", "dec_final": "fused_conv_block_nhwc"}
    psnr = float(np.mean(psnrs))
    assert psnr >= meta["val_psnr_db"] - 0.5, psnr


def test_deploy_w16_nhwc_temporal_stability(golden):
    """Temporal instability ≤ 1.25 × committed + 1e-4 (the JAX suite's
    gate)."""
    meta, scripts, engine = golden
    seq, motion = scripts.make_sequence(meta["seed_seq"], meta["n_seq"])
    preds = np.stack([engine(f) for f in seq])[:, None]     # [T,1,H,W,1]
    inst = float(measure_temporal_instability(
        jnp.asarray(preds), jnp.asarray(motion[:, None])))
    assert inst <= meta["temporal_instability"] * 1.25 + 1e-4, inst


# ------------------------------------------------------ seeded variables


def test_seeded_variables_match_the_jax_tree():
    """Same names and shapes as the reference's UNet.init tree."""
    widths = (16, 32, 128, 256)
    jmodel = JUNet(encoder_widths=widths, dtype=jnp.float32, dropout_rate=0.0)
    key = jax.random.PRNGKey(0)
    ref = jax.eval_shape(lambda k: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 32, 32, 4)), True), key)
    ref = {"params": ref["params"], "batch_stats": ref["batch_stats"]}
    got = seeded_variables(widths, seed=1)
    assert (jax.tree.map(lambda a: a.shape, ref)
            == jax.tree.map(lambda a: a.shape, got))
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(got))


def test_seeded_variables_deterministic_and_foldable():
    a, b = seeded_variables((16, 32), seed=3), seeded_variables((16, 32), seed=3)
    c = seeded_variables((16, 32), seed=4)
    ka = a["params"]["enc_1"]["conv_a"]["kernel"]
    np.testing.assert_array_equal(ka, b["params"]["enc_1"]["conv_a"]["kernel"])
    assert not np.array_equal(ka, c["params"]["enc_1"]["conv_a"]["kernel"])
    # He-normal: std √(2 / fan_in) within sampling noise (fan_in 9·16)
    assert abs(ka.std() / np.sqrt(2.0 / 144) - 1) < 0.1
    # the BatchNorm statistics are not the identity: folding moves weights
    folded = fold_batchnorm(a)["params"]["enc_1"]["conv_a"]
    assert not np.allclose(folded["kernel"], ka, rtol=1e-2)
    assert np.abs(folded["bias"]).max() > 1e-2
