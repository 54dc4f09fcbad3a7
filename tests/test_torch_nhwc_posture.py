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


@pytest.mark.parametrize("cin,cout,hw,int8,fused,route", [
    (256, 128, (8, 16), True, False, "fused_block_int8_nhwc"),
    (1024, 64, (8, 16), True, False, "fused_block_int8_kchunked"),
    (128, 64, (16, 32), False, True, "fused_block128_nhwc"),
    (256, 32, (8, 16), True, True, None),      # Cout % 64: no pick fits
])
def test_block_kernel_nhwc_routes(rng, cin, cout, hw, int8, fused, route):
    """The deployment dispatch of both forwards: the route ``deploy.route``
    picks, and ``deploy.block_nhwc``'s output on it equal (exactly: the same
    operands, the same plain versions on the CPU) to the wrapper called on
    operands packed by the reference's host-side ``pack_block_int8_params``
    / ``pack_block128_params``."""
    from pcss_unet_tpu_torch.ops.kernels import block_int8 as kb8
    from pcss_unet_tpu_torch.ops.kernels import convblock128 as kc128
    from pcss_unet_tpu_torch.ops.kernels import deploy

    name = deploy.route(cin, cout, *hw, int8=int8, fused=fused)
    assert name == route
    if route is None:
        return
    p = {"conv_a": {"kernel": 0.05 * rng.standard_normal((3, 3, cin, cin)),
                    "bias": 0.1 * rng.standard_normal(cin)},
         "conv_b": {"kernel": 0.05 * rng.standard_normal((1, 1, cin, cout)),
                    "bias": 0.1 * rng.standard_normal(cout)}}
    p = {k: {n: v.astype(np.float32) for n, v in d.items()} for k, d in p.items()}
    x = torch.from_numpy(rng.standard_normal((1, *hw, cin)).astype(np.float32))
    t = {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in p.items()}
    got = deploy.block_nhwc(name, x, t["conv_a"]["kernel"], t["conv_a"]["bias"],
                            t["conv_b"]["kernel"], t["conv_b"]["bias"],
                            dtype=torch.float32)
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
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _reference_route(cin, cout, h, w, *, layout, int8, fused=True,
                     use128_chw=True, wide="auto"):
    """The reference's routing of a folded block, from the JAX package's
    own gates and picks: ``ConvBlock.__call__``'s order for the NHWC model,
    ``chw_forward``'s ``any_block`` and ``_block_nhwc_dispatch`` for the
    channels-major engine."""
    from pcss_unet_tpu.infer.chw_engine import _chw_fusable
    from pcss_unet_tpu.models.unet import ConvBlock as JBlock
    from pcss_unet_tpu.ops.pallas.block_int8 import (pick_k_rows_int8,
                                                     pick_kchunked)
    from pcss_unet_tpu.ops.pallas.convblock128 import pick_k_rows_128

    x = jax.ShapeDtypeStruct((1, h, w, cin), jnp.float32)
    block = JBlock(features=cout, normalization="none", int8_inference=int8,
                   fused_inference=fused)
    # the int8 gate as both reference forwards write it
    int8_stage = JBlock(features=cout, normalization="none",
                        int8_inference=True)._int8able(x, False)
    if layout == "chw":
        if _chw_fusable(cin, cout, use128_chw):
            return "fused_conv_block_chw"
        if wide == "einsum" or (wide == "auto" and not (int8 and int8_stage)):
            return None
        int8_gate, gate128 = int8 and int8_stage, cin == 128 and cout <= 128
    else:
        int8_gate = block._int8able(x, False)
        gate128 = block._fusable128(x, False)
    if int8_gate:
        if pick_k_rows_int8(h, w, cin, cout):
            return "fused_block_int8_nhwc"
        if pick_kchunked(h, w, cin, cout):
            return "fused_block_int8_kchunked"
    if gate128 and pick_k_rows_128(h, w, cin, cout):
        return "fused_block128_nhwc"
    if layout == "nhwc" and block._fusable(x, False):
        return "fused_conv_block_nhwc"
    return None


# (cin, cout, h, w) → the route of the NHWC model with both switches on,
# and of the channels-major engine with int8 and its defaults
ROUTE_CASES = [
    ((512, 128, 272, 480), "fused_block_int8_nhwc", "fused_block_int8_nhwc"),
    ((256, 128, 8, 16), "fused_block_int8_nhwc", "fused_block_int8_nhwc"),
    ((1024, 512, 136, 240), "fused_block_int8_kchunked",
     "fused_block_int8_kchunked"),
    ((1024, 64, 8, 16), "fused_block_int8_kchunked", "fused_block_int8_kchunked"),
    ((512, 1024, 68, 120), None, None),        # enc_3's class: not an int8 stage
    ((128, 64, 16, 32), "fused_block128_nhwc", "fused_conv_block_chw"),
    ((128, 128, 544, 960), "fused_block128_nhwc", "fused_conv_block_chw"),
    ((128, 256, 16, 32), None, None),          # 128-in, too wide out
    ((64, 128, 32, 64), "fused_conv_block_nhwc", "fused_conv_block_chw"),
    ((16, 64, 1088, 1920), "fused_conv_block_nhwc", "fused_conv_block_chw"),
    ((64, 256, 32, 64), None, None),           # ≤64-in, too wide out
    ((256, 32, 8, 16), None, None),            # an int8 stage no pick fits
]


@pytest.mark.parametrize("layout", ["nhwc", "chw"])
@pytest.mark.parametrize("shape,nhwc_route,chw_route", ROUTE_CASES)
def test_route_matches_the_reference_gates(shape, nhwc_route, chw_route,
                                           layout):
    """``deploy.route`` ≡ the reference's gates and picks in every posture
    of the layout: the NHWC model's two switches; the engine's ``int8``,
    ``use128_chw`` and ``wide``."""
    from pcss_unet_tpu_torch.ops.kernels.deploy import route

    if layout == "nhwc":
        postures = [dict(int8=i, fused=f) for i in (True, False)
                    for f in (True, False) if i or f]
        assert route(*shape, int8=True) == nhwc_route
    else:
        postures = [dict(int8=i, use128_chw=u, wide=wd) for i in (True, False)
                    for u in (True, False) for wd in ("auto", "einsum", "nhwc")]
        assert route(*shape, layout="chw", int8=True) == chw_route
    for posture in postures:
        assert (route(*shape, layout=layout, **posture)
                == _reference_route(*shape, layout=layout, **posture)), posture


def test_forwards_call_the_wrappers_the_benchmark_patches(rng, monkeypatch):
    """Both inference forwards call each kernel wrapper through the module
    name the benchmark's ``roofline/K*.py::WRAPPERS`` replace: each one,
    replaced by a counting pass-through, is called on every route a net
    takes (K2′, K3, K5 and K6 on the NHWC fused+int8 posture; K2, K3 and
    K5 on the channels-major int8 engine), and the outputs are the
    unpatched run's."""
    import importlib

    widths = (16, 64, 128, 256, 1024)
    v = _variables(widths)
    x = rng.standard_normal((1, 64, 128, 4)).astype(np.float32)
    pairs = [(m, a) for k in range(1, 7) for m, a in importlib.import_module(
        f"benchmark.roofline.K{k}").WRAPPERS]
    for layout, routes in (
            ("nhwc", {"fused_conv_block_nhwc", "fused_block_int8_nhwc",
                      "fused_block_int8_kchunked", "fused_block128_nhwc"}),
            ("chw", {"fused_conv_block_chw", "fused_block_int8_nhwc",
                     "fused_block_int8_kchunked"})):
        eng = InferenceEngine(None, v, dtype=torch.float32, fold_bn=True,
                              quantize="int8", layout=layout, device="cpu")
        want = eng(x)
        calls = {}
        for modname, attr in pairs:
            fn = getattr(importlib.import_module(modname), attr)

            def counted(*a, fn=fn, attr=attr, **k):
                calls[attr] = calls.get(attr, 0) + 1
                return fn(*a, **k)
            monkeypatch.setattr(importlib.import_module(modname), attr, counted)
        got = eng(x)
        monkeypatch.undo()
        if layout == "nhwc":
            assert set(eng.model.routes().values()) == routes | {"plain"}
        assert routes <= set(calls), (layout, calls)
        np.testing.assert_array_equal(got, want)


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
