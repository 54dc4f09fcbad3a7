"""The port's model options ≡ the JAX package's, on the CPU at float32:
each activation, normalization and dilation, the 3/4/5/7-level depth study
through ``unet_from_config``, multi-light input and multi-output heads
(the cases of ``tests/test_model_variants.py``), against
``pcss_unet_tpu/models/unet.py`` at rtol/atol 1e-4 (the port's float32
forward tolerance).  Variables come from seeded numpy in the JAX layout,
with norms and biases away from the identity, so that they do real work.
Also: the deployment gates refuse non-LeakyReLU and dilated blocks, as the
reference's do; and the options reach the models behind ``infer`` and
``validate``, whose outputs match the JAX CLIs' on the same config."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcss_unet_tpu.config import Config as JConfig
from pcss_unet_tpu.models import UNet as JUNet
from pcss_unet_tpu.models import unet_from_config as j_unet_from_config
from pcss_unet_tpu_torch.config import Config
from pcss_unet_tpu_torch.models.unet import (UNet, unet_for_variables,
                                             unet_from_config)


def _variables(widths, normalization="batch_norm", in_ch=4, out_ch=1, seed=0):
    """A variables tree in the JAX layout (HWIO kernels, the reference's
    block names) from seeded numpy: He-scaled kernels, small biases, norm
    scales and biases away from (1, 0), BatchNorm statistics away from
    (0, 1); no norms for 'none', no statistics for the group norms."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}

    def conv(k, cin, cout):
        return {"kernel": (rng.standard_normal((k, k, cin, cout))
                           * np.sqrt(2.0 / (k * k * cin))).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32)}

    def block(name, cin, features):
        params[name] = {"conv_a": conv(3, cin, cin), "conv_b": conv(1, cin, features)}
        if normalization == "none":
            return
        for norm, c in (("norm_a", cin), ("norm_b", features)):
            params[name][norm] = {
                "scale": (rng.random(c) + 0.5).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
            if normalization == "batch_norm":
                stats.setdefault(name, {})[norm] = {
                    "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "var": (rng.random(c) + 0.5).astype(np.float32)}

    prev = in_ch * 4
    for i, width in enumerate(widths):
        block(f"enc_{i}", prev, width)
        prev = width
    for i, width in enumerate(reversed(widths[:-1])):
        block(f"dec_{i}", prev, width)
        prev = width
    block("dec_final", prev, in_ch * 4)
    params["head"] = conv(1, in_ch * 4, out_ch * 4)
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def _check(jmodel, model_opts, hw, rng, in_ch=4, widths=None, cfg=None):
    """The JAX model's eval forward against the port's on the same
    variables and input (rtol/atol 1e-4)."""
    x = rng.standard_normal((1, *hw, in_ch)).astype(np.float32)
    v = _variables(tuple(jmodel.encoder_widths), jmodel.normalization, in_ch,
                   jmodel.out_ch)
    want = np.asarray(jmodel.apply(v, jnp.asarray(x), False))
    if cfg is not None:
        model = unet_for_variables(cfg, v, device="cpu")
    else:
        model = unet_for_variables(v, device="cpu", **model_opts)
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    return model


@pytest.mark.parametrize("depth", [3, 4, 5, 7])
def test_depth_variants_match_jax(depth, rng):
    """``unet_from_config`` builds the depth study's widths, and the CLI
    form ``unet_for_variables(cfg, variables)`` matches the JAX net at its
    minimum size (the unshuffle plus depth − 1 pools)."""
    kw = dict(model_depth=depth, base_width=8, compute_dtype="float32")
    jmodel = j_unet_from_config(JConfig(**kw))
    model = unet_from_config(Config(**kw), device="cpu")
    assert model.encoder_widths == tuple(jmodel.encoder_widths)
    assert model.dtype == torch.float32
    hw = 2 ** (depth + 1)
    got = _check(jmodel, {}, (hw, hw), rng, cfg=Config(**kw))
    assert len(got.encoder_widths) == depth


def test_unsupported_depth_raises():
    with pytest.raises(ValueError, match="model_depth"):
        unet_from_config(Config(model_depth=6), device="cpu")


@pytest.mark.parametrize("norm", ["batch_norm", "instance_norm", "group_norm",
                                  "none"])
def test_normalization_variants_match_jax(norm, rng):
    jmodel = JUNet(encoder_widths=(16, 32), normalization=norm,
                   dtype=jnp.float32, dropout_rate=0.0)
    model = _check(jmodel, {"normalization": norm}, (32, 32), rng)
    assert model.normalization == norm


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "gelu"])
def test_activation_variants_match_jax(act, rng):
    jmodel = JUNet(encoder_widths=(8, 16), activation=act, dtype=jnp.float32,
                   dropout_rate=0.0)
    _check(jmodel, {"activation": act}, (32, 32), rng)


@pytest.mark.parametrize("act", ["leaky_relu", "gelu"])
def test_dilation_matches_jax(act, rng):
    """``apply_dilation`` dilates encoder level i's 3×3 by 2^i and not the
    bottleneck's, as the reference does."""
    jmodel = JUNet(encoder_widths=(8, 16, 32), apply_dilation=True,
                   activation=act, dtype=jnp.float32, dropout_rate=0.0)
    model = _check(jmodel, {"apply_dilation": True, "activation": act},
                   (64, 64), rng)
    assert [model.get_submodule(f"enc_{i}").conv_a.dilation[0]
            for i in range(3)] == [1, 2, 1]


@pytest.mark.parametrize("in_ch,out_ch,hw", [(8, 1, (64, 128)), (4, 3, (32, 32))],
                         ids=["multilight", "multi_output"])
def test_channel_variants_match_jax(in_ch, out_ch, hw, rng):
    jmodel = JUNet(in_ch=in_ch, out_ch=out_ch, encoder_widths=(8, 16),
                   dtype=jnp.float32, dropout_rate=0.0)
    model = _check(jmodel, {}, hw, rng, in_ch=in_ch)
    assert (model.in_ch, model.out_ch) == (in_ch, out_ch)


@pytest.mark.parametrize("opts", [{"activation": "relu"}, {"activation": "gelu"},
                                  {"apply_dilation": True}, {}],
                         ids=["relu", "gelu", "dilated", "leaky"])
def test_deployment_gates(opts, rng):
    """On a folded net with both deployment switches on, only a LeakyReLU
    net without dilation routes blocks to a kernel (K2′ for the ≤64-channel
    inputs; at 32×32 no int8 kernel's band fits); the others run every
    block on plain convolutions.  Each matches the JAX net with the same
    switches, its Pallas kernels interpreted (its gates refuse the same
    blocks)."""
    widths = (16, 32, 256, 512)
    jmodel = JUNet(encoder_widths=widths, normalization="none",
                   dtype=jnp.float32, dropout_rate=0.0, **opts)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    v = _variables(widths, "none")
    want = np.asarray(jmodel.clone(fused_inference=True, int8_inference=True,
                                   pallas_interpret=True).apply(
        v, jnp.asarray(x), False))
    model = unet_for_variables(v, device="cpu", fused_inference=True,
                               int8_inference=True, **opts)
    got = model(torch.from_numpy(x)).detach().numpy()
    routes = set(model.routes().values())
    assert routes == ({"plain"} if opts else {"plain", "fused_conv_block_nhwc"})
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_group_norm_needs_whole_groups():
    with pytest.raises(ValueError, match="group size"):
        UNet(encoder_widths=(8, 16), normalization="group_norm")


def test_missing_norm_parameters_raise(rng):
    """A folded tree cannot build a group_norm net's norms: folded trees
    build 'none'; a tree without one norm's parameters raises."""
    jmodel = JUNet(encoder_widths=(16, 32), normalization="group_norm",
                   dtype=jnp.float32)
    v = _variables(tuple(jmodel.encoder_widths), "group_norm")
    del v["params"]["dec_0"]["norm_b"]
    with pytest.raises(ValueError, match="lack"):
        unet_for_variables(v, device="cpu", normalization="group_norm")


HERE = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(HERE, "golden", "deploy_w16.npz")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """An EXR frame and a train_stats.npy from deploy_w16's statistics."""
    from pcss_unet_tpu_torch.io.exr import write_exr

    root = tmp_path_factory.mktemp("variants_cli")
    with open(os.path.join(HERE, "golden", "deploy_w16.json")) as f:
        meta = json.load(f)
    np.save(root / "train_stats.npy",
            {"means": meta["means"], "stds": meta["stds"]}, allow_pickle=True)
    x = np.random.default_rng(11).random((64, 96, 4)).astype(np.float32)
    write_exr(str(root / "frame.exr"), {c: x[..., i] for i, c in enumerate("RGBA")})
    return root


def _cli(package, argv, monkeypatch):
    """``python -m <package> <argv>`` in process."""
    import importlib

    mod = importlib.import_module(f"{package}.__main__")
    monkeypatch.setenv("PCSS_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    return mod.main()


@pytest.mark.parametrize("ini", ["normalization=group_norm",
                                 "normalization=instance_norm",
                                 "apply_dilation=true",
                                 "activation=relu\napply_dilation=true"],
                         ids=["group_norm", "instance_norm", "dilation",
                              "relu_dilation"])
def test_infer_cli_options_match_jax_cli(work, monkeypatch, ini):
    """The config's model options reach the engine through ``infer`` as
    through the JAX CLI (deploy_w16's BatchNorm statistics go unused under
    a group norm, as in flax): PNG codes within one."""
    path = work / "opts.ini"
    path.write_text(f"[base]\n{ini}\n")
    common = ["infer", "--input", str(work / "frame.exr"), "--weights", WEIGHTS,
              "--stats_dir", str(work), "--dtype", "float32", "--config", str(path)]
    _cli("pcss_unet_tpu_torch", [*common, "--output", str(work / "o.png"),
                                 "--device", "cpu"], monkeypatch)
    _cli("pcss_unet_tpu", [*common, "--output", str(work / "oj.png")], monkeypatch)
    got = np.asarray(Image.open(work / "o.png")).astype(int)
    want = np.asarray(Image.open(work / "oj.png")).astype(int)
    assert np.abs(got - want).max() <= 1
    assert got.min() < got.max()


@pytest.mark.parametrize("extra", [[], ["--fold_bn"]], ids=["plain", "fold_bn"])
def test_validate_cli_with_gelu_matches_jax_cli(work, monkeypatch, capsys, extra):
    """``validate`` builds both pathways with the config's activation: a
    gelu net is as consistent as in the JAX CLI (same verdict, MSE within
    1e-6)."""
    ini = work / "gelu.ini"
    ini.write_text("[base]\nactivation=gelu\n")
    common = ["validate", "--weights", WEIGHTS, "--input", str(work / "frame.exr"),
              "--stats_dir", str(work), "--config", str(ini), *extra]
    res = _cli("pcss_unet_tpu_torch", [*common, "--output_dir", str(work / "pv"),
                                       "--device", "cpu"], monkeypatch)
    capsys.readouterr()
    _cli("pcss_unet_tpu", [*common, "--output_dir", str(work / "jv")], monkeypatch)
    out = capsys.readouterr().out
    verdict = [ln for ln in out.splitlines() if ln.startswith("verdict")][0]
    mse = float([ln for ln in out.splitlines() if ln.startswith("MSE")][0].split("=")[1])
    assert res["verdict"] == verdict.split(":")[1].strip().lower()
    assert res["verdict"] in ("exact", "pass")
    assert abs(res["mse"] - mse) <= 1e-6


def test_channels_major_layout_refuses_what_it_does_not_compute():
    """The channels-major engine computes LeakyReLU blocks without dilation
    only; it refuses a gelu or dilated model instead of ignoring it."""
    from pcss_unet_tpu_torch.infer import InferenceEngine, load_variables

    v = load_variables(WEIGHTS)
    for opts in ({"activation": "gelu"}, {"apply_dilation": True}):
        model = unet_for_variables(v, device="cpu", **opts)
        with pytest.raises(ValueError, match="layout='chw'"):
            InferenceEngine(model, v, fold_bn=True, layout="chw", device="cpu")
        InferenceEngine(model, v, fold_bn=True, layout="nhwc", device="cpu")
